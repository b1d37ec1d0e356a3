"""Cones, ellipsoids and the support-map MPR/GJK fallback in the port
against the JAX package on the CPU: the builder's ``add_shape_cone`` and
``add_shape_ellipsoid`` (mass, inertia, collision radius, candidate pairs
and slots), the four new analytic pair functions, ``make_support``,
``gjk_closest``/``gjk_distance``, ``mpr_contact_support``,
``support_manifold`` and every support-class pair function, every
primitive pair resolving (``tests/test_geometry.py:425``), the MJCF
ellipsoid geom, and the cone resting on a box on the port.

Tolerances: the analytic pair functions 1e-5 in float32 on every row
(float32 transform chains). The support-map MPR and GJK are held in
float64 (the JAX side under ``jax.enable_x64``), at 1e-5, on the rows
where the reference itself is well-conditioned: MPR's portal tests and
the supports of flat faces are sign tests, so in float32 a change of one
unit in the last place of an input moves the reference's own output by
more than 1e-5 in 20-60% of random rows (ties between box corners, the
cone's apex and rim, the refinement's stop test). A row is compared when
the reference moves by less than 1e-7 under sixteen random perturbations
of 1e-9 of its transforms; at least 60% of the rows are. The deepest-k cut
of a pair function is compared as its depths and normal, and its points
where no two of the k + 1 deepest lie within 1e-6 (a tie is the
reference's own coin flip). The builder leaves 1e-6.

JAX runs eagerly here (its jit of the MPR loops takes minutes)."""

import itertools

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.geometry import gjk as t_gjk
from newton_tpu_torch.geometry import mpr as t_mpr
from newton_tpu_torch.geometry import narrow_phase as t_np
from newton_tpu_torch.geometry import support as t_sup
from newton_tpu_torch.geometry.types import GeoType
from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, MODEL_INT_FIELDS

torch.set_num_threads(1)

ATOL = 1e-5
G = GeoType
ANALYTIC = (G.SPHERE, G.BOX, G.CAPSULE, G.CYLINDER, G.CONE, G.ELLIPSOID)
# the pair classes that run through support-map MPR, (lower, higher)
SUPPORT_PAIRS = [(a, b) for a, b in itertools.combinations_with_replacement(
    ANALYTIC, 2) if (int(a), int(b)) not in t_np.PRIMITIVE_FNS
    and (int(b), int(a)) not in t_np.PRIMITIVE_FNS]
NEW_PAIRS = {"plane_cone": (G.PLANE, G.CONE),
             "plane_ellipsoid": (G.PLANE, G.ELLIPSOID),
             "sphere_ellipsoid": (G.SPHERE, G.ELLIPSOID),
             "ellipsoid_ellipsoid": (G.ELLIPSOID, G.ELLIPSOID)}
STRUCTURE = ("shape_type", "shape_body", "candidate_pairs",
             "candidate_pair_slots", "rigid_contact_max", "slot_shape0",
             "slot_shape1")


def _scale(t, rng, n, dtype=np.float32):
    """Scales of n shapes of type t: a sphere's radius thrice; capsule,
    cylinder and cone (radius, half-height, 0); box and ellipsoid three
    half-extents or radii; a plane's zero."""
    s = 0.1 + 0.3 * rng.rand(n, 3)
    if t == G.SPHERE:
        s[:, 1:] = s[:, :1]
    elif t in (G.CAPSULE, G.CYLINDER, G.CONE):
        s[:, 2] = 0.0
    elif t == G.PLANE:
        s[:] = 0.0
    return s.astype(dtype)


def _transforms(rng, n, spread=0.4, dtype=np.float32):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([spread * rng.randn(n, 3), q], 1).astype(dtype)


# ----------------------------------------------------------------------
# builder, inertia, importer
# ----------------------------------------------------------------------
def _shapes_scene(lib, n=1):
    """A cone and an ellipsoid (turned, offset) on free bodies beside a
    box, a sphere and a capsule, above a ground plane; replicated n
    times: every new pair class."""
    w = lib.ModelBuilder()
    cfg = lib.ShapeConfig(density=600.0, mu=0.6)
    shapes = (
        lambda b: w.add_shape_cone(b, radius=0.15, half_height=0.2,
                                   cfg=cfg),
        lambda b: w.add_shape_ellipsoid(
            b, xform=[0.02, 0, 0.01, 0, 0, 0.19509032, 0.98078528],
            rx=0.2, ry=0.14, rz=0.1, cfg=cfg),
        lambda b: w.add_shape_cone(b, radius=0.1, half_height=0.12,
                                   axis="X", cfg=cfg),
        lambda b: w.add_shape_box(b, hx=0.1, hy=0.15, hz=0.1, cfg=cfg),
        lambda b: w.add_shape_sphere(b, radius=0.12, cfg=cfg),
        lambda b: w.add_shape_capsule(b, radius=0.08, half_height=0.1,
                                      cfg=cfg))
    for i, add in enumerate(shapes):
        body = w.add_body(xform=[0.3 * (i % 3), 0.3 * (i // 3),
                                 0.3 + 0.2 * i, 0, 0, 0, 1])
        add(body)
        w.add_joint_free(body)
        w.add_articulation()
    b = lib.ModelBuilder()
    b.replicate(w, n)
    b.add_ground_plane()
    return b


@pytest.mark.parametrize("n", [1, 3])
def test_cone_ellipsoid_builder_leaves_match_jax(n):
    """``add_shape_cone`` (its COM a quarter of the height above the
    base, along x too) and ``add_shape_ellipsoid`` (turned, offset), alone
    and replicated: every float and int leaf, the candidate pairs and the
    slot counts (plane-cone 4, cone-box 4, cone-ellipsoid 1, ...) equal
    the JAX builder's; the collision radius of a cone is r + h, of an
    ellipsoid its largest radius."""
    import newton_tpu as jt
    tm = _shapes_scene(nt, n).finalize("cpu")
    jm = _shapes_scene(jt, n).finalize()
    for name in MODEL_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    for name in MODEL_INT_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for name in STRUCTURE:
        np.testing.assert_array_equal(
            np.asarray(getattr(tm.structure, name)),
            np.asarray(getattr(jm.structure, name)), err_msg=name)
    np.testing.assert_allclose(tm.shape_collision_radius.numpy()[:2],
                               [0.35, 0.2], rtol=1e-6)


@pytest.mark.parametrize("kind", ["cone", "ellipsoid"])
def test_inertia_matches_jax(kind):
    """``compute_cone_inertia`` and ``compute_ellipsoid_inertia`` equal the
    JAX package's (mass, COM, inertia) on seeded sizes."""
    from newton_tpu.geometry import inertia as j_in
    from newton_tpu_torch.geometry import inertia as t_in
    rng = np.random.RandomState(3)
    for _ in range(8):
        rho, a, b, c = 100 + 900 * rng.rand(), *(0.05 + rng.rand(3))
        args = (rho, a, b) if kind == "cone" else (rho, a, b, c)
        fn = f"compute_{kind}_inertia"
        for x, y in zip(getattr(t_in, fn)(*args), getattr(j_in, fn)(*args)):
            np.testing.assert_allclose(x, y, rtol=1e-12, atol=1e-15)


ELLIPSOID_MJCF = """
<mujoco model="eggs">
  <worldbody>
    <geom name="floor" type="plane" size="5 5 1"/>
    <body name="egg" pos="0 0 0.5">
      <freejoint/>
      <geom type="ellipsoid" size="0.2 0.1 0.15" density="500"/>
      <geom type="ellipsoid" size="0.05 0.08 0.04" pos="0.25 0 0"
            euler="0 30 0" mass="0.3"/>
    </body>
  </worldbody>
</mujoco>
"""


def test_ellipsoid_mjcf_matches_jax(tmp_path):
    """MJCF ``type="ellipsoid"`` geoms (size, density, ``mass`` as density
    over the volume 4/3 pi abc, a turned one) import as the JAX
    importer's: every leaf equal."""
    import newton_tpu as jt
    path = tmp_path / "eggs.xml"
    path.write_text(ELLIPSOID_MJCF)
    tb, jb = nt.ModelBuilder(), jt.ModelBuilder()
    tb.add_mjcf(str(path))
    jb.add_mjcf(str(path))
    tm, jm = tb.finalize("cpu"), jb.finalize()
    assert list(tm.structure.shape_type) == [int(G.PLANE),
                                             int(G.ELLIPSOID),
                                             int(G.ELLIPSOID)]
    for name in MODEL_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    for name in STRUCTURE:
        np.testing.assert_array_equal(
            np.asarray(getattr(tm.structure, name)),
            np.asarray(getattr(jm.structure, name)), err_msg=name)


# ----------------------------------------------------------------------
# analytic pairs and dispatch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(NEW_PAIRS))
def test_new_pair_function_matches_jax(name):
    """plane_cone, plane_ellipsoid, sphere_ellipsoid and
    ellipsoid_ellipsoid on 256 seeded random pose pairs and a cone's axis
    along the plane normal (the basis tangent): position, normal and
    depth within 1e-5 of the JAX package's, every row."""
    import jax.numpy as jnp
    from newton_tpu.geometry import narrow_phase as j_np
    t0, t1 = NEW_PAIRS[name]
    rng = np.random.RandomState(sorted(NEW_PAIRS).index(name))
    n = 256
    X0, X1 = _transforms(rng, n), _transforms(rng, n)
    X0[0] = X1[0] = [0, 0, 0, 0, 0, 0, 1]
    X1[0, 2] = 0.3
    s0, s1 = _scale(t0, rng, n), _scale(t1, rng, n)
    ref = [np.asarray(r) for r in getattr(j_np, name)(
        *map(jnp.asarray, (X0, X1, s0, s1)))]
    got = [g.numpy() for g in getattr(t_np, name)(
        *map(torch.as_tensor, (X0, X1, s0, s1)))]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_every_primitive_pair_resolves():
    """tests/test_geometry.py:425 on the port: every pair of the seven
    primitive types resolves to a contact function with the JAX package's
    orientation and slot count; a mesh, convex or heightfield pair gets
    no primitive function (the pipeline's mesh classes take it), as in
    the JAX package."""
    from newton_tpu.geometry import narrow_phase as j_np
    prims = (G.PLANE,) + ANALYTIC
    for t0, t1 in itertools.product(prims, prims):
        if t0 == t1 == G.PLANE:
            continue
        fn, swapped, k = t_np.contact_fn_for(int(t0), int(t1))
        jfn, jswapped, jk = j_np.contact_fn_for(int(t0), int(t1))
        assert fn is not None and (swapped, k) == (jswapped, jk), (t0, t1)
    for t in (G.MESH, G.CONVEX, G.HFIELD):
        got = t_np.contact_fn_for(int(t), int(G.BOX))
        assert got[0] is None and got == j_np.contact_fn_for(int(t),
                                                             int(G.BOX))
    assert len(SUPPORT_PAIRS) == 9


# ----------------------------------------------------------------------
# support maps, GJK, MPR
# ----------------------------------------------------------------------
@pytest.mark.parametrize("t", ANALYTIC, ids=lambda t: t.name.lower())
def test_make_support_matches_jax(t):
    """Each analytic support map and centre equals the JAX package's on
    256 random shapes and unit directions (float32, 1e-5); the mixed map
    of every analytic type present, whose rows select this type, equals
    the per-type map bit for bit."""
    import jax.numpy as jnp
    from newton_tpu.geometry import support as j_sup
    rng = np.random.RandomState(int(t))
    n = 256
    X, s = _transforms(rng, n), _scale(t, rng, n)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = np.asarray(j_sup.make_support(int(t), jnp.asarray(X),
                                        jnp.asarray(s))(jnp.asarray(d)))
    T = torch.as_tensor
    got = t_sup.make_support(int(t), T(X), T(s))(T(d)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        t_sup.support_center(int(t), T(X), T(s)).numpy(),
        np.asarray(j_sup.support_center(int(t), jnp.asarray(X),
                                        jnp.asarray(s))), atol=ATOL, rtol=0)
    types = torch.full((n,), int(t))
    mixed = t_sup.make_support_mixed(types, [int(x) for x in ANALYTIC],
                                     T(X), T(s))(T(d)).numpy()
    np.testing.assert_array_equal(mixed, got)


def _pair_inputs(t0, t1, n, seed):
    rng = np.random.RandomState(seed)
    return (_transforms(rng, n, dtype=np.float64),
            _transforms(rng, n, dtype=np.float64),
            _scale(t0, rng, n, np.float64), _scale(t1, rng, n, np.float64))


def _jax_stable(fn, X0, X1, s0, s1, seed, reps=16, eps=1e-9, tol=1e-7):
    """The JAX function's outputs on the inputs, and which rows move by
    less than ``tol`` under ``reps`` random perturbations of ``eps`` of
    the transforms: all in one eager float64 call."""
    import jax
    import jax.numpy as jnp
    rng = np.random.RandomState(seed + 1000)
    n = len(X0)
    A = np.concatenate([X0] + [X0 + eps * rng.randn(*X0.shape)
                               for _ in range(reps)])
    B = np.concatenate([X1] + [X1 + eps * rng.randn(*X1.shape)
                               for _ in range(reps)])
    S0, S1 = np.concatenate([s0] * (reps + 1)), np.concatenate(
        [s1] * (reps + 1))
    with jax.enable_x64():
        out = [np.asarray(o) for o in fn(*map(jnp.asarray, (A, B, S0, S1)))]
    assert out[0].dtype in (np.float64, bool)
    stable = np.ones(n, bool)
    for o in out:
        o = o.astype(np.float64).reshape(reps + 1, n, -1)
        stable &= (np.abs(o[1:] - o[:1]) < tol).all((0, 2))
    return [o[:n] for o in out], stable


def _support_fns(lib, t0, t1):
    """``(X0, X1, s0, s1) -> support_manifold(...)`` of library ``lib``
    (the JAX package's or the port's geometry modules)."""
    sup, mpr = lib

    def fn(X0, X1, s0, s1):
        return mpr.support_manifold(
            sup.make_support(int(t0), X0, s0), sup.make_support(int(t1), X1,
                                                                 s1),
            sup.support_center(int(t0), X0, s0),
            sup.support_center(int(t1), X1, s1))
    return fn


@pytest.mark.parametrize("pair", SUPPORT_PAIRS,
                         ids=lambda p: f"{p[0].name}-{p[1].name}".lower())
def test_support_manifold_matches_jax(pair):
    """``support_manifold`` (MPR, the GJK fallback for separated pairs,
    the four tilted probes and the duplicate mask) of each support class
    on 256 random pose pairs, float64: points, normals and depths within
    1e-5 of the JAX package's on the reference's well-conditioned rows
    (at least 60% of them), a quarter or more of them in contact."""
    from newton_tpu.geometry import mpr as j_mpr
    from newton_tpu.geometry import support as j_sup
    t0, t1 = pair
    seed = SUPPORT_PAIRS.index(pair)
    X0, X1, s0, s1 = _pair_inputs(t0, t1, 256, seed)
    ref, stable = _jax_stable(_support_fns((j_sup, j_mpr), t0, t1),
                              X0, X1, s0, s1, seed)
    got = [g.numpy() for g in _support_fns((t_sup, t_mpr), t0, t1)(
        *map(torch.as_tensor, (X0, X1, s0, s1)))]
    assert stable.mean() >= 0.6, stable.mean()
    assert (ref[2][stable] > -0.01).any(-1).mean() > 0.05
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a[stable], b[stable], atol=ATOL, rtol=0)


@pytest.mark.parametrize("pair", SUPPORT_PAIRS,
                         ids=lambda p: f"{p[0].name}-{p[1].name}".lower())
def test_support_pair_function_matches_jax(pair):
    """Each support class's pair function (the manifold cut to its slots,
    deepest first, ties to the lower index) against the JAX package's on
    256 random pose pairs, float64, on the reference's well-conditioned
    rows: depths and normals within 1e-5; points where no two of the
    manifold's k + 1 deepest lie within 1e-6 (the cut and the order
    untied)."""
    from newton_tpu.geometry import mpr as j_mpr
    from newton_tpu.geometry import narrow_phase as j_np
    from newton_tpu.geometry import support as j_sup
    t0, t1 = pair
    seed = 50 + SUPPORT_PAIRS.index(pair)
    X0, X1, s0, s1 = _pair_inputs(t0, t1, 256, seed)
    jfn, swapped, k = j_np.contact_fn_for(int(t0), int(t1))
    fn, tswapped, tk = t_np.contact_fn_for(int(t0), int(t1))
    assert (swapped, k) == (tswapped, tk) == (False, k)
    ref, stable = _jax_stable(jfn, X0, X1, s0, s1, seed)
    man, _ = _jax_stable(_support_fns((j_sup, j_mpr), t0, t1), X0, X1, s0,
                         s1, seed, reps=0)
    got = [g.numpy() for g in fn(*map(torch.as_tensor, (X0, X1, s0, s1)))]
    assert got[0].shape == ref[0].shape == (256, k, 3)
    assert stable.mean() >= 0.6, stable.mean()
    d = -np.sort(-man[2], -1)[:, :k + 1]       # the k + 1 deepest
    untied = stable & (d[:, :-1] - d[:, 1:] > 1e-6).all(-1)
    assert untied.mean() > 0.15
    np.testing.assert_allclose(got[2][stable], ref[2][stable], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got[1][stable], ref[1][stable], atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got[0][untied], ref[0][untied], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("pair", [(G.BOX, G.CONE), (G.CAPSULE, G.ELLIPSOID),
                                  (G.CONE, G.ELLIPSOID)],
                         ids=["box-cone", "capsule-ellipsoid",
                              "cone-ellipsoid"])
def test_mpr_and_gjk_match_jax(pair):
    """``mpr_contact_support`` (hit, depth, normal, point) and
    ``gjk_closest`` (distance, witnesses) on 256 random pose pairs,
    float64, on the reference's well-conditioned rows: within 1e-5; and
    MPR at 0 discovery and 0 refinement iterations (no portal sign test
    taken yet) on the same kind of rows: all but one here, whose
    barycentric point the reference itself moves by 0.02 under a 1e-15
    change of the poses."""
    from newton_tpu.geometry import gjk as j_gjk
    from newton_tpu.geometry import mpr as j_mpr
    from newton_tpu.geometry import support as j_sup
    t0, t1 = pair
    seed = 100 + int(t0) * 16 + int(t1)
    X0, X1, s0, s1 = _pair_inputs(t0, t1, 256, seed)

    def call(lib, fn_name, **kw):
        sup, mod = lib

        def fn(X0, X1, s0, s1):
            return getattr(mod, fn_name)(
                sup.make_support(int(t0), X0, s0),
                sup.make_support(int(t1), X1, s1),
                sup.support_center(int(t0), X0, s0),
                sup.support_center(int(t1), X1, s1), **kw)
        return fn
    T = [torch.as_tensor(x) for x in (X0, X1, s0, s1)]
    for mods, tmods, name, kw, reps in (
            (j_mpr, t_mpr, "mpr_contact_support", {}, 16),
            (j_gjk, t_gjk, "gjk_closest", {}, 16),
            (j_mpr, t_mpr, "mpr_contact_support",
             dict(discover_iters=0, refine_iters=0), 16)):
        ref, stable = _jax_stable(call((j_sup, mods), name, **kw), X0, X1,
                                  s0, s1, seed, reps=reps)
        got = [g.numpy() for g in call((t_sup, tmods), name, **kw)(*T)]
        assert stable.mean() >= 0.6, (name, stable.mean())
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a[stable].astype(np.float64),
                                       b[stable].astype(np.float64),
                                       atol=ATOL, rtol=0, err_msg=name)


def test_hull_gjk_mpr_match_jax():
    """The hull-cloud entry points: ``gjk_distance`` and ``support_point``
    on random 12-vertex clouds, ``mpr_contact`` and ``convex_manifold`` on
    boxes given as their 8 corners, float64, on the reference's
    well-conditioned rows (1e-5); a hull box's manifold against the
    analytic box's support manifold on the same poses (1e-9)."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.geometry import gjk as j_gjk
    from newton_tpu.geometry import mpr as j_mpr
    rng = np.random.RandomState(7)
    n = 128
    Xa, Xb = _transforms(rng, n, dtype=np.float64), _transforms(
        rng, n, dtype=np.float64)
    va = 0.1 + 0.2 * rng.randn(n, 12, 3)
    vb = 0.1 + 0.2 * rng.randn(n, 12, 3)
    d = rng.randn(n, 3)
    T = torch.as_tensor
    with jax.enable_x64():
        J = jnp.asarray
        np.testing.assert_allclose(
            t_gjk.support_point(T(va), T(Xa), T(d)).numpy(),
            np.asarray(j_gjk.support_point(J(va), J(Xa), J(d))), atol=1e-12)
        ref = [np.asarray(x) for x in j_gjk.gjk_distance(J(va), J(Xa),
                                                         J(vb), J(Xb))]
    got = [x.numpy() for x in t_gjk.gjk_distance(T(va), T(Xa), T(vb),
                                                 T(Xb))]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=ATOL)
    signs = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                      for z in (-1, 1)], np.float64)
    ha = signs[None] * _scale(G.BOX, rng, n, np.float64)[:, None]
    hb = signs[None] * _scale(G.BOX, rng, n, np.float64)[:, None]

    def hull(mod, fn_name):
        return lambda X0, X1, s0, s1: getattr(mod, fn_name)(s0, X0, s1, X1)
    for name in ("mpr_contact", "convex_manifold"):
        ref, stable = _jax_stable(hull(j_mpr, name), Xa, Xb, ha, hb, 9)
        got = [x.numpy() for x in getattr(t_mpr, name)(T(ha), T(Xa), T(hb),
                                                       T(Xb))]
        assert stable.mean() >= 0.5, (name, stable.mean())
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a[stable].astype(np.float64),
                                       b[stable].astype(np.float64),
                                       atol=ATOL, err_msg=name)


# ----------------------------------------------------------------------
# the port end to end
# ----------------------------------------------------------------------
def _cone_stack(lib):
    """tests/test_geometry.py:441: a cone (r 0.3, h 0.25) base-down on a
    box (0.5, 0.5, 0.25) on free joints above a ground plane."""
    b = lib.ModelBuilder()
    base = b.add_body(xform=[0, 0, 0.25, 0, 0, 0, 1])
    b.add_shape_box(base, hx=0.5, hy=0.5, hz=0.25)
    b.add_joint_free(base)
    cone = b.add_body(xform=[0, 0, 0.75, 0, 0, 0, 1])
    b.add_shape_cone(cone, radius=0.3, half_height=0.25)
    b.add_joint_free(cone)
    b.add_ground_plane()
    return b


def test_cone_on_box_rests():
    """tests/test_geometry.py:441 on the port: after 90 frames of 4 XPBD
    substeps (iterations 4, dt 1/240) the cone rests on the box through
    the support-map MPR: z = 0.75 +- 0.06, upright (|qx|, |qy| < 0.1)."""
    m = _cone_stack(nt).finalize("cpu")
    pipe = nt.CollisionPipeline(m)
    assert pipe.mode == "static"
    solver = nt.SolverXPBD(m, iterations=4)
    s = m.state()
    for _ in range(90 * 4):
        s = solver.step(s, None, None, pipe.collide(s), 1.0 / 240.0)
    bq = s.body_q.numpy()
    assert np.isfinite(bq).all()
    assert abs(bq[1, 2] - 0.75) < 0.06, bq[1]
    assert abs(bq[1, 3]) < 0.1 and abs(bq[1, 4]) < 0.1


def test_support_classes_collide_matches_jax():
    """The static pipeline on the cone-on-box scene with an ellipsoid and
    a tipped cone on it: the support classes run as one batch (one row's
    types per map), and the Contacts equal the JAX pipeline's slot for
    slot: masks and shape indices exactly; depths, points and normals of
    active slots within 1e-5 where the reference's own values move by
    less than 1e-6 when each body position moves by one unit in the last
    place: every depth, and the points and normals of every slot but the
    face-on-face cone-on-box probes (support ties) and the cone-ellipsoid
    pair (MPR stops refining within its tolerance, which float32 rounding
    decides)."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe

    def scene(lib):
        b = _cone_stack(lib)
        e = b.add_body(xform=[1.5, 0, 0.3, 0, 0, 0, 1])
        b.add_shape_ellipsoid(e, rx=0.3, ry=0.2, rz=0.15)
        b.add_joint_free(e)
        c = b.add_body(xform=[1.62, 0.05, 0.62, 0.2, 0.1, 0, 0.9746794])
        b.add_shape_cone(c, radius=0.1, half_height=0.2)
        b.add_joint_free(c)
        return b
    jm, tm = scene(jt).finalize(), scene(nt).finalize("cpu")
    jp = JPipe(jm)
    js = jm.state()
    ref = jp.collide(js)
    q0 = np.asarray(js.body_q)
    moved = []
    for to in (np.inf, -np.inf):
        q = q0.copy()
        q[:, :3] = np.nextafter(q[:, :3], np.float32(to))
        moved.append(jp.collide(js.replace(body_q=q)))
    got = nt.CollisionPipeline(tm).collide(tm.state())
    mask = np.asarray(ref.rigid_contact_mask)
    assert mask.sum() > 4
    np.testing.assert_array_equal(got.rigid_contact_mask.numpy(), mask)
    for name in ("rigid_contact_shape0", "rigid_contact_shape1"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    compared = 0
    for name in ("rigid_contact_depth", "rigid_contact_position",
                 "rigid_contact_normal"):
        r = np.asarray(getattr(ref, name)).reshape(len(mask), -1)
        ok = mask.copy()
        for m in moved:
            ok &= (np.abs(np.asarray(getattr(m, name)).reshape(
                len(mask), -1) - r) < 1e-6).all(-1)
        compared += ok.sum()
        np.testing.assert_allclose(
            getattr(got, name).numpy().reshape(len(mask), -1)[ok], r[ok],
            atol=ATOL, err_msg=name)
    assert compared >= 2 * mask.sum()
