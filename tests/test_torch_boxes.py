"""Boxes and cylinders in the port against the JAX package on the CPU: the
nine box and cylinder pair classes of the narrow phase, the builder's
``add_shape_box``/``add_shape_cylinder`` (mass, inertia, collision radius,
candidate pairs and slots), MJCF box and cylinder geoms, the static
collision pipeline slot for slot (flat and batched), the generalized
solver's contact plans on box rows (inside one articulation, compacted,
ragged), and example_pyramid.py on ``SolverFeatherstone``. On a CUDA card:
the pairs on the card against the CPU, and the pyramid substep's kernels
against their plain versions.

Tolerances: pair functions and collide 1e-5 (float32 transform chains).
A normal that is the unit vector between two points (closest points of
two segments, a sphere centre and a segment or a box surface) is compared
where those points lie 1e-2 apart or more: a float32 rounding of the
points moves it by ~1e-7 / distance, so nearer pairs are held by their
positions and depths alone;
finalize leaves 1e-6; ``step`` joint_q/body_q atol = rtol = 2e-4 and
joint_qd 5e-3 (tests/test_batched_step.py:69-75).

JAX is imported inside the fixtures and tests, so the GPU cases collect
where JAX is absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_boxes.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.geometry import narrow_phase as t_np
from newton_tpu_torch.geometry.types import GeoType
from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, MODEL_INT_FIELDS
from newton_tpu_torch.solvers.generalized import linalg, pgs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 22-23)

torch.set_num_threads(1)

ATOL = 1e-5
DT = 1.0 / 240.0
STRUCTURE = ("shape_type", "shape_body", "candidate_pairs",
             "candidate_pair_slots", "rigid_contact_max", "slot_shape0",
             "slot_shape1", "slot_body0", "slot_body1")
# (function, type of shape 0, type of shape 1)
PAIRS = {
    "plane_box": (GeoType.PLANE, GeoType.BOX),
    "plane_cylinder": (GeoType.PLANE, GeoType.CYLINDER),
    "sphere_box": (GeoType.SPHERE, GeoType.BOX),
    "capsule_box": (GeoType.CAPSULE, GeoType.BOX),
    "box_box": (GeoType.BOX, GeoType.BOX),
    "sphere_cylinder": (GeoType.SPHERE, GeoType.CYLINDER),
    "capsule_cylinder": (GeoType.CAPSULE, GeoType.CYLINDER),
    "capsule_capsule": (GeoType.CYLINDER, GeoType.CYLINDER),
    "box_cylinder": (GeoType.BOX, GeoType.CYLINDER),
}
SEGMENT_PAIRS = ("capsule_cylinder", "capsule_capsule")

gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scale(t, rng, n):
    """Scales of n shapes of type t: a plane's is unused, a sphere's is
    its radius thrice, a box's its half-extents, a capsule's and a
    cylinder's (radius, half-height, 0)."""
    s = (0.1 + 0.4 * rng.rand(n, 3)).astype(np.float32)
    if t == GeoType.SPHERE:
        s[:, 1:] = s[:, :1]
    elif t in (GeoType.CAPSULE, GeoType.CYLINDER):
        s[:, 2] = 0.0
    elif t == GeoType.PLANE:
        s[:] = 0.0
    return s


def _transforms(rng, n, spread=0.5):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([spread * rng.randn(n, 3), q], 1).astype(
        np.float32)


def _degenerate(t0, t1):
    """(X0, X1, s0, s1) of the degenerate cases: coincident centres
    (identity and turned), faces exactly aligned (identity frames offset
    along one axis: argmin/argmax ties), separated far apart, a shape
    resting exactly on a plane, a cylinder's axis along the plane
    normal."""
    I = [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
    turn = [0.0, 0.0, 0.0, 0.0, 0.0, 0.38268343, 0.92387953]
    X0, X1 = [], []
    for a, b in ((I, I), (I, turn), (I, [0, 0, 0.9, 0, 0, 0, 1]),
                 (I, [0.9, 0, 0, 0, 0, 0, 1]), (I, [0, 0.3, 0.3, 0, 0, 0, 1]),
                 (I, [5.0, 4.0, 3.0] + turn[3:]),
                 (I, [0, 0, 0.5, 0, 0, 0, 1]), (I, [0, 0, 0.25, 0, 0, 0, 1]),
                 ([0, 0, 0.5, 0, 0, 0, 1], I)):
        X0.append(a)
        X1.append(b)
    n = len(X0)

    def sc(t):
        s = np.full((n, 3), 0.5, np.float32)
        if t in (GeoType.CAPSULE, GeoType.CYLINDER):
            s[:, 0], s[:, 1], s[:, 2] = 0.25, 0.5, 0.0
        return s
    return (np.asarray(X0, np.float32), np.asarray(X1, np.float32),
            sc(t0), sc(t1))


def _segment_distance(name, X0, X1, s0, s1):
    """Distance between the two closest points of a segment pair, per
    slot (the JAX package's helpers)."""
    from newton_tpu.geometry import narrow_phase as j_np
    import jax.numpy as jnp
    a0, b0 = j_np._segment_endpoints(jnp.asarray(X0), jnp.asarray(s0[:, 1]))
    a1, b1 = j_np._segment_endpoints(jnp.asarray(X1), jnp.asarray(s1[:, 1]))
    c0, c1 = j_np._closest_point_segment_segment(a0, b0, a1, b1)
    c0b, c1b = j_np._closest_point_segment_segment(b0, a0, b1, a1)
    return np.stack([np.linalg.norm(np.asarray(c1 - c0), axis=-1),
                     np.linalg.norm(np.asarray(c1b - c0b), axis=-1)], 1)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_pair_function_matches_jax(name):
    """Each box and cylinder pair function on 256 seeded random pose pairs
    and the degenerate cases equals its JAX counterpart: position, normal
    and depth within 1e-5; ties in argmin/argmax go to the first, as in
    JAX."""
    import jax.numpy as jnp
    from newton_tpu.geometry import narrow_phase as j_np
    t0, t1 = PAIRS[name]
    rng = np.random.RandomState(sorted(PAIRS).index(name))
    n = 256
    X0, X1 = _transforms(rng, n), _transforms(rng, n)
    s0, s1 = _scale(t0, rng, n), _scale(t1, rng, n)
    D = _degenerate(t0, t1)
    X0, X1, s0, s1 = (np.concatenate([a, b]) for a, b in
                      zip((X0, X1, s0, s1), D))
    jfn = getattr(j_np, name)
    tfn = getattr(t_np, name)
    ref = [np.asarray(r) for r in jfn(*map(jnp.asarray, (X0, X1, s0, s1)))]
    got = [g.numpy() for g in tfn(*map(torch.as_tensor, (X0, X1, s0, s1)))]
    np.testing.assert_allclose(got[0], ref[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[2], ref[2], atol=ATOL, rtol=0)
    nrm_ok = np.ones(ref[2].shape, bool)
    if name in SEGMENT_PAIRS:
        nrm_ok = _segment_distance(name, X0, X1, s0, s1) > 1e-2
        assert nrm_ok.mean() > 0.9
    np.testing.assert_allclose(got[1][nrm_ok], ref[1][nrm_ok], atol=ATOL,
                               rtol=0)
    # the degenerate cases are all compared
    if name not in SEGMENT_PAIRS:
        assert nrm_ok[-len(D[0]):].all()
    # a batched call (leading world axis) gives the same numbers
    got_b = tfn(*(torch.as_tensor(x[:n]).view(4, n // 4, x.shape[-1])
                  for x in (X0, X1, s0, s1)))
    for a, b in zip(got_b, got):
        np.testing.assert_array_equal(a.reshape(b[:n].shape).numpy(), b[:n])


def test_pair_contact_fn_and_slots():
    """``contact_fn_for`` returns each new class with the JAX package's
    function order and slot count (plane-box 8, box-box 16, capsule-box 4,
    plane-cylinder 4, ...), BOX-CAPSULE as capsule_box swapped; a pair of
    a type still unported (a mesh) raises naming itself."""
    from newton_tpu.geometry import narrow_phase as j_np
    B, C, CY = GeoType.BOX, GeoType.CAPSULE, GeoType.CYLINDER
    for name, (t0, t1) in PAIRS.items():
        for a, b in ((t0, t1), (t1, t0)):
            fn, swapped, k = t_np.contact_fn_for(int(a), int(b))
            jfn, jswapped, jk = j_np.contact_fn_for(int(a), int(b))
            assert (fn.__name__, swapped, k) == (jfn.__name__, jswapped, jk)
    assert t_np.contact_fn_for(int(B), int(C))[:2] == (t_np.capsule_box,
                                                       True)
    assert [t_np.pair_slot_count(int(a), int(b)) for a, b in (
        (GeoType.PLANE, B), (B, B), (C, B), (GeoType.PLANE, CY))] \
        == [8, 16, 4, 4]
    with pytest.raises(NotImplementedError, match="MESH-BOX"):
        t_np.contact_fn_for(int(GeoType.MESH), int(B))


def test_box_box_deepest_corner():
    """tests/test_geometry.py's box-box case on the port: two unit boxes
    0.9 apart along z overlap 0.1, and every penetrating slot's normal is
    along z."""
    def xf(p):
        return torch.tensor([[*p, 0.0, 0.0, 0.0, 1.0]])
    half = torch.tensor([[0.5, 0.5, 0.5]])
    pos, nrm, depth = t_np.box_box(xf((0, 0, 0)), xf((0, 0, 0.9)), half,
                                   half)
    assert float(depth.max()) > 0.09
    act = depth[0] > 0
    assert (nrm[0][act][:, 2].abs() > 0.99).all()


# ----------------------------------------------------------------------
# builder and importer
# ----------------------------------------------------------------------
def _all_pairs_scene(lib, n=1):
    """One free body per shape type (sphere, box, capsule, cylinder, a
    second box and cylinder, the cylinders along x and y) above a ground
    plane: every new pair class, replicated n times."""
    w = lib.ModelBuilder()
    cfg = lib.ShapeConfig(density=700.0, mu=0.7, restitution=0.1)
    shapes = (
        lambda b: w.add_shape_sphere(b, radius=0.2, cfg=cfg),
        lambda b: w.add_shape_box(b, hx=0.2, hy=0.15, hz=0.1, cfg=cfg),
        lambda b: w.add_shape_capsule(b, radius=0.1, half_height=0.2,
                                      cfg=cfg),
        lambda b: w.add_shape_cylinder(b, radius=0.12, half_height=0.18,
                                       axis="X", cfg=cfg),
        lambda b: w.add_shape_box(
            b, xform=[0.02, 0, 0, 0, 0, 0.19509032, 0.98078528], hx=0.1,
            hy=0.1, hz=0.25, cfg=cfg),
        lambda b: w.add_shape_cylinder(b, radius=0.15, half_height=0.1,
                                       axis="Y", cfg=cfg))
    for i, add in enumerate(shapes):
        body = w.add_body(xform=[0.3 * (i % 3), 0.3 * (i // 3), 0.3 + 0.2 * i,
                                 0, 0, 0, 1])
        add(body)
        w.add_joint_free(body)
        w.add_articulation()
    b = lib.ModelBuilder()
    b.replicate(w, n)
    b.add_ground_plane()
    return b


def _assert_leaves(tm, jm):
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


@pytest.mark.parametrize("n", [1, 3])
def test_box_cylinder_builder_leaves_match_jax(n):
    """``add_shape_box`` and ``add_shape_cylinder`` (mass and inertia from
    density, an offset and turned box, cylinders along x and y), alone and
    replicated: mass, inertia, COM, collision radius, candidate pairs and
    slot counts equal the JAX builder's."""
    import newton_tpu as jt
    tm = _all_pairs_scene(nt, n).finalize("cpu")
    jm = _all_pairs_scene(jt, n).finalize()
    _assert_leaves(tm, jm)
    typ = tm.structure.shape_type
    counts = np.diff(tm.structure.candidate_pair_slots)
    pairs = tm.structure.candidate_pairs
    classes = {(min(typ[a], typ[b]), max(typ[a], typ[b])): k
               for (a, b), k in zip(pairs, counts)}
    P, S, Bx, C, CY = (int(t) for t in (GeoType.PLANE, GeoType.SPHERE,
                                        GeoType.BOX, GeoType.CAPSULE,
                                        GeoType.CYLINDER))
    assert classes[(P, Bx)] == 8 and classes[(Bx, Bx)] == 16
    assert classes[(Bx, C)] == 4 and classes[(P, CY)] == 4
    assert classes[(Bx, CY)] == 4 and classes[(S, Bx)] == 1
    # box |half-extents|, cylinder r + h
    np.testing.assert_allclose(tm.shape_collision_radius.numpy()[1:3],
                               [np.linalg.norm([0.2, 0.15, 0.1]), 0.3],
                               rtol=1e-6)


def test_bridge_carries_boxes_and_cylinders():
    """The JAX model of the every-pair scene x 2 through the bridge equals
    the port's own finalize (shape types, scales, inertia, slots), and the
    port's model survives a round trip through the bridge exactly."""
    import newton_tpu as jt
    from newton_tpu_torch.utils import bridge
    jm = _all_pairs_scene(jt, 2).finalize()
    tm = _all_pairs_scene(nt, 2).finalize("cpu")
    leaves = {n: np.asarray(getattr(jm, n))
              for n in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS}
    leaves["custom"] = {}
    structure = {n: getattr(jm.structure, n) for n in bridge.STRUCTURE_FIELDS}
    structure["mjc_actuation"] = None
    bm = bridge.model_from_numpy(leaves, structure, "cpu")
    _assert_leaves(bm, jm)
    _assert_leaves(tm, jm)
    back = bridge.model_from_numpy(*bridge.model_to_numpy(tm), "cpu")
    for name in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS:
        assert torch.equal(getattr(back, name), getattr(tm, name)), name


BOX_MJCF = """
<mujoco model="boxes">
  <worldbody>
    <geom name="floor" type="plane" size="5 5 1"/>
    <body name="crate" pos="0 0 0.5">
      <freejoint/>
      <geom type="box" size="0.2 0.1 0.3" density="500"/>
      <geom type="cylinder" size="0.05 0.2" pos="0.25 0 0" euler="0 90 0"
            mass="1.5"/>
      <body name="lid" pos="0 0 0.35">
        <joint name="hinge" axis="1 0 0"/>
        <geom type="box" size="0.2 0.1 0.02" mass="0.4"/>
        <geom type="cylinder" fromto="-0.2 0 0.05 0.2 0 0.05" size="0.02"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


def test_box_cylinder_mjcf_import_matches_jax(tmp_path):
    """MJCF ``type="box"`` and ``type="cylinder"`` geoms (size, density,
    ``mass`` as density over the volume, ``fromto`` cylinders) import as
    the JAX importer's: every leaf equal."""
    import newton_tpu as jt
    path = tmp_path / "boxes.xml"
    path.write_text(BOX_MJCF)
    tb, jb = nt.ModelBuilder(), jt.ModelBuilder()
    tb.add_mjcf(str(path))
    jb.add_mjcf(str(path))
    tm, jm = tb.finalize("cpu"), jb.finalize()
    _assert_leaves(tm, jm)
    assert tm.structure.shape_type.tolist() == [
        int(GeoType.PLANE), int(GeoType.BOX), int(GeoType.CYLINDER),
        int(GeoType.BOX), int(GeoType.CYLINDER)]


# ----------------------------------------------------------------------
# collide
# ----------------------------------------------------------------------
def _poses(rng, n_worlds, m):
    """Random body poses of m bodies per world clustered within 0.3 of
    each other just above the ground (many overlaps)."""
    p = 0.15 * rng.randn(n_worlds * m, 3)
    p[:, 2] = 0.05 + 0.2 * rng.rand(n_worlds * m)
    q = rng.randn(n_worlds * m, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([p, q], 1).astype(np.float32)


def _normal_gap(tm, contacts):
    """Per slot, the distance between the two points whose difference
    defines the normal: r0 + r1 + thickness - depth for pairs of spheres,
    capsules and cylinders, and for those against a box (the box's
    radius 0: the signed distance from the point to the box surface,
    negative inside, where the normal is the nearest face's axis); +inf
    for plane and box-box classes, whose normal is an axis."""
    st = tm.structure
    typ = np.asarray(st.shape_type)
    sc = tm.shape_scale.numpy()
    rad = np.where(np.isin(typ, [int(GeoType.SPHERE), int(GeoType.CAPSULE),
                                 int(GeoType.CYLINDER)]), sc[:, 0], 0.0)
    thick = tm.shape_thickness.numpy()
    s0 = contacts.rigid_contact_shape0.numpy().astype(np.int64)
    s1 = contacts.rigid_contact_shape1.numpy().astype(np.int64)
    axis = ((typ[s0] == int(GeoType.PLANE)) | (typ[s1] == int(GeoType.PLANE))
            | ((typ[s0] == int(GeoType.BOX)) & (typ[s1] == int(GeoType.BOX))))
    gap = (rad[s0] + rad[s1] + thick[s0] + thick[s1]
           - contacts.rigid_contact_depth.numpy())
    return np.where(axis, np.inf, gap)


def _assert_contacts(tm, got, ref):
    """Mask and shapes exact; depth within 1e-5 everywhere, position on
    active slots, normal on active slots whose defining points lie 1e-2
    apart or more, or 1e-2 inside a box (see the module docstring)."""
    mask = np.asarray(ref.rigid_contact_mask)
    np.testing.assert_array_equal(got.rigid_contact_mask.numpy(), mask)
    for name in ("rigid_contact_shape0", "rigid_contact_shape1"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(got.rigid_contact_depth.numpy(),
                               np.asarray(ref.rigid_contact_depth),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.rigid_contact_position.numpy()[mask],
                               np.asarray(ref.rigid_contact_position)[mask],
                               atol=ATOL, rtol=0)
    nrm = mask & (np.abs(_normal_gap(tm, got)) > 1e-2)
    assert nrm.sum() > 0.9 * mask.sum()
    np.testing.assert_allclose(got.rigid_contact_normal.numpy()[nrm],
                               np.asarray(ref.rigid_contact_normal)[nrm],
                               atol=ATOL, rtol=0)
    return mask


def test_collide_every_pair_class_matches_jax():
    """``collide`` on a scene with every new pair class, flat over 4
    replicated worlds and batched over 6 envs of one world, equals the JAX
    package's slot for slot: 8- and 16-slot classes land on their pairs'
    slots, the mask is exact, depth, position and normal within 1e-5."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.parallel import batch_state as j_batch_state
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    rng = np.random.RandomState(3)
    # flat: 4 worlds
    jm = _all_pairs_scene(jt, 4).finalize()
    tm = _all_pairs_scene(nt, 4).finalize("cpu")
    bq = _poses(rng, 4, 6)
    ref = JPipe(jm).collide(jm.state().replace(body_q=jnp.asarray(bq)))
    ts = tm.state()
    ts.body_q = torch.as_tensor(bq)
    got = nt.CollisionPipeline(tm).collide(ts)
    mask = _assert_contacts(tm, got, ref)
    # every class has active slots, on both slot counts' classes
    sb = tm.structure
    typ = sb.shape_type
    live = {(int(typ[a]), int(typ[b])) for a, b in
            zip(sb.slot_shape0[mask], sb.slot_shape1[mask])}
    assert len(live) >= 12, live
    # batched: one world, 6 envs
    jm1 = _all_pairs_scene(jt, 1).finalize()
    tm1 = _all_pairs_scene(nt, 1).finalize("cpu")
    bq1 = _poses(rng, 6, 6).reshape(6, 6, 7)
    sb_j = j_batch_state(jm1.state(), 6).replace(body_q=jnp.asarray(bq1))
    ref_b = jax.vmap(JPipe(jm1).collide)(sb_j)
    tsb = nt.batch_state(tm1.state(), 6)
    tsb.body_q = torch.as_tensor(bq1)
    got_b = nt.CollisionPipeline(tm1).collide(tsb)
    assert got_b.rigid_contact_mask.shape == (6, sb.rigid_contact_max // 4)
    mask_b = _assert_contacts(tm1, got_b, ref_b)
    assert mask_b.any(1).all()


# ----------------------------------------------------------------------
# the generalized solver on box rows
# ----------------------------------------------------------------------
def _jax_states(jm, tm):
    """FK of joint_q0 on both sides."""
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    js = j_eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state())
    ts = nt.eval_fk(tm, tm.joint_q0, tm.joint_qd0, tm.state())
    return js, ts


def _assert_states(got, ref, q_atol=2e-4, qd_atol=5e-3):
    for name, atol in (("joint_q", q_atol), ("joint_qd", qd_atol),
                       ("body_q", q_atol)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=atol, err_msg=name)


@pytest.fixture(scope="module")
def pyramid():
    """example_pyramid.py x 2 worlds on both sides, with the JAX step
    jitted."""
    import jax
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers.generalized.solver import \
        SolverFeatherstone as JS
    n = 2
    jm = cs.pyramid_scene(jt, n)[0].finalize()
    tb, top = cs.pyramid_scene(nt, n)
    tm = tb.finalize("cpu")
    js_ = JS(jm, contact_iterations=16)
    jp = JPipe(jm)
    jc = jm.control()
    return dict(n=n, top=top, jm=jm, tm=tm,
                ts_=nt.SolverFeatherstone(tm, contact_iterations=16),
                tp=nt.CollisionPipeline(tm),
                jstep=jax.jit(lambda s: js_.step(s, None, jc, jp.collide(s),
                                                 DT)))


def test_pyramid_plan_is_one_articulation(pyramid):
    """A world's six free boxes are one articulation group (d = 36, one
    row per world): every box-box entry has both bodies in the row (one
    Jacobian row, no two-sided ``w_other`` entry), 6 x 8 plane-box plus
    15 x 16 box-box slots = 288 entries compacted to the top 32; B1 runs
    its generic shared-memory instance and B2 (32, 0, 36) smem128 (or the
    global-scratch instance with every entry, contact_cap=0)."""
    ts_ = pyramid["ts_"]
    assert [(g.g.n, g.g.d) for g in ts_.groups] == [(pyramid["n"], 36)]
    plan = ts_.contact_plans[0]
    assert plan.uniform and plan.c == 288 and (plan.ob < 0).all()
    both = (plan.lb0 >= 0) & (plan.lb1 >= 0)
    assert int(both.sum()) == 15 * 16
    assert ts_.tables.cap == 32 and ts_.tables.other is None
    assert linalg.kernel_instance(36) == "generic_smem"
    assert pgs.kernel_instance(32, 0, 36) == "smem128"
    assert pgs.kernel_instance(288, 0, 36) == "global256"


@pytest.mark.parametrize("substeps", [1, 8])
def test_pyramid_featherstone_matches_jax(pyramid, substeps):
    """example_pyramid.py x 2 on ``SolverFeatherstone(contact_iterations=
    16)`` (box rows compacted to 32 per world), 1 and 8 substeps against
    the JAX package's ``step``."""
    p = pyramid
    js, ts = _jax_states(p["jm"], p["tm"])
    tc = p["tm"].control()
    for _ in range(substeps):
        ts = p["ts_"].step(ts, None, tc, p["tp"].collide(ts), DT)
        js = p["jstep"](js)
    _assert_states(ts, js)


def test_pyramid_stands(pyramid):
    """example_pyramid.py's gates after its 40 frames (tests/
    test_examples.py), in every world: the top box above 0.6 and within
    0.1 of the axis in x and y, no box beyond 0.8."""
    p = pyramid
    ts = nt.eval_fk(p["tm"], p["tm"].joint_q0, p["tm"].joint_qd0,
                    p["tm"].state())
    tc = p["tm"].control()
    for _ in range(40 * 4):
        ts = p["ts_"].step(ts, None, tc, p["tp"].collide(ts), DT)
    pos = ts.body_q[:, :3].view(p["n"], 6, 3)
    assert torch.isfinite(pos).all()
    top = pos[:, p["top"]]
    assert (top[:, 2] > 0.6).all(), top
    assert (top[:, :2].abs() < 0.1).all(), top
    assert (pos[..., :2].abs() < 0.8).all()


def _ragged_box_scene(lib, n):
    """example_hetero_worlds.py as published: a free sphere of radius 0.3
    dropped from z = 1 in every world, a static box pedestal (half-extents
    0.3 x 0.3 x 0.2 at z = 0.2) in the odd worlds only."""
    b = lib.ModelBuilder()
    for w in range(n):
        b.begin_world()
        b.add_articulation()
        body = b.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1])
        b.add_shape_sphere(body, radius=0.3)
        b.add_joint_free(body)
        if w % 2:
            b.add_shape_box(-1, xform=[0, 0, 0.2, 0, 0, 0, 1], hx=0.3,
                            hy=0.3, hz=0.2)
        b.end_world()
    b.add_ground_plane()
    return b


def test_ragged_box_pedestal_matches_jax():
    """example_hetero_worlds.py's box pedestal in the odd worlds x 4: a
    ragged plan (a sphere-box slot more in the odd rows), 8 substeps
    against the JAX package's ``step``, then 1.25 s: the sphere rests at
    z = 0.3 on the ground and 0.7 on the pedestal (+-0.05)."""
    import jax
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers.generalized.solver import \
        SolverFeatherstone as JS
    n = 4
    jm = _ragged_box_scene(jt, n).finalize()
    tm = _ragged_box_scene(nt, n).finalize("cpu")
    ts_ = nt.SolverFeatherstone(tm, contact_iterations=8)
    plan = ts_.contact_plans[0]
    assert not plan.uniform and plan.valid.sum(1).tolist() == [1, 2, 1, 2]
    js_ = JS(jm, contact_iterations=8)
    jp, tp = JPipe(jm), nt.CollisionPipeline(tm)
    js, ts = _jax_states(jm, tm)
    jc, tc = jm.control(), tm.control()
    jstep = jax.jit(lambda s: js_.step(s, None, jc, jp.collide(s), DT))
    for k in range(300):
        ts = ts_.step(ts, None, tc, tp.collide(ts), DT)
        if k < 8:
            js = jstep(js)
            _assert_states(ts, js)
    np.testing.assert_allclose(ts.body_q[:, 2].numpy(), [0.3, 0.7, 0.3, 0.7],
                               atol=0.05)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@gpu
@pytest.mark.parametrize("name", sorted(PAIRS))
def test_pairs_on_card_match_cpu(cuda, name):
    """The pair functions on the card equal the CPU's on 256 random pose
    pairs (1e-5)."""
    t0, t1 = PAIRS[name]
    rng = np.random.RandomState(11)
    n = 256
    args = (_transforms(rng, n), _transforms(rng, n), _scale(t0, rng, n),
            _scale(t1, rng, n))
    fn = getattr(t_np, name)
    ref = fn(*map(torch.as_tensor, args))
    got = fn(*(torch.as_tensor(a, device=cuda) for a in args))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.cpu(), b, atol=ATOL, rtol=0)


@gpu
def test_pyramid_substep_kernels_match_plain(cuda):
    """One pyramid x 64 substep on the card through the kernels and through
    their plain versions: B1 (d = 36, generic_smem) within atol 1e-5, rtol
    1e-4, B2 (32, 0, 36) lam 1e-4 and dqd 1e-3 (envs whose guard halvings
    differ left out, at most 1), one launch of each."""
    n = 64
    tb, _ = cs.pyramid_scene(nt, n)
    tm = tb.finalize(cuda)
    solver = nt.SolverFeatherstone(tm, contact_iterations=16)
    pipe = nt.CollisionPipeline(tm)
    s = nt.eval_fk(tm, tm.joint_q0, tm.joint_qd0, tm.state())
    tc = tm.control()
    for _ in range(8):
        s = solver.step(s, None, tc, pipe.collide(s), DT)
    rec = {}
    b1, b2 = linalg.chol_inv_solve.launches, pgs.pgs_solve_fused.launches
    solver.step(s, None, tc, pipe.collide(s), DT, record=rec)
    torch.cuda.synchronize()
    assert linalg.chol_inv_solve.launches == b1 + 1
    assert pgs.pgs_solve_fused.launches == b2 + 1
    got = linalg.chol_inv_solve(*rec["chol"])
    ref = linalg.chol_inv_solve_plain(*rec["chol"])
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    args, kw = rec["pgs"]
    assert kw["c"] == 32
    lam_k, dqd_k, h_k = pgs.pgs_solve_fused(*args, **kw,
                                            return_halvings=True)
    lam_p, dqd_p, h_p = pgs.pgs_solve_fused_plain(*args, **kw,
                                                  return_halvings=True)
    same = h_k == h_p
    assert int((~same).sum()) <= 1
    torch.testing.assert_close(lam_k[same], lam_p[same], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(dqd_k[same], dqd_p[same], atol=1e-3,
                               rtol=1e-3)
