"""Parity of the port's ray casts with the JAX package: the intersectors,
``raycast_model`` on a scene with every GeoType (2,000 seeded rays; t
within 1e-5 max(1, t), normals within 1e-4, the shape index equal except
at counted ties, ``max_dist`` honoured), the mesh BVH (build bit for bit,
refit, traversal, against brute force), the plain twins' chunking, the
reference defects C.44 (an ellipsoid traced as a sphere, a cylinder as a
capsule, no cone and no unbaked hull ever hit) and C.45 (a free root's
world offset applied twice), and the bounds of the two ray-cast kernels.
The GPU cases hold K1 and K2 against their plain twins on the card."""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.geometry import bvh as tbvh
from newton_tpu_torch.geometry import raycast as tray

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (scenes and kernel_cost)

torch.set_num_threads(1)
gpu = pytest.mark.skipif(not torch.cuda.is_available(),
                         reason="needs a CUDA device")
T_TOL, N_TOL = 1e-5, 1e-4


def zoo_scene(lib):
    """One body a GeoType (plane, sphere, ellipsoid, box, capsule,
    cylinder, cone, a hull with a bake, a hull without one (no collision),
    a mesh at two scales, an SDF shape, a heightfield), a Gaussian cloud
    and a site; every body turned a little."""
    import importlib
    terrain = importlib.import_module(lib.__name__ + ".geometry.terrain")
    rng = np.random.RandomState(7)
    b = lib.ModelBuilder()

    def body(x, y, z):
        q = np.r_[0.3 * rng.randn(3), 1.0]
        i = b.add_body(xform=[x, y, z, *(q / np.linalg.norm(q))])
        b.add_joint_free(i)
        return i
    b.add_ground_plane()
    s = body(0.0, 0.0, 1.0)
    b.add_shape_sphere(s, radius=0.4)
    b.add_shape_gaussian(s, means=np.zeros((3, 3)),
                         scales=np.full((3, 3), 0.05))
    b.add_shape_ellipsoid(body(1.5, 0.0, 1.0), rx=0.35, ry=0.2, rz=0.3)
    box = body(-1.5, 0.0, 1.0)
    b.add_shape_box(box, hx=0.3, hy=0.2, hz=0.25)
    b.add_site(box, key="site")
    b.add_shape_capsule(body(0.0, 1.5, 1.0), radius=0.2, half_height=0.3)
    b.add_shape_cylinder(body(1.5, 1.5, 1.0), radius=0.25, half_height=0.3)
    b.add_shape_cone(body(-1.5, 1.5, 1.0), radius=0.3, half_height=0.3)
    hull = cs.box_mesh(lib, 0.25)
    b.add_shape_convex_hull(body(0.0, -1.5, 1.0), mesh=hull)
    off = b.default_shape_cfg.copy()
    off.has_shape_collision = False
    b.add_shape_convex_hull(body(-1.5, -1.5, 1.0), mesh=hull, cfg=off)
    torus = cs.torus_mesh(lib, R=0.3, r=0.1, nu=16, nv=8)
    b.add_shape_mesh(body(1.5, -1.5, 1.0), mesh=torus)
    b.add_shape_mesh(body(3.0, -1.5, 1.0), mesh=torus, scale=(1.3, 0.8, 1.0))
    g = np.linspace(-0.5, 0.5, 24)          # the pool's resolution
    grid = np.sqrt(g[:, None, None] ** 2 + g[None, :, None] ** 2
                   + g[None, None, :] ** 2) - 0.3
    b.add_shape_sdf(body(3.0, 0.0, 1.0), sdf=lib.SDF(
        grid.astype(np.float32), np.full(3, -0.5), np.full(3, 0.5)))
    b.add_shape_heightfield(
        -1, xform=[3.0, 1.5, 0.2, 0, 0, 0, 1],
        heightfield=terrain.generate_fractal_terrain(
            nx=8, ny=8, size_x=1.2, size_y=1.2, amplitude=0.15, seed=4))
    return b


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    o = np.c_[rng.uniform(-3.5, 4.5, (n, 2)), rng.uniform(0.1, 3.0, n)]
    tgt = np.c_[rng.uniform(-2.0, 3.5, (n, 2)), rng.uniform(0.0, 1.6, n)]
    d = tgt - o
    return (o.astype(np.float32),
            (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def zoo_models():
    """Both packages' zoo models and states, the bodies moved off
    joint_q0 by the port's forward kinematics (both ray casts take the
    same poses: a grazing ray's t amplifies last-bit differences); made
    once a process (tests/test_torch_viewers.py picks on it too)."""
    import jax.numpy as jnp
    import newton_tpu as jt
    jm, tm = zoo_scene(jt).finalize(), zoo_scene(nt).finalize("cpu")
    rng = np.random.RandomState(11)
    q = tm.joint_q0.numpy().copy().reshape(-1, 7)
    q[:, :3] += 0.05 * rng.randn(len(q), 3)
    q[:, 3:] += 0.2 * rng.randn(len(q), 4)
    q[:, 3:] /= np.linalg.norm(q[:, 3:], axis=1, keepdims=True)
    ts = nt.eval_fk(tm, torch.as_tensor(q.reshape(-1).astype(np.float32)),
                    tm.joint_qd0, tm.state())
    js = jm.state().replace(body_q=jnp.asarray(ts.body_q.numpy()))
    return jm, js, tm, ts


@pytest.fixture(scope="module")
def zoo():
    return zoo_models()


ZOO_RAYS = (2000, 0)          # _rays' count and seed


@functools.lru_cache(maxsize=None)
def zoo_jax_cast():
    """The JAX package's raycast_model of the zoo's ZOO_RAYS, as numpy
    (t, shape, normal); cast once a process (eager JAX compiles each
    operation at each new shape, ~15 s here)."""
    jm, js, _, _ = zoo_models()
    return tuple(np.asarray(x) for x in _jax_raycast(jm, js,
                                                     *_rays(*ZOO_RAYS)))


def _jax_raycast(jm, js, o, d):
    """The JAX package's raycast_model, eagerly: jitted, XLA contracts
    products into fused multiply-adds and grazing rays part further."""
    import jax.numpy as jnp
    from newton_tpu.geometry.raycast import raycast_model as j_ray
    return j_ray(jm, js, jnp.asarray(o), jnp.asarray(d))


def _compare(jres, tres, label, recast=None):
    """t, normals and shape index of the two packages. Returns (rays whose
    shapes differ, ill-conditioned rays): a ray off the t tolerance counts
    as ill-conditioned (a grazing hit, where the quadratic's square root
    amplifies rounding) only where ``recast`` (the port on origins moved
    one ulp) moves its own t by more than the tolerance too."""
    jt_, js_, jn_ = (np.asarray(x) for x in jres)
    tt_, ts_, tn_ = (x.numpy() for x in tres)
    np.testing.assert_array_equal(js_ >= 0, ts_ >= 0, err_msg=label)
    hit = js_ >= 0
    tol = T_TOL * np.maximum(1.0, jt_)
    off = hit & (np.abs(tt_ - jt_) > tol)
    if off.any():
        assert recast is not None, f"{label}: {int(off.sum())} rays off t"
        moved = recast(off)
        assert (np.abs(moved - tt_[off]) > tol[off]).all(), \
            f"{label}: well-conditioned rays off the t tolerance"
    ties = int((js_ != ts_).sum())
    same = hit & (js_ == ts_) & ~off
    np.testing.assert_allclose(tn_[same], jn_[same], atol=N_TOL, rtol=0,
                               err_msg=label)
    return ties, int(off.sum())


def _ulp_recast(tm, ts, o, d):
    """The port's t for the rays ``mask`` with origins one ulp up."""
    def recast(mask):
        o2 = np.nextafter(o[mask], np.float32(np.inf))
        return tray.raycast_model(tm, ts, torch.as_tensor(o2),
                                  torch.as_tensor(d[mask]))[0].numpy()
    return recast


def test_raycast_model_matches_jax_on_every_geo_type(zoo):
    """2,000 rays into the zoo: every class is hit (the cone, the unbaked
    hull, the site and the Gaussian never), and t, normals and shape
    indices agree with the JAX package; shapes may differ only where two
    shapes' t tie (none here), t only on a grazing ray whose own t moves
    beyond the tolerance when its origin moves one ulp (counted: one
    here, on the sphere)."""
    _, _, tm, ts = zoo
    o, d = _rays(*ZOO_RAYS)
    jres = zoo_jax_cast()
    tres = tray.raycast_model(tm, ts, torch.as_tensor(o), torch.as_tensor(d))
    ties, grazing = _compare(jres, tres, "zoo", _ulp_recast(tm, ts, o, d))
    assert ties == 0 and grazing <= 2
    hit = set(np.unique(tres[1].numpy()).tolist()) - {-1}
    types = tm.structure.shape_type
    want = {int(nt.GeoType.PLANE), int(nt.GeoType.SPHERE),
            int(nt.GeoType.ELLIPSOID), int(nt.GeoType.BOX),
            int(nt.GeoType.CAPSULE), int(nt.GeoType.CYLINDER),
            int(nt.GeoType.CONVEX), int(nt.GeoType.MESH),
            int(nt.GeoType.SDF), int(nt.GeoType.HFIELD)}
    assert {int(types[s]) for s in hit} == want


def test_raycast_max_dist_matches_jax(zoo):
    """With max_dist = 2 no hit lies beyond it, and the answers are the
    JAX package's (its closest hit within 2, else a miss, as its
    raycast_model masks t > max_dist before the argmin)."""
    _, _, tm, ts = zoo
    o, d = _rays(*ZOO_RAYS)
    jt_, js_, jn_ = zoo_jax_cast()
    far = jt_ > 2.0
    jres = (np.where(far, np.float32(1e10), jt_), np.where(far, -1, js_),
            jn_)
    tres = tray.raycast_model(tm, ts, torch.as_tensor(o),
                              torch.as_tensor(d), max_dist=2.0)
    ties, grazing = _compare(jres, tres, "max_dist",
                             _ulp_recast(tm, ts, o, d))
    assert ties == 0 and grazing <= 2
    t, s = tres[0].numpy(), tres[1].numpy()
    assert (t[s >= 0] <= 2.0).all() and (t[s < 0] == 1e10).all()
    assert far.any() and (s >= 0).any()


def test_chunking_does_not_change_answers(zoo, monkeypatch):
    """The plain twins' chunk size changes no ray's answer, bit for bit."""
    _, _, tm, ts = zoo
    o, d = (torch.as_tensor(x) for x in _rays(300, 2))
    ref = tray.raycast_model(tm, ts, o, d)
    monkeypatch.setattr(tray, "PAIR_BUDGET", 37)
    got = tray.raycast_model(tm, ts, o, d)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_bridged_jax_model_casts_the_same(zoo):
    """A JAX model through the bridge, its geometry sources (meshes,
    source ids, splats) included, casts the same rays as the port's own
    model, bit for bit."""
    from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, \
        MODEL_INT_FIELDS
    from newton_tpu_torch.utils import bridge
    jm, _, tm, ts = zoo
    st = jm.structure
    leaves = {n: np.asarray(getattr(jm, n))
              for n in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS}
    structure = {n: getattr(st, n) for n in bridge.STRUCTURE_FIELDS
                 + bridge.SOURCE_FIELDS}
    structure["mjc_actuation"] = None
    bm = bridge.model_from_numpy(leaves, structure, "cpu")
    assert len(bm.structure.meshes) == len(tm.structure.meshes) == 3
    assert len(bm.structure.gaussians) == 1
    o, d = (torch.as_tensor(x) for x in _rays(300, 4))
    for a, b in zip(tray.raycast_model(tm, ts, o, d),
                    tray.raycast_model(bm, ts, o, d)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["plane", "sphere", "box", "capsule"])
def test_intersectors_match_jax(kind):
    """Each intersector on 500 random local rays, t and normals."""
    import jax.numpy as jnp
    from newton_tpu.geometry import raycast as jray
    rng = np.random.RandomState(3)
    o = rng.uniform(-1.5, 1.5, (500, 3)).astype(np.float32)
    d = rng.randn(500, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    half = np.array([0.3, 0.5, 0.4], np.float32)
    args = {"plane": (), "sphere": (0.6,), "box": (half,),
            "capsule": (0.3, 0.5)}[kind]
    jt_, jn_ = getattr(jray, f"ray_{kind}")(jnp.asarray(o), jnp.asarray(d),
                                           *map(jnp.asarray, args))
    tt_, tn_ = getattr(tray, f"ray_{kind}")(
        torch.as_tensor(o), torch.as_tensor(d),
        *(torch.as_tensor(np.asarray(a, np.float32)) for a in args))
    jt_, jn_ = np.asarray(jt_), np.asarray(jn_)
    hit = jt_ < 1e10
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(tt_.numpy() < 1e10, hit)
    np.testing.assert_allclose(tt_.numpy()[hit], jt_[hit], rtol=T_TOL,
                               atol=T_TOL)
    np.testing.assert_allclose(tn_.numpy()[hit], jn_[hit], atol=N_TOL)


def test_reference_defect_c44_classes(zoo):
    """C.44, in both packages: every hit on the ellipsoid (0.35, 0.2, 0.3)
    lies on the sphere of radius rx, every hit on the cylinder lies on a
    capsule (radius from the axis segment), some on its caps beyond the
    half height (rays from outside each); the cone and the hull without a bake are never hit (the
    zoo test's hit classes)."""
    _, _, tm, ts = zoo
    st = tm.structure
    o, d = _rays(*ZOO_RAYS)
    X = tray.shape_world_transforms(tm, ts).double()
    ell = int(np.nonzero(st.shape_type == int(nt.GeoType.ELLIPSOID))[0][0])
    cyl = int(np.nonzero(st.shape_type == int(nt.GeoType.CYLINDER))[0][0])
    jres = zoo_jax_cast()
    tres = [x.numpy() for x in tray.raycast_model(
        tm, ts, torch.as_tensor(o), torch.as_tensor(d))]
    for t, s_, _ in (jres, tres):
        for shape, check in ((ell, "sphere"), (cyl, "capsule")):
            sc = tm.shape_scale[shape].double()
            # rays from outside the shape's bounding sphere (a capsule's
            # far cap is hit from inside it)
            ol = tray.quat_rotate_inv(X[shape, 3:7], torch.as_tensor(
                o).double() - X[shape, :3])
            m = (s_ == shape) & (ol.norm(dim=-1) > sc[0] + sc[1]).numpy()
            p = torch.as_tensor(o[m] + d[m] * t[m, None]).double()
            p = tray.quat_rotate_inv(X[shape, 3:7], p - X[shape, :3])
            if check == "sphere":
                dist = p.norm(dim=-1) - sc[0]
            else:
                z = p[:, 2].clamp(-sc[1], sc[1])
                dist = (p - torch.stack([0 * z, 0 * z, z], -1)).norm(
                    dim=-1) - sc[0]
                assert (p[:, 2].abs() > sc[1] + 1e-3).any()
            assert m.sum() > 5 and dist.abs().max() < 1e-4


def test_reference_defect_c45_free_root_offset_twice():
    """C.45, in both packages: replicate(..., spacing) puts world i's grid
    offset into its free root's joint_q0 and into the root joint's parent
    frame, so forward kinematics stands world i's ant at twice it."""
    import newton_tpu as jt
    jm = cs.camera_ant_scene(jt, 4).finalize()
    tm = cs.camera_ant_scene(nt, 4).finalize("cpu")
    grid = np.array([[0, 0], [4, 0], [0, 4], [4, 4]], np.float32)
    for m in (jm, tm):
        st = m.structure
        roots = np.nonzero(np.asarray(st.joint_parent) < 0)[0]
        q0 = np.asarray(m.joint_q0).reshape(4, -1)
        X_p = np.asarray(m.joint_X_p)
        np.testing.assert_allclose(q0[:, :2], grid, atol=1e-6)
        np.testing.assert_allclose(X_p[roots, :2], grid, atol=1e-6)
    torso = [i for i, k in enumerate(tm.structure.body_key) if k == "torso"]
    ts = nt.eval_fk(tm, tm.joint_q0, tm.joint_qd0, tm.state())
    np.testing.assert_allclose(ts.body_q[torso, :2].numpy(), 2 * grid,
                               atol=1e-6)


# ----------------------------------------------------------------------
# the mesh BVH
# ----------------------------------------------------------------------
def _meshes():
    torus = cs.torus_mesh(nt, R=0.3, r=0.1, nu=20, nv=10)
    rng = np.random.RandomState(5)
    bumpy = nt.Mesh(torus.vertices + 0.01 * rng.randn(*torus.vertices.shape),
                    torus.indices)
    from newton_tpu_torch.geometry.terrain import (
        generate_fractal_terrain, heightfield_to_mesh)
    field = heightfield_to_mesh(generate_fractal_terrain(
        nx=24, ny=24, size_x=4.0, size_y=4.0, seed=1))
    return {"torus": torus, "bumpy": bumpy, "field": field}


@pytest.fixture(scope="module")
def meshes():
    return _meshes()


@pytest.mark.parametrize("name", ["torus", "bumpy", "field"])
def test_bvh_build_bit_equal_to_jax(meshes, name):
    """depth, leaf budget, boxes, leaf triangles and masks bit for bit."""
    from newton_tpu.geometry.bvh import MeshBVH as JBVH
    m = meshes[name]
    j, t = JBVH(m.vertices, m.indices), tbvh.MeshBVH(m.vertices, m.indices)
    assert (j.depth, j.leaf_budget, j.n_leaves, j.n_nodes) == \
        (t.depth, t.leaf_budget, t.n_leaves, t.n_nodes)
    np.testing.assert_array_equal(np.asarray(j.lo), t.lo.numpy())
    np.testing.assert_array_equal(np.asarray(j.hi), t.hi.numpy())
    np.testing.assert_array_equal(np.asarray(j.leaf_tris), t.leaf_tris)
    np.testing.assert_array_equal(np.asarray(j.leaf_mask),
                                  t.leaf_mask.numpy())


def _mesh_rays(m, n, seed):
    rng = np.random.RandomState(seed)
    lo, hi = m.vertices.min(0), m.vertices.max(0)
    c, ext = 0.5 * (lo + hi), np.max(hi - lo)
    o = c + ext * rng.uniform(-1.2, 1.2, (n, 3))
    tgt = c + 0.5 * (hi - lo) * rng.uniform(-1, 1, (n, 3))
    d = tgt - o
    return (o.astype(np.float32),
            (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))


@pytest.mark.parametrize("name", ["torus", "field"])
def test_bvh_refit_and_raycast_match_jax_and_brute_force(meshes, name):
    """Refit on deformed vertices equals JAX's bit for bit; the walk's t
    and normals equal JAX's and t the brute-force minimum over every
    triangle."""
    import jax.numpy as jnp
    from newton_tpu.geometry.bvh import MeshBVH as JBVH
    m = meshes[name]
    rng = np.random.RandomState(9)
    v = (m.vertices + 0.02 * rng.randn(*m.vertices.shape)).astype(np.float32)
    j = JBVH(m.vertices, m.indices).refit(jnp.asarray(v))
    t = tbvh.MeshBVH(m.vertices, m.indices).refit(torch.as_tensor(v))
    np.testing.assert_array_equal(np.asarray(j.lo), t.lo.numpy())
    np.testing.assert_array_equal(np.asarray(j.hi), t.hi.numpy())
    o, d = _mesh_rays(m, 400, 10)
    jt_, jn_ = (np.asarray(x) for x in j.raycast(jnp.asarray(v),
                                                 jnp.asarray(o),
                                                 jnp.asarray(d)))
    tt_, tn_ = (x.numpy() for x in t.raycast(torch.as_tensor(v),
                                             torch.as_tensor(o),
                                             torch.as_tensor(d)))
    hit = jt_ < 1e10
    assert hit.sum() > 50 and (~hit).sum() > 20
    np.testing.assert_array_equal(tt_ < 1e10, hit)
    np.testing.assert_allclose(tt_[hit], jt_[hit], rtol=T_TOL, atol=T_TOL)
    np.testing.assert_allclose(tn_[hit], jn_[hit], atol=N_TOL)
    tri = torch.as_tensor(v)[torch.as_tensor(m.indices.reshape(-1, 3)).long()]
    bt, _ = tbvh.ray_triangles(torch.as_tensor(o)[:, None],
                               torch.as_tensor(d)[:, None],
                               tri[None, :, 0], tri[None, :, 1],
                               tri[None, :, 2])
    np.testing.assert_allclose(tt_, bt.amin(1).numpy(), rtol=T_TOL,
                               atol=T_TOL)


def test_ray_triangles_matches_jax():
    import jax.numpy as jnp
    from newton_tpu.geometry.bvh import ray_triangles as j_rt
    rng = np.random.RandomState(2)
    v = rng.randn(3, 300, 3).astype(np.float32)
    o = rng.randn(300, 3).astype(np.float32) * 2
    d = rng.randn(300, 3)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    jt_, jn_ = (np.asarray(x) for x in j_rt(*map(jnp.asarray, (o, d, *v))))
    tt_, tn_ = tbvh.ray_triangles(*map(torch.as_tensor, (o, d, *v)))
    np.testing.assert_allclose(tt_.numpy(), jt_, rtol=T_TOL, atol=T_TOL)
    np.testing.assert_allclose(tn_.numpy(), jn_, atol=N_TOL)


def test_mesh_closest_batches_shapes_as_one_walk(meshes):
    """Two BVHs in one pool, three mesh shapes with transforms and scales:
    each pair equals its shape's walk alone."""
    torus, field = meshes["torus"], meshes["field"]
    bv = [tbvh.MeshBVH(m.vertices, m.indices) for m in (torus, field)]
    pool = tbvh.BVHPool(bv, [m.vertices for m in (torus, field)], "cpu")
    rng = np.random.RandomState(4)
    X = np.c_[rng.uniform(-0.3, 0.3, (3, 3)), rng.randn(3, 4)]
    X[:, 3:] /= np.linalg.norm(X[:, 3:], axis=1, keepdims=True)
    X, sc = (torch.as_tensor(a, dtype=torch.float32)
             for a in (X, [[1, 1, 1], [1.2, 0.7, 1.0], [0.5, 0.5, 0.5]]))
    o, d = (torch.as_tensor(a) for a in _mesh_rays(torus, 200, 3))
    bvh_of = torch.tensor([0, 1, 0], dtype=torch.int32)
    t, n = tbvh.mesh_closest(pool, o, d, bvh_of, X, sc)
    for m in range(3):
        alone = tbvh.BVHPool([bv[int(bvh_of[m])]],
                             [(torus, field)[int(bvh_of[m])].vertices], "cpu")
        ta, na = tbvh.mesh_closest(alone, o, d, torch.zeros(
            1, dtype=torch.int32), X[m:m + 1], sc[m:m + 1])
        assert torch.equal(ta[0], t[m]) and torch.equal(na[0], n[m])
    assert (t < 1e10).any()


# ----------------------------------------------------------------------
# the kernels' bounds (chip_smoke.kernel_cost)
# ----------------------------------------------------------------------
def test_kernel_cost_of_the_ray_casts():
    """K1: 44 B a ray and a classed shape; a pair costs what its class
    needs of the local ray (plane 13, sphere 3, box and capsule 33) plus
    the class's test (1, 17, 26, 39), 113 a ray; K2: rays, shapes, the
    BVH once and 16 B a pair out, 54 FLOPs a pair, 23 a node visited, 52
    a triangle tested."""
    b, f = cs.kernel_cost("raycast_closest", R=10, classes=(1, 2, 3, 4))
    assert b == 10 * 44 + 10 * 44
    assert f == 10 * (14 + 2 * 20 + 3 * 59 + 4 * 72 + 113)
    b, f = cs.kernel_cost("raycast_mesh", R=10, M=2, nodes=100, tris=50,
                          bvh_nodes=7, leaf_slots=16, vertices=9)
    assert b == 240 + 80 + 7 * 24 + 16 * 13 + 9 * 12 + 2 * 10 * 16
    assert f == 20 * 54 + 100 * 23 + 50 * 52
    # the main path: 1,024 planes, 1,024 spheres, 12,288 capsules
    t, by = cs.bound_ms(*cs.kernel_cost(
        "raycast_closest", R=4194304, classes=(1024, 1024, 0, 12288)))
    assert by == "operations" and 57 < t < 58


# ----------------------------------------------------------------------
# on the card: the kernels against their plain twins
# ----------------------------------------------------------------------
@gpu
@pytest.mark.gpu
def test_k1_matches_plain_on_card():
    """K1 equals its plain twin bit for bit on the zoo's analytic shapes
    (primary rays, and rays from the hits toward a light)."""
    m = zoo_scene(nt).finalize("cuda")
    s = m.state()
    X = tray.shape_world_transforms(m, s)
    cls = torch.as_tensor(tray.shape_classes(m), device="cuda")
    o, d = (torch.as_tensor(x, device="cuda") for x in _rays(20000, 5))
    for _ in range(2):
        k = tray.closest_analytic(o, d, X, m.shape_scale, cls, 100.0)
        p = tray.closest_analytic_plain(o, d, X, m.shape_scale, cls, 100.0)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        o = o + d * torch.where(k[1] >= 0, k[0], 0.0)[:, None] \
            + 1e-3 * k[2]
        d = torch.tensor([-0.3, -0.2, 0.9], device="cuda").expand_as(o)
        d = d / d.norm(dim=-1, keepdim=True)


@gpu
@pytest.mark.gpu
def test_k2_matches_plain_on_card():
    """K2 equals its plain twin bit for bit on a terrain mesh under two
    transforms and scales, and the node and triangle counts agree."""
    field = _meshes()["field"]
    bv = tbvh.MeshBVH(field.vertices, field.indices)
    pool = tbvh.BVHPool([bv], [field.vertices], "cuda")
    X = torch.tensor([[0.1, 0.2, 0.0, 0, 0, 0, 1],
                      [0.0, -0.3, 0.1, 0.1, 0.0, 0.0, 0.995]],
                     device="cuda")
    sc = torch.tensor([[1, 1, 1], [1.5, 0.8, 2.0]], dtype=torch.float32,
                      device="cuda")
    o, d = (torch.as_tensor(x, device="cuda")
            for x in _mesh_rays(field, 8192, 6))
    bvh_of = torch.zeros(2, dtype=torch.int32, device="cuda")
    sk, sp = {}, {}
    tk, nk = tbvh.mesh_closest(pool, o, d, bvh_of, X, sc, stats=sk)
    tp, np_ = tbvh.mesh_closest_plain(pool, o, d, bvh_of, X, sc, stats=sp)
    assert torch.equal(tk, tp) and torch.equal(nk, np_) and sk == sp
    assert (tk < 1e10).any()


@gpu
@pytest.mark.gpu
@pytest.mark.parametrize("name", ["field", "deep", "pool"])
def test_k2_walk_matches_plain_on_card(name):
    """K2 equals the plain stack walk bit for bit, with the same node and
    triangle counts, twice: the terrain, a terrain at the depth cap of 12,
    and a pool of two BVHs with different leaf budgets under transforms
    and scales; rays that miss the root, graze, run along the axes or
    start inside the root box (tests/test_torch_bvh_walk.py's cases, on
    the card)."""
    sys.path.insert(0, os.path.dirname(__file__))
    import test_torch_bvh_walk as tw
    pool, (o, d), bvh_of, X, sc = tw._case(name, "cuda", n=800)
    sk, sp = {}, {}
    tk, nk = tbvh.mesh_closest(pool, o, d, bvh_of, X, sc, stats=sk)
    tk2, nk2 = tbvh.mesh_closest(pool, o, d, bvh_of, X, sc)
    tp, np_ = tbvh.mesh_closest_plain(pool, o, d, bvh_of, X, sc, stats=sp)
    assert torch.equal(tk, tp) and torch.equal(nk, np_) and sk == sp
    assert torch.equal(tk2, tp) and torch.equal(nk2, np_)
    assert (tp < 1e10).any() and (tp >= 1e10).any()
