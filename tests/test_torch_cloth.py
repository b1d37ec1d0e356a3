"""The cloth and soft topology, particle-shape contacts and
``SolverStyle3D`` in the port against the JAX package on the CPU: the
builder's cloth grid (each fixed edge, with springs), cloth mesh, seams,
soft grid and soft mesh, bending rest angles, ``replicate``/``add_builder``
of a cloth and the particle-shape candidates; the bridge; the graph
colouring and the hash grid; the soft contacts on every shape type;
Style3D's matvec, its CG and its substeps (plain, with self-contact, with
the garment's soft contacts); the JAX package's Style3D gates on the port.
On a CUDA card: a Style3D substep at the bench cloth's width against the
CPU.

Tolerances: finalize leaves 1e-6 absolute and relative (float32 rounding
of float64 host values); colours and hash-grid candidates exactly; soft
contacts 1e-5; the matvec 1e-5 and 8 CG iterations 1e-4 of their scale
(the CG's dot products sum in another order); ``step``
particle_q 2e-4 and particle_qd 5e-3 (tests/test_batched_step.py:69-75);
the physics gates are tests/test_cloth_solvers.py's.

JAX is imported inside the tests, so the GPU cases collect where JAX is
absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_cloth.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.geometry.hashgrid import HashGrid
from newton_tpu_torch.sim import graph_coloring as t_gc
from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, MODEL_INT_FIELDS
from newton_tpu_torch.utils import bridge

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 24-27)

torch.set_num_threads(1)

DT = 1.0 / 240.0
Q_TOL, QD_TOL = 2e-4, 5e-3
SOFT_STRUCTURE = ("particle_count", "particle_world", "spring_count",
                  "tri_count", "edge_count", "tet_count", "soft_pairs",
                  "soft_contact_max")
SOFT_FIELDS = bridge.SOFT_CONTACT_FIELDS
gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def jax_model_to_numpy(jm):
    leaves = {n: np.asarray(getattr(jm, n))
              for n in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS}
    leaves["custom"] = {k: np.asarray(v) for k, v in jm.custom.items()}
    st = jm.structure
    structure = {n: getattr(st, n) for n in bridge.STRUCTURE_FIELDS}
    au = st.mjc_actuation
    structure["mjc_actuation"] = None if au is None else {
        n: getattr(au, n) for n in bridge.ACTUATION_FIELDS}
    structure["custom_specs"] = {
        k: dict(frequency=s.frequency.value, assignment=s.assignment.value,
                shape=s.shape, default=s.default)
        for k, s in st.custom_specs.items()}
    return leaves, structure


def assert_models_equal(tm, jm):
    for name in MODEL_FLOAT_FIELDS:
        a, b = getattr(tm, name).numpy(), np.asarray(getattr(jm, name))
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6, err_msg=name)
    for name in MODEL_INT_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for name in SOFT_STRUCTURE:
        a, b = getattr(tm.structure, name), getattr(jm.structure, name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


def _mesh(rng, nx=4, ny=3):
    """A small wavy triangle mesh (vertices, faces) from numpy."""
    xs, ys = np.meshgrid(np.arange(nx + 1) * 0.1, np.arange(ny + 1) * 0.1)
    z = 0.03 * rng.standard_normal(xs.shape)
    verts = np.stack([xs, ys, z], -1).reshape(-1, 3)
    idx = np.arange((nx + 1) * (ny + 1)).reshape(ny + 1, nx + 1)
    faces = np.concatenate([
        np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, 1:]], -1),
        np.stack([idx[:-1, :-1], idx[1:, 1:], idx[1:, :-1]], -1)])
    return verts, faces.reshape(-1, 3)


def _tet_mesh(rng):
    """Two unit-ish cubes side by side, five tetrahedra each, some listed
    inverted (the builder flips them), vertices jittered."""
    b_ = []
    for c in range(2):
        for z in (0, 1):
            for y in (0, 1):
                for x in (0, 1):
                    b_.append([x + c, y, z])
    verts = np.asarray(b_, dtype=np.float64) * 0.1
    verts += 0.005 * rng.standard_normal(verts.shape)
    tets = []
    for c in range(2):
        o = 8 * c
        tets += [(o + 0, o + 1, o + 3, o + 5), (o + 0, o + 3, o + 2, o + 6),
                 (o + 0, o + 5, o + 6, o + 4), (o + 3, o + 5, o + 7, o + 6),
                 (o + 0, o + 3, o + 6, o + 5)]
    return verts, np.asarray(tets)


def _scene(lib, kind):
    rng = np.random.default_rng(7)
    b = lib.ModelBuilder()
    if kind.startswith("grid_"):
        flag = kind[5:]
        q = np.array([0.1, 0.2, 0.3, 0.9])
        b.add_cloth_grid(pos=(0.1, -0.2, 1.0), rot=q / np.linalg.norm(q),
                         vel=(0.1, 0.0, -0.2), dim_x=5, dim_y=4, cell_x=0.1,
                         cell_y=0.07, mass=1.5, radius=0.02, tri_ke=300.0,
                         tri_kd=3.0, edge_ke=2.0, edge_kd=0.1,
                         add_springs=flag in ("left", "top"),
                         spring_ke=50.0, spring_kd=0.5,
                         **{"fix_" + flag: True})
    elif kind == "cloth_mesh":
        v, f = _mesh(rng)
        b.add_cloth_mesh(pos=(0.0, 0.0, 0.5), rot=None, vel=(0, 0, 0),
                         vertices=v, indices=f, density=0.3, scale=1.5,
                         edge_ke=3.0)
    elif kind == "garment":
        b, _ = cs.garment_scene(lib)
    elif kind == "soft_grid":
        b.add_soft_grid((0.2, 0.0, 0.5), None, (0, 0, 0), 3, 2, 2, 0.1, 0.12,
                        0.08, density=90.0, k_mu=500.0, k_lambda=800.0,
                        k_damp=1.0, fix_bottom=True, fix_right=True)
    elif kind == "soft_mesh":
        v, t = _tet_mesh(rng)
        b.add_soft_mesh(pos=(0, 0, 1.0), rot=None, vel=(0, 0, 0),
                        vertices=v, indices=t, density=50.0, tri_ke=10.0,
                        tri_ka=10.0, tri_kd=1.0)
    elif kind == "edges":
        pts = rng.uniform(-0.2, 0.2, (12, 3))
        b.add_particles(pts, mass=0.1)
        quads = [(0, 1, 2, 3), (4, 5, 6, 7), (8, 9, 10, 11), (-1, 2, 0, 1),
                 (3, -1, 4, 5), (6, 7, 8, 8)]
        for o0, o1, v0, v1 in quads:
            b.add_edge(o0, o1, v0, v1, edge_ke=5.0)
        b.add_edges([(1, 5, 9, 10), (2, 6, 10, 11)], edge_ke=1.0, rest=0.3)
        b.add_spring(0, 11, ke=40.0, kd=1.0, control=0.8)
        b.add_triangles([(0, 1, 2), (3, 4, 5)], tri_ke=20.0)
        b.add_tetrahedron(0, 1, 2, 3) if np.linalg.det(
            np.stack([pts[1] - pts[0], pts[2] - pts[0], pts[3] - pts[0]],
                     1)) > 0 else b.add_tetrahedron(0, 2, 1, 3)
    elif kind == "replicate":
        sub = cs.small_cloth_scene(lib)
        b.replicate(sub, 3)
        sub2 = lib.ModelBuilder()
        sub2.add_soft_grid((0, 0, 0), None, (0, 0, 0), 1, 1, 1, 0.1, 0.1, 0.1)
        sub2.add_edge(-1, 2, 0, 1, rest=0.5)
        b.replicate(sub2, 2)
        b.add_builder(sub, xform=[0.5, 0.0, 0.2, 0.0, 0.0, 0.38268343,
                                  0.92387953])
        b.add_shape_sphere(-1, xform=[0, 0, 0.3, 0, 0, 0, 1], radius=0.2)
    elif kind == "soft_pairs":
        # particles of two worlds and global ones, shapes in worlds and
        # global, one shape without particle collision
        cfg = b.default_shape_cfg.copy()
        cfg.has_particle_collision = False
        b.add_particle([0, 0, 1.0])
        for w in range(2):
            b.begin_world()
            body = b.add_body(xform=[0.0, w, 0.5, 0, 0, 0, 1])
            b.add_shape_box(body, hx=0.1, hy=0.1, hz=0.1)
            b.add_shape_sphere(-1, xform=[1.0, w, 0.3, 0, 0, 0, 1],
                               radius=0.1)
            b.add_shape_sphere(-1, xform=[2.0, w, 0.3, 0, 0, 0, 1],
                               radius=0.1, cfg=cfg)
            b.add_particles(rng.uniform(-1, 1, (3, 3)), mass=0.2)
            b.end_world()
        b.add_particle([0, 1, 1.0])
        b.add_ground_plane()
    return b


SCENES = ["grid_left", "grid_right", "grid_top", "grid_bottom", "cloth_mesh",
          "garment", "soft_grid", "soft_mesh", "edges", "replicate",
          "soft_pairs"]


@pytest.mark.parametrize("kind", SCENES)
def test_builder_leaves_match_jax(kind):
    """Every finalize leaf of the cloth and soft builder calls, the
    particle-shape candidates and the topology counts: equal to the JAX
    builder's (floats to float32 rounding)."""
    import newton_tpu as jt
    jm = _scene(jt, kind).finalize()
    tm = _scene(nt, kind).finalize("cpu")
    assert_models_equal(tm, jm)


def test_empty_topology_shapes():
    """A model without cloth keeps the JAX package's empty shapes."""
    import newton_tpu as jt
    for lib, dev in ((jt, None), (nt, "cpu")):
        b = lib.ModelBuilder()
        b.add_particle([0.0, 0.0, 1.0])
        m = b.finalize() if dev is None else b.finalize(dev)
        shapes = {n: tuple(getattr(m, n).shape) for n in (
            "spring_indices", "tri_indices", "tri_poses", "tri_materials",
            "edge_indices", "edge_bending_properties", "tet_indices",
            "tet_poses", "tet_materials", "particle_ke")}
        assert shapes == dict(
            spring_indices=(0, 2), tri_indices=(0, 3), tri_poses=(0, 2, 2),
            tri_materials=(0, 5), edge_indices=(0, 4),
            edge_bending_properties=(0, 2), tet_indices=(0, 4),
            tet_poses=(0, 3, 3), tet_materials=(0, 3), particle_ke=()), lib
        assert m.structure.soft_pairs.shape == (0, 2)


def test_bridge_round_trip_cloth():
    """Port -> numpy -> port is exact for a cloth model with soft pairs,
    the JAX model through the bridge equals the port's own finalize, and
    soft contacts go through the bridge both ways."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jm = _scene(jt, "garment").finalize()
    tm = _scene(nt, "garment").finalize("cpu")
    back = bridge.model_from_numpy(*bridge.model_to_numpy(tm), "cpu")
    for name in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS:
        assert torch.equal(getattr(back, name), getattr(tm, name)), name
    for name in SOFT_STRUCTURE:
        a, b = getattr(tm.structure, name), getattr(back.structure, name)
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b), name
    assert_models_equal(bridge.model_from_numpy(*jax_model_to_numpy(jm),
                                                "cpu"), jm)
    jc = JPipe(jm).collide(jm.state())
    tc = bridge.contacts_from_numpy(
        {n: np.asarray(getattr(jc, n))
         for n in bridge.CONTACT_FIELDS + SOFT_FIELDS}, "cpu")
    assert tc.soft_contact_max == jc.soft_contact_max > 0
    d = bridge.contacts_to_numpy(tc)
    for n in SOFT_FIELDS:
        np.testing.assert_array_equal(d[n], np.asarray(getattr(jc, n)))
    # rigid-only dicts (and empty soft fields) give no soft capacity
    rigid = bridge.contacts_from_numpy(
        {n: np.asarray(getattr(jc, n)) for n in bridge.CONTACT_FIELDS}, "cpu")
    assert rigid.soft_contact_max == 0
    assert set(bridge.contacts_to_numpy(rigid)) == set(bridge.CONTACT_FIELDS)


@pytest.mark.parametrize("algo", ["MCS", "GREEDY"])
@pytest.mark.parametrize("graph", ["random", "cloth", "bench_rows"])
def test_color_graph_matches_jax(algo, graph):
    """Colours, their order and the balancing pass: equal to the JAX
    package's; the colouring is valid."""
    from newton_tpu.sim import graph_coloring as j_gc
    rng = np.random.default_rng(3)
    if graph == "random":
        n, edges = 60, rng.integers(0, 60, (200, 2))
    else:
        tm = cs.small_cloth_scene(nt).finalize("cpu") if graph == "cloth" \
            else cs.cloth_bench_scene(nt, 12).finalize("cpu")
        n = tm.particle_count
        edges = tm.tri_indices.numpy()[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
    got = t_gc.color_graph(n, edges, getattr(t_gc.ColoringAlgorithm, algo))
    ref = j_gc.color_graph(n, edges, getattr(j_gc.ColoringAlgorithm, algo))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert t_gc.validate_graph_coloring(edges, got)


def test_coloring_helpers_match_jax():
    from newton_tpu.sim import graph_coloring as j_gc
    tm = cs.small_cloth_scene(nt).finalize("cpu")
    tri = tm.tri_indices.numpy()
    got = t_gc.color_trimesh(tm.particle_count, tri)
    ref = j_gc.color_trimesh(tm.particle_count, tri)
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    edges = tri[:, [0, 1]]
    assert t_gc.validate_graph_coloring(edges, got)
    assert not t_gc.validate_graph_coloring(edges, [np.arange(49)])
    comb = t_gc.combine_independent_particle_coloring(got, got[:2])
    ref = j_gc.combine_independent_particle_coloring(ref, ref[:2])
    assert all(np.array_equal(a, b) for a, b in zip(comb, ref))


@pytest.mark.parametrize("scale,offset,cell", [
    (0.3, 0.0, 0.05), (0.05, 0.0, 0.02), (1.0, 5.0e3, 0.05),
    (1.0, -3.0e5, 0.1), (2.0e4, 0.0, 0.01)])
def test_hashgrid_matches_jax(scale, offset, cell):
    """Candidates, their order and mask: equal to the JAX package's,
    including coordinates whose cells overflow the int32 hash products."""
    import jax.numpy as jnp
    from newton_tpu.geometry.hashgrid import HashGrid as JHash
    from newton_tpu.geometry.hashgrid import neighbor_pairs as j_np
    from newton_tpu_torch.geometry.hashgrid import neighbor_pairs
    rng = np.random.default_rng(int(cell * 1e3))
    x = (rng.uniform(-1, 1, (400, 3)) * scale + offset).astype(np.float32)
    ji, jmask = JHash(cell, max_per_cell=3).query(jnp.asarray(x), cell)
    ti, tmask = HashGrid(cell, max_per_cell=3).query(torch.as_tensor(x), cell)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    hj = JHash(cell)._hash(jnp.floor(jnp.asarray(x) / cell).astype(jnp.int32))
    g = HashGrid(cell)
    np.testing.assert_array_equal(g._hash(g._cell(torch.as_tensor(x))).numpy(),
                                  np.asarray(hj))
    a, b = j_np(jnp.asarray(x), 2 * cell), neighbor_pairs(torch.as_tensor(x),
                                                          2 * cell)
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))


def _contact_scene(lib, dynamic=True, edge_ke=100.0):
    """A cloth over a sphere, a tilted box, a tilted capsule, a cylinder
    (a capsule to the soft contacts), with ``dynamic`` a sphere on a body,
    and the ground."""
    b = lib.ModelBuilder()
    b.add_cloth_grid(pos=(-0.5, -0.5, 0.3), dim_x=8, dim_y=8, cell_x=0.12,
                     cell_y=0.12, mass=1.0, radius=0.05, edge_ke=edge_ke)
    b.add_shape_sphere(-1, xform=[0, 0, 0.2, 0, 0, 0, 1], radius=0.2)
    b.add_shape_box(-1, xform=[0.3, 0.1, 0.25, 0, 0.38268343, 0, 0.92387953],
                    hx=0.2, hy=0.1, hz=0.15)
    b.add_shape_capsule(-1, xform=[-0.3, 0.2, 0.3, 0.38268343, 0, 0,
                                   0.92387953], radius=0.1, half_height=0.2)
    b.add_shape_cylinder(-1, xform=[0.3, -0.3, 0.25, 0, 0, 0, 1], radius=0.1,
                         half_height=0.1)
    if dynamic:
        body = b.add_body(xform=[0.1, -0.3, 0.3, 0, 0, 0, 1])
        b.add_shape_sphere(body, radius=0.15)
    b.add_ground_plane()
    return b


@pytest.mark.parametrize("seed", [0, 1])
def test_collide_soft_matches_jax(seed):
    """Particle-shape contacts on planes, spheres, boxes, capsules and a
    cylinder (a capsule here, as in the JAX package), static and on a
    moving body: within 1e-5 of the JAX pipeline's, slot for slot."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jm = _contact_scene(jt).finalize()
    tm = _contact_scene(nt).finalize("cpu")
    rng = np.random.default_rng(seed)
    q = (np.asarray(jm.particle_q)
         + rng.normal(0, 0.05, (jm.particle_count, 3))).astype(np.float32)
    bq = np.asarray(jm.body_q).copy()
    bq[0, :3] += rng.normal(0, 0.05, 3)
    js = jm.state().replace(particle_q=jnp.asarray(q),
                            body_q=jnp.asarray(bq.astype(np.float32)))
    ts = bridge.state_from_numpy(
        {n: np.asarray(getattr(js, n)) for n in bridge.STATE_FIELDS}, "cpu")
    jc = JPipe(jm).collide(js)
    tc = nt.CollisionPipeline(tm).collide(ts)
    assert tc.soft_contact_max == jc.soft_contact_max == 81 * 6
    for n in SOFT_FIELDS:
        a, b = getattr(tc, n).numpy(), np.asarray(getattr(jc, n))
        if b.dtype.kind in "bi":
            np.testing.assert_array_equal(a, b, err_msg=n)
        else:
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=n)
    assert 20 < int(tc.soft_contact_mask.sum()) < 400
    # the rigid slots are unchanged by the soft pass
    np.testing.assert_array_equal(tc.rigid_contact_mask.numpy(),
                                  np.asarray(jc.rigid_contact_mask))


def test_collide_soft_batched_state_raises():
    tm = _contact_scene(nt).finalize("cpu")
    s = nt.batch_state(tm.state(), 2)
    with pytest.raises(NotImplementedError, match="soft contacts"):
        nt.CollisionPipeline(tm).collide(s)


# ----------------------------------------------------------------------
# Style3D
# ----------------------------------------------------------------------
def _perturbed(jm, seed, dq=0.01, dqd=0.1):
    """The same perturbed particle state on both sides."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    n = jm.particle_count
    q = (np.asarray(jm.particle_q) + dq * rng.standard_normal((n, 3))
         ).astype(np.float32)
    qd = (dqd * rng.standard_normal((n, 3))).astype(np.float32)
    js = jm.state().replace(particle_q=jnp.asarray(q),
                            particle_qd=jnp.asarray(qd))
    ts = bridge.state_from_numpy(
        {n_: np.asarray(getattr(js, n_)) for n_ in bridge.STATE_FIELDS}, "cpu")
    return js, ts


def assert_states_close(t, j, q_tol=Q_TOL, qd_tol=QD_TOL):
    np.testing.assert_allclose(t.particle_q.numpy(), np.asarray(j.particle_q),
                               atol=q_tol, rtol=q_tol)
    np.testing.assert_allclose(t.particle_qd.numpy(),
                               np.asarray(j.particle_qd), atol=qd_tol,
                               rtol=qd_tol)


def run_both(j_solver, t_solver, js, ts, substeps, dt, jpipe=None,
             tpipe=None):
    """``substeps`` substeps of both solvers, each side colliding its own
    state where pipelines are given."""
    import jax
    step = jax.jit(lambda s, c: j_solver.step(s, None, None, c, dt))
    for _ in range(substeps):
        jc = None if jpipe is None else jpipe.collide(js)
        tc = None if tpipe is None else tpipe.collide(ts)
        js = step(js, jc)
        ts = t_solver.step(ts, None, None, tc, dt)
    return js, ts


def test_style3d_constraints_match_jax():
    """Constraint pairs, rest lengths, weights and A's diagonal."""
    import newton_tpu as jt
    from newton_tpu.solvers import SolverStyle3D as JS
    jm = _scene(jt, "grid_left").finalize()
    tm = _scene(nt, "grid_left").finalize("cpu")
    js, ts = JS(jm, iterations=2), nt.SolverStyle3D(tm, iterations=2)
    np.testing.assert_array_equal(ts.ci, js.ci)
    np.testing.assert_allclose(ts.c_rest.numpy(), np.asarray(js.c_rest),
                               rtol=1e-6)
    np.testing.assert_array_equal(ts.c_w, js.c_w)
    np.testing.assert_array_equal(ts._diag(DT).numpy(),
                                  np.asarray(js._diag(DT)))


def test_style3d_apply_A_and_pcg_match_jax():
    """The matrix-free matvec (within 1e-5 of its scale) and 8 CG
    iterations from a warm start on a random right-hand side (1e-4)."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.solvers import SolverStyle3D as JS
    jm = cs.small_cloth_scene(jt).finalize()
    tm = cs.small_cloth_scene(nt).finalize("cpu")
    js, ts = JS(jm), nt.SolverStyle3D(tm)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((49, 3)).astype(np.float32)
    rhs = rng.standard_normal((49, 3)).astype(np.float32) * 1e3
    jd, td = js._diag(DT), ts._diag(DT)
    jw = jnp.asarray(js.c_w, dtype=jnp.float32)
    ref = np.asarray(js._apply_A(jnp.asarray(x), jd, jw))
    got = ts._apply_A(torch.as_tensor(x), td, ts.w).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    ref = np.asarray(js._pcg(jnp.asarray(x), jnp.asarray(rhs), jd, jw, 8))
    got = ts._pcg(torch.as_tensor(x), torch.as_tensor(rhs), td, ts.w,
                  8).numpy()
    # CG's step lengths are ratios of float32 dot products summed in
    # another order: 1e-4 of the scale after 8 iterations
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def _two_layer(lib, radius=0.03, gap=0.004):
    """tests/test_cloth_solvers.py's two overlapping 4 x 4 layers, no
    gravity."""
    b = lib.ModelBuilder()
    b.gravity = 0.0
    for z in (1.0, 1.0 + gap):
        b.add_cloth_grid(pos=(0, 0, z), dim_x=4, dim_y=4, cell_x=0.1,
                         cell_y=0.1, mass=1.0, radius=radius, tri_ke=500.0,
                         edge_ke=2.0)
    return b


@pytest.mark.parametrize("case", ["plain", "self_contact", "garment"])
def test_style3d_steps_match_jax(case):
    """Four substeps from a perturbed state: the test cloth; two
    overlapping layers with self-contact; the garment with its soft
    contacts (each side collides its own state)."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverStyle3D as JS
    kw, dt, pipes = dict(iterations=4), DT, False
    if case == "plain":
        jb, tb = cs.small_cloth_scene(jt), cs.small_cloth_scene(nt)
    elif case == "self_contact":
        jb, tb = _two_layer(jt), _two_layer(nt)
        kw.update(handle_self_contact=True, self_contact_radius=0.06,
                  self_contact_ke=1e4)
    else:
        jb, tb = cs.garment_scene(jt)[0], cs.garment_scene(nt)[0]
        kw = dict(iterations=6, contact_ke=2.0e4)
        dt, pipes = cs.GARMENT_DT, True
    jm, tm = jb.finalize(), tb.finalize("cpu")
    js, ts = _perturbed(jm, 11)
    if case == "garment":
        # move the panels down onto the torso, the front one into it, so
        # that contacts are active
        js = js.replace(particle_q=js.particle_q + jnp_vec(0.0, 0.02, -0.2))
        ts.particle_q = ts.particle_q + torch.tensor([0.0, 0.02, -0.2])
    j_solver, t_solver = JS(jm, **kw), nt.SolverStyle3D(tm, **kw)
    jp = JPipe(jm) if pipes else None
    tp = nt.CollisionPipeline(tm) if pipes else None
    if pipes:
        assert int(tp.collide(ts).soft_contact_mask.sum()) > 0
    if case == "self_contact":
        idx, msk = t_solver._self_pairs(ts.particle_q)
        assert int(msk.sum()) > 0
    j_out, t_out = run_both(j_solver, t_solver, js, ts, 4, dt, jp, tp)
    assert_states_close(t_out, j_out)


def jnp_vec(*v):
    import jax.numpy as jnp
    return jnp.asarray(v, dtype=jnp.float32)


def _roll(solver, state, frames, substeps=8, dt=DT, pipe=None):
    for _ in range(frames * substeps):
        state = solver.step(state, None, None,
                            None if pipe is None else pipe.collide(state), dt)
    return state


def test_cloth_hangs_style3d():
    """test_cloth_hangs[Style3D] on the port (30 frames of 8 substeps,
    iterations 6)."""
    m = cs.small_cloth_scene(nt).finalize("cpu")
    pq = _roll(nt.SolverStyle3D(m, iterations=6), m.state(), 30
               ).particle_q.numpy()
    assert np.isfinite(pq).all()
    fixed = m.particle_inv_mass.numpy() == 0
    np.testing.assert_allclose(pq[fixed, 2], 1.0, atol=1e-4)
    assert pq[~fixed, 2].mean() < 0.98
    assert pq[:, 2].min() > 0.0
    ti = m.tri_indices.numpy()
    assert np.linalg.norm(pq[ti[:, 0]] - pq[ti[:, 1]], axis=-1).max() < 0.25


def _layer_separation(pq):
    n = pq.shape[0] // 2
    return np.linalg.norm(pq[:n, None] - pq[None, n:], axis=-1).min()


def test_style3d_self_collision_separates_layers():
    """test_style3d_self_collision_separates_layers on the port."""
    def run(on):
        m = _two_layer(nt).finalize("cpu")
        s = _roll(nt.SolverStyle3D(m, iterations=4, handle_self_contact=on),
                  m.state(), 10, 4)
        pq = s.particle_q.numpy()
        assert np.isfinite(pq).all()
        return _layer_separation(pq)
    assert run(True) > 0.04
    assert run(False) < 0.02


def test_garment_example_gates():
    """example_cloth_style3d.py on the port for 20 frames: finite, the
    seams pulled together, the garment hanging on the torso."""
    b, (sa, sb) = cs.garment_scene(nt)
    m = b.finalize("cpu")
    s = _roll(nt.SolverStyle3D(m, iterations=6, contact_ke=2.0e4), m.state(),
              20, cs.GARMENT_SUBSTEPS, cs.GARMENT_DT, nt.CollisionPipeline(m))
    q = s.particle_q.numpy()
    assert np.isfinite(q).all()
    assert np.linalg.norm(q[sa] - q[sb], axis=-1).mean() < 0.25
    assert q[:, 2].max() > 0.9


def test_style3d_pcg_converges_on_bench_rhs():
    """The slow test's residual gate at a 40 x 40 cut of the bench cloth:
    8 CG iterations from zero reach 1e-3 relative."""
    m = cs.cloth_bench_scene(nt, 40).finalize("cpu")
    solver = nt.SolverStyle3D(m, iterations=4)
    s = _roll(solver, m.state(), 2, 4)
    diag = solver._diag(DT)
    rhs = diag[:, None] * s.particle_q
    x = solver._pcg(torch.zeros_like(rhs), rhs, diag, solver.w, 8)
    r = rhs - solver._apply_A(x, diag, solver.w)
    assert float(r.norm() / rhs.norm()) < 1e-3


@gpu
def test_style3d_substep_on_card_matches_cpu(cuda):
    """A Style3D substep of the bench cloth on the card against the CPU
    from the same draped state (particle_q 2e-4, particle_qd 5e-3)."""
    b = cs.cloth_bench_scene(nt)
    m_c = b.finalize("cpu")
    s = _roll(nt.SolverStyle3D(m_c, iterations=4), m_c.state(), 1, 4)
    m_d = b.finalize(cuda)
    got = nt.SolverStyle3D(m_d, iterations=4).step(s.to(cuda), None, None,
                                                   None, DT)
    ref = nt.SolverStyle3D(m_c, iterations=4).step(s, None, None, None, DT)
    for n, tol in (("particle_q", Q_TOL), ("particle_qd", QD_TOL)):
        np.testing.assert_allclose(getattr(got, n).cpu().numpy(),
                                   getattr(ref, n).numpy(), atol=tol,
                                   rtol=tol)
