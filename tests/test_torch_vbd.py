"""``SolverVBD``'s particle path and ``SolverSemiImplicit`` in the port
against the JAX package on the CPU: the bending angle forms (dihedral,
three-point with its collinear fallback, the per-row selection); VBD
substeps with and without bending, with self-contact and with soft
contacts; pinned vertices held exactly; the JAX package's VBD gates on
the port; the semi-implicit forces term by term (springs, membrane
triangles, NeoHookean tetrahedra, bending edges, soft contacts) and its
stability gate; the reference's grid-cloth bending behaviour under
SemiImplicit (ROADMAP C.14); a body's contact step under AVBD. On
a CUDA card: a VBD substep at the bench cloth's width against the CPU.

Tolerances: angles 1e-5 and gradients 1e-4 of their scale (float32
cross products of nearly parallel vectors); forces 1e-4 of their scale;
``step`` particle_q 2e-4 and particle_qd 5e-3
(tests/test_batched_step.py:69-75); the physics gates are
tests/test_cloth_solvers.py's.

JAX is imported inside the tests, so the GPU cases collect where JAX is
absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_vbd.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.solvers import solver_vbd as t_vbd
from newton_tpu_torch.utils import bridge

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 24-27)
from test_torch_cloth import (  # noqa: E402
    _contact_scene, _perturbed, _roll, _two_layer, _layer_separation,
    assert_states_close, run_both)

torch.set_num_threads(1)

DT = 1.0 / 240.0
gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _quads(rng, n=64, collinear=False):
    """Bending quads (o0, o1, v0, v1) x 3: random, or collinear triples
    (o0, o1, m, m) with a few exactly straight."""
    p = rng.uniform(-0.1, 0.1, (n, 4, 3))
    if collinear:
        p[:, 3] = p[:, 2]
        p[: n // 4, 1] = 2 * p[: n // 4, 2] - p[: n // 4, 0]   # straight
    return p.astype(np.float32)


@pytest.mark.parametrize("form", ["dihedral", "chain", "select"])
def test_bend_forms_match_jax(form):
    """_dihedral, _chain_bend (the collinear fallback on exactly straight
    triples) and _bend_eval: angles within 1e-5, gradients within 1e-4 of
    their scale."""
    import jax.numpy as jnp
    from newton_tpu.solvers import solver_vbd as j_vbd
    rng = np.random.default_rng(2)
    p = _quads(rng, collinear=form != "dihedral")
    if form == "select":
        p = np.concatenate([p, _quads(rng)])
        is3 = np.arange(len(p)) < len(p) // 2
        ref = j_vbd._bend_eval(jnp.asarray(p), jnp.asarray(is3))
        got = t_vbd._bend_eval(torch.as_tensor(p), torch.as_tensor(is3))
    else:
        fn = "_dihedral" if form == "dihedral" else "_chain_bend"
        ref = getattr(j_vbd, fn)(jnp.asarray(p))
        got = getattr(t_vbd, fn)(torch.as_tensor(p))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    g = np.asarray(ref[1])
    np.testing.assert_allclose(got[1].numpy(), g,
                               atol=1e-4 * np.abs(g).max())
    assert np.isfinite(got[1].numpy()).all()


def _vbd_case(lib, case):
    if case == "no_bending":
        b = lib.ModelBuilder()
        b.add_cloth_grid(pos=(0, 0, 1.0), dim_x=6, dim_y=6, cell_x=0.1,
                         cell_y=0.1, mass=1.0, fix_top=True, tri_ke=500.0,
                         edge_ke=0.0, add_springs=True, spring_ke=80.0)
        return b
    if case == "bending":
        return cs.small_cloth_scene(lib)
    if case == "mesh_bending":
        b = lib.ModelBuilder()
        from test_torch_cloth import _mesh
        v, f = _mesh(np.random.default_rng(4))
        b.add_cloth_mesh(pos=(0.0, 0.0, 1.0), rot=None, vel=(0, 0, 0),
                         vertices=v, indices=f, density=0.5, edge_ke=0.5)
        return b
    if case == "self_contact":
        return _two_layer(lib)
    # static shapes (VBD's rigid bodies with contacts are not ported) and
    # a soft bend: the JAX package's VBD turns chaotic on grid cloth with
    # edge_ke 100 (ROADMAP C.15), where two float32 runs part within
    # substeps
    return _contact_scene(lib, dynamic=False, edge_ke=1.0)


@pytest.mark.parametrize("case", ["no_bending", "bending", "mesh_bending",
                                  "self_contact", "soft_contacts"])
def test_vbd_steps_match_jax(case):
    """Four substeps from a perturbed state: springs and membrane edges
    alone; the grid's three-point bending; a mesh's dihedral bending;
    two overlapping layers with self-contact; a cloth on static shapes
    with soft contacts (each side collides its own state)."""
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverVBD as JV
    import newton_tpu as jt
    kw = dict(iterations=3)
    if case == "self_contact":
        kw.update(handle_self_contact=True, self_contact_radius=0.06,
                  self_contact_ke=1e4)
    jm, tm = _vbd_case(jt, case).finalize(), _vbd_case(nt, case).finalize(
        "cpu")
    js, ts = _perturbed(jm, 13, dq=0.005, dqd=0.05)
    j_solver, t_solver = JV(jm, **kw), nt.SolverVBD(tm, **kw)
    assert [len(c) for c in t_solver.colors] == \
        [len(c) for c in j_solver.colors]
    jp = tp = None
    if case == "soft_contacts":
        jp, tp = JPipe(jm), nt.CollisionPipeline(tm)
        assert int(tp.collide(ts).soft_contact_mask.sum()) > 0
    if case == "self_contact":
        assert int(t_solver._self_pairs(ts.particle_q)[1].sum()) > 0
    j_out, t_out = run_both(j_solver, t_solver, js, ts, 4, DT, jp, tp)
    assert_states_close(t_out, j_out)


def test_vbd_pinned_exactly_in_place():
    """From rest, a pinned vertex's stretch Hessian is singular (its
    eigenvalues 0 / 500 / 1000 on the test cloth): the pinned row stays
    exactly where it was and nothing turns NaN."""
    m = cs.small_cloth_scene(nt).finalize("cpu")
    s0 = m.state()
    s = _roll(nt.SolverVBD(m, iterations=3), s0, 2, 4)
    pinned = m.particle_inv_mass == 0
    assert int(pinned.sum()) == 7
    assert torch.isfinite(s.particle_q).all()
    assert torch.isfinite(s.particle_qd).all()
    assert torch.equal(s.particle_q[pinned], s0.particle_q[pinned])
    assert torch.equal(s.particle_qd[pinned], s0.particle_qd[pinned])


def test_cloth_hangs_vbd():
    """test_cloth_hangs[VBD] on the port (30 frames of 8 substeps,
    iterations 3)."""
    m = cs.small_cloth_scene(nt).finalize("cpu")
    pq = _roll(nt.SolverVBD(m, iterations=3), m.state(), 30
               ).particle_q.numpy()
    assert np.isfinite(pq).all()
    fixed = m.particle_inv_mass.numpy() == 0
    np.testing.assert_allclose(pq[fixed, 2], 1.0, atol=1e-4)
    assert pq[~fixed, 2].mean() < 0.98
    assert pq[:, 2].min() > 0.0
    ti = m.tri_indices.numpy()
    assert np.linalg.norm(pq[ti[:, 0]] - pq[ti[:, 1]], axis=-1).max() < 0.25


def test_vbd_self_collision_separates_layers():
    """test_vbd_self_collision_separates_layers on the port."""
    m = _two_layer(nt).finalize("cpu")

    def run(**kw):
        return _roll(nt.SolverVBD(m, iterations=4, **kw), m.state(), 10, 4
                     ).particle_q.numpy()
    on = run(handle_self_contact=True, self_contact_radius=0.06,
             self_contact_ke=1e4)
    assert np.isfinite(on).all()
    assert _layer_separation(on) > 0.45 * 0.06
    assert _layer_separation(run()) < 0.25 * 0.06


def test_vbd_bending_resists_drape():
    """test_vbd_bending_resists_drape on the port: a stiff sheet hangs
    higher than a floppy one."""
    def droop(edge_ke):
        b = nt.ModelBuilder()
        b.add_cloth_grid(pos=(0, 0, 1.0), dim_x=6, dim_y=6, cell_x=0.1,
                         cell_y=0.1, mass=1.0, fix_top=True, tri_ke=500.0,
                         edge_ke=edge_ke)
        m = b.finalize("cpu")
        pq = _roll(nt.SolverVBD(m, iterations=3), m.state(), 25
                   ).particle_q.numpy()
        assert np.isfinite(pq).all()
        return pq[m.particle_inv_mass.numpy() > 0, 2].mean()
    assert droop(50.0) > droop(0.001) + 0.01


def test_cloth_bending_example_gates():
    """example_cloth_bending.py on the port for its 40 frames: finite, the
    stiff sheet at least as wide as the floppy one, both below their
    pinned rows."""
    b, spans = cs.bending_scene(nt)
    m = b.finalize("cpu")
    q = _roll(nt.SolverVBD(m, iterations=4), m.state(), cs.BENDING_FRAMES,
              4).particle_q.numpy()
    assert np.isfinite(q).all()
    w = [q[s:e, 0].max() - q[s:e, 0].min() for s, e in spans]
    assert w[1] > w[0] - 0.02
    assert q[:, 2].min() < 1.15


def test_vbd_unported_rigid_paths_raise():
    """Bodies without contacts or joints integrate freely, as the JAX
    package's first branch; a body with contacts takes AVBD's block
    solve (ported: the same sphere-on-plane step matches the JAX
    package's, body_q 2e-4, body_qd 5e-3)."""
    import jax.numpy as jnp
    import newton_tpu.solvers as js
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from test_torch_free_bodies import _pair, _port_state

    def scene(lib):
        b = lib.ModelBuilder()
        body = b.add_body(xform=[0, 0, 0.09, 0, 0, 0, 1])
        b.add_shape_sphere(body, radius=0.1)
        b.add_ground_plane()
        return b
    jm, m = _pair(scene)
    solver = nt.SolverVBD(m)
    s = solver.step(m.state(), None, None, None, DT)
    assert float(s.body_qd[0, 2]) < 0.0
    js_ = jm.state().replace(body_qd=jnp.asarray(
        [[0.3, 0, -0.2, 0, 1.0, 0]], jnp.float32))
    ref = js.SolverVBD(jm).step(js_, None, None, JPipe(jm).collide(js_), DT)
    ts = _port_state(js_)
    got = solver.step(ts, None, None, nt.CollisionPipeline(m).collide(ts),
                      DT)
    for name, tol in (("body_q", 2e-4), ("body_qd", 5e-3)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=tol,
                                   rtol=tol, err_msg=name)
    # muscles are ported (SolverSemiImplicit, tests/test_torch_muscle.py)
    assert nt.ModelBuilder().add_muscle([0], [[0, 0, 0]], 1.0, 1.0, 1.0,
                                        1.0, 1.0) == 0


# ----------------------------------------------------------------------
# SemiImplicit
# ----------------------------------------------------------------------
def _semi_scene(lib, term):
    b = lib.ModelBuilder()
    if term == "springs":
        b.add_cloth_grid(pos=(0, 0, 1.0), dim_x=4, dim_y=4, cell_x=0.1,
                         cell_y=0.1, mass=1.0, tri_ke=0.0, tri_kd=0.0,
                         edge_ke=0.0, add_springs=True, spring_ke=200.0,
                         spring_kd=2.0)
    elif term == "triangles":
        b.add_cloth_grid(pos=(0, 0, 1.0), dim_x=4, dim_y=4, cell_x=0.1,
                         cell_y=0.1, mass=1.0, tri_ke=500.0, tri_kd=3.0,
                         edge_ke=0.0)
    elif term == "tets":
        b = cs.soft_grid_scene(lib, 2)
    elif term == "bending":
        from test_torch_cloth import _mesh
        v, f = _mesh(np.random.default_rng(8))
        b.add_cloth_mesh(pos=(0.0, 0.0, 1.0), rot=None, vel=(0, 0, 0),
                         vertices=v, indices=f, density=0.5, tri_ke=0.0,
                         tri_kd=0.0, edge_ke=4.0)
    else:
        b = _contact_scene(lib)
        b.soft_contact_kd = 4.0
    return b


@pytest.mark.parametrize("term", ["springs", "triangles", "tets", "bending",
                                  "contacts"])
def test_semi_implicit_forces_match_jax(term):
    """_particle_forces per term, on a perturbed state: within 1e-4 of
    their scale."""
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverSemiImplicit as JSI
    import newton_tpu as jt
    jm = _semi_scene(jt, term).finalize()
    tm = _semi_scene(nt, term).finalize("cpu")
    js, ts = _perturbed(jm, 17, dq=0.02, dqd=0.3)
    jc = tc = None
    if term == "contacts":
        jc, tc = JPipe(jm).collide(js), nt.CollisionPipeline(tm).collide(ts)
        assert int(tc.soft_contact_mask.sum()) > 0
    ref = np.asarray(JSI(jm)._particle_forces(jm, js, jc))
    got = nt.SolverSemiImplicit(tm)._particle_forces(tm, ts, tc).numpy()
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("scene", ["cloth", "soft_block"])
def test_semi_implicit_steps_match_jax(scene):
    """Twenty substeps at dt 1/2000 (the cloth with bending rows, the
    pinned soft block)."""
    from newton_tpu.solvers import SolverSemiImplicit as JSI
    import newton_tpu as jt
    make = cs.small_cloth_scene if scene == "cloth" else cs.soft_grid_scene
    jm, tm = make(jt).finalize(), make(nt).finalize("cpu")
    js, ts = _perturbed(jm, 19, dq=0.002, dqd=0.05)
    j_out, t_out = run_both(JSI(jm), nt.SolverSemiImplicit(tm), js, ts, 20,
                            cs.SEMI_DT)
    assert_states_close(t_out, j_out)


def test_semi_implicit_stable():
    """test_semi_implicit_stable on the port: 30 frames of 20 substeps at
    dt 1/2000."""
    m = cs.small_cloth_scene(nt).finalize("cpu")
    s = _roll(nt.SolverSemiImplicit(m), m.state(), 30, 20, cs.SEMI_DT)
    assert torch.isfinite(s.particle_q).all()


def test_semi_implicit_soft_block_pinned_and_sags():
    """The soft block for 0.2 s: the pinned face exactly in place, the
    block sagging."""
    m = cs.soft_grid_scene(nt).finalize("cpu")
    s0 = m.state()
    s = _roll(nt.SolverSemiImplicit(m), s0, 20, 20, cs.SEMI_DT)
    pinned = m.particle_inv_mass == 0
    assert int(pinned.sum()) == 25
    assert torch.equal(s.particle_q[pinned], s0.particle_q[pinned])
    sag = float(s0.particle_q[:, 2].min() - s.particle_q[:, 2].min())
    assert 0.001 < sag < 0.6


def test_semi_implicit_grid_cloth_has_no_bending_force():
    """ROADMAP C.14, copied from the JAX package: on the cloth grid's
    collinear bending rows (v0 == v1) the edge vector is zero, the angle
    is atan2(0, 0) = 0 = the rest angle, so edge_ke changes nothing under
    SemiImplicit, on the port as in the JAX package; under VBD it does."""
    from newton_tpu.solvers import SolverSemiImplicit as JSI
    import newton_tpu as jt

    def grid(lib, edge_ke):
        b = lib.ModelBuilder()
        b.add_cloth_grid(pos=(0, 0, 1.0), dim_x=6, dim_y=6, cell_x=0.1,
                         cell_y=0.1, mass=1.0, fix_top=True, tri_ke=500.0,
                         edge_ke=edge_ke)
        return b
    jf, tf = {}, {}
    for ke in (0.0, 50.0):
        jm, tm = grid(jt, ke).finalize(), grid(nt, ke).finalize("cpu")
        js, ts = _perturbed(jm, 23, dq=0.01, dqd=0.1)
        jf[ke] = np.asarray(JSI(jm)._particle_forces(jm, js, None))
        tf[ke] = nt.SolverSemiImplicit(tm)._particle_forces(tm, ts, None)
    np.testing.assert_array_equal(jf[0.0], jf[50.0])
    assert torch.equal(tf[0.0], tf[50.0])
    m0, m1 = grid(nt, 0.0).finalize("cpu"), grid(nt, 50.0).finalize("cpu")
    v0 = _roll(nt.SolverVBD(m0, iterations=3), m0.state(), 5).particle_q
    v1 = _roll(nt.SolverVBD(m1, iterations=3), m1.state(), 5).particle_q
    assert float((v0 - v1).abs().max()) > 1e-3


@gpu
def test_vbd_substep_on_card_matches_cpu(cuda):
    """A VBD substep of the bench cloth on the card against the CPU from
    rest (particle_q 2e-4, particle_qd 5e-3); later states of this cloth
    move metres per frame (ROADMAP C.15), where the two devices' float32
    rounding grows past these tolerances within a substep."""
    b = cs.cloth_bench_scene(nt)
    m_c = b.finalize("cpu")
    s = m_c.state()
    m_d = b.finalize(cuda)
    got = nt.SolverVBD(m_d, iterations=4).step(s.to(cuda), None, None, None,
                                               DT)
    ref = nt.SolverVBD(m_c, iterations=4).step(s, None, None, None, DT)
    for n, tol in (("particle_q", 2e-4), ("particle_qd", 5e-3)):
        np.testing.assert_allclose(getattr(got, n).cpu().numpy(),
                                   getattr(ref, n).numpy(), atol=tol,
                                   rtol=tol)


def test_bridge_state_with_particles():
    """The bridge carries a cloth state's particle fields both ways
    exactly."""
    m = cs.small_cloth_scene(nt).finalize("cpu")
    s = _roll(nt.SolverStyle3D(m, iterations=2), m.state(), 1, 2)
    back = bridge.state_from_numpy(bridge.state_to_numpy(s), "cpu")
    for n in ("particle_q", "particle_qd", "particle_f"):
        assert torch.equal(getattr(back, n), getattr(s, n))
