"""``SolverCoupled`` in the port against the JAX package on the CPU: the
consensus loop with its residuals (tests/test_equality.py:209's particle
blob on a box, SolverXPBD on both sides), the cloth on a ball
(example_coupled_cloth_ball.py, SolverVBD for the particles), the seesaw
(example_mujoco_xpbd_coupled.py, SolverMuJoCo with SolverXPBD), the
head-on pair split between SolverXPBD and SolverMuJoCo by a body
partition (tests/test_equality.py:260) and the mixed tower split between
SolverXPBD and SolverVBD (example_xpbd_vbd_coupled.py); the constructor's
errors and ``init_state``. The JAX package's gates of
tests/test_equality.py (``test_coupled_*``) on the port are in
tests/test_torch_coupled_gates.py. On a CUDA card: a coupled substep on
the card against the CPU and two card runs of it bit for bit.

Each scene runs in the JAX package until its coupling is active (the
contacts touch, the pair meets), hands its state over, and both packages
then step together, every substep held to the tolerances: body_q,
joint_q, particle_q atol = rtol = 2e-4, body_qd, joint_qd, particle_qd
5e-3 (tests/test_batched_step.py:69-75); the residuals 1e-4 relative.

JAX is imported inside the tests, so the GPU cases collect where JAX is
absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_coupled.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phase 53)
from test_torch_free_bodies import _pair, _port_state  # noqa: E402

torch.set_num_threads(1)

QTOL, QDTOL = 2e-4, 5e-3
gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_coupled(lib, m, scene):
    """The scene's SolverCoupled as its example or test builds it, and its
    dt (JAX package: ``lib.solvers``; the port: ``nt``); the phase-53
    scenes' from ``chip_smoke.coupled_solver``."""
    if scene != "blob":
        return cs.coupled_solver(lib, m, scene)
    S = getattr(lib, "solvers", lib)
    return S.SolverCoupled(m, S.SolverXPBD(m, iterations=2),
                           S.SolverXPBD(m, iterations=2),
                           consensus_iters=4), 1.0 / 240.0


SCENES = {"blob": cs.particle_blob_scene,
          "cloth_ball": lambda lib: cs.cloth_ball_scene(lib, 1),
          "seesaw": lambda lib: cs.seesaw_scene(lib, 1),
          "pair": lambda lib: cs.head_on_pair_scene(lib, 1),
          "tower": lambda lib: cs.mixed_tower_scene(lib, 1)}
# (substeps the JAX package runs alone, substeps held together): the blob
# meets the box at substep 77, the cloth the ball at 80 (see
# test_vbd_cloth_on_a_ball_gains_energy), the seesaw's consensus engages
# at 86-87, the pair meets at 72; the tower's boxes touch from the start
WINDOWS = {"blob": (66, 14), "cloth_ball": (78, 6), "seesaw": (82, 16),
           "pair": (66, 12), "tower": (0, 8)}


def _start(lib, m, scene, state):
    """The scene's start state: the pair's +-1 m/s (body and joint
    velocities), the blob's box rising at 1.5 m/s into the particles."""
    qd = np.zeros((m.body_count, 6), np.float32)
    jqd = np.zeros(m.structure.joint_dof_count, np.float32)
    if scene == "pair":
        qd[0::2, 0], qd[1::2, 0] = 1.0, -1.0
        jqd[0::12], jqd[6::12] = 1.0, -1.0
    elif scene == "blob":
        qd[0, 2] = jqd[2] = 1.5
    else:
        return state
    if lib is nt:
        from dataclasses import replace
        return replace(state, body_qd=torch.as_tensor(qd),
                       joint_qd=torch.as_tensor(jqd))
    import jax.numpy as jnp
    return state.replace(body_qd=jnp.asarray(qd), joint_qd=jnp.asarray(jqd))


def _close(tst, jst, what):
    for name, tol in (("body_q", QTOL), ("body_qd", QDTOL),
                      ("joint_q", QTOL), ("joint_qd", QDTOL),
                      ("particle_q", QTOL), ("particle_qd", QDTOL)):
        got = getattr(tst, name)
        if got.numel():
            np.testing.assert_allclose(got.numpy(),
                                       np.asarray(getattr(jst, name)),
                                       atol=tol, rtol=tol,
                                       err_msg=f"{what}: {name}")
    if "coupled:residuals" in jst.custom:
        np.testing.assert_allclose(
            tst.custom["coupled:residuals"].numpy(),
            np.asarray(jst.custom["coupled:residuals"]), rtol=1e-4,
            atol=1e-4 * float(np.abs(np.asarray(
                jst.custom["coupled:residuals"])).max()) + 1e-9,
            err_msg=f"{what}: residuals")


@pytest.mark.parametrize("scene", list(SCENES))
def test_coupled_matches_jax(scene):
    """Each scene's coupled substeps in both packages from the JAX
    package's state once its coupling is active; the consensus scenes
    (blob, cloth on a ball, seesaw) with their per-round residuals,
    particles at a body's surface in the window, and on the seesaw a
    consensus round with a nonzero residual."""
    import jax
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jm, tm = _pair(SCENES[scene])
    jsol, dt = make_coupled(jt, jm, scene)
    tsol, _ = make_coupled(nt, tm, scene)
    jp, tp = JPipe(jm), nt.CollisionPipeline(tm)
    jc, tc = jm.control(), tm.control()
    jst = jsol.init_state(_start(jt, jm, scene, j_eval_fk(
        jm, jm.joint_q0, jm.joint_qd0, jm.state())))
    skip, n = WINDOWS[scene]
    ps = getattr(jsol, "particle_solver", None)
    if getattr(ps, "has_bending", False):
        # the JAX SolverVBD caches its rest angles at its first step, which
        # would leak from the first of two traces: cache them here, eagerly
        import jax.numpy as jnp
        from newton_tpu.solvers.solver_vbd import _bend_eval
        ps._bend_theta0 = _bend_eval(jm.particle_q[ps.edge_idx_safe],
                                     jnp.asarray(ps.bend_3pt))[0]
        ps._bend_ke = jm.edge_bending_properties[:, 0]

    step = jax.jit(lambda s: jsol.step(s, None, jc, jp.collide(s), dt))
    for _ in range(skip):
        jst = step(jst)
    tst = tsol.init_state(_port_state(jst))
    touching, res = 0, 0.0
    for k in range(n):
        jst = step(jst)
        c = tp.collide(tst)
        tst = tsol.step(tst, None, tc, c, dt)
        _close(tst, jst, f"substep {skip + k}")
        if c.soft_contact_max:
            touching = max(touching, int((tsol._slot_dyn
                                          & c.soft_contact_mask).sum()))
            res = max(res, float(tst.custom["coupled:residuals"].max()))
    if scene in ("blob", "cloth_ball", "seesaw"):
        assert touching > 0               # particles at a body's surface
    if scene == "seesaw":
        assert res > 1e-6                 # the consensus engaged
    if scene == "pair":
        assert float(tst.body_qd[0, 0]) < 0.0   # they have collided


def test_vbd_cloth_on_a_ball_gains_energy():
    """Reference defect C.34 (ROADMAP C), pinned: example_coupled_cloth_
    ball.py's cloth under SolverVBD(iterations=2) is flung by the ball it
    lands on. In the JAX package the cloth meets the ball at about 4 m/s
    (substep 80) and its vertices move at more than 8 m/s 20 substeps
    later; the port from the JAX package's state just before contact does
    the same, and its float32 and float64 runs part by more than 0.5 m/s
    there: the contact amplifies rounding, so the packages are held
    together only over the first substeps of contact (the parity test's
    window)."""
    import jax
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers.solver_vbd import _bend_eval
    from newton_tpu_torch.sim.state import map_tensors
    jm, tm = _pair(SCENES["cloth_ball"])
    jsol, dt = make_coupled(jt, jm, "cloth_ball")
    ps = jsol.particle_solver
    ps._bend_theta0 = _bend_eval(jm.particle_q[ps.edge_idx_safe],
                                 jax.numpy.asarray(ps.bend_3pt))[0]
    ps._bend_ke = jm.edge_bending_properties[:, 0]
    jp, jc = JPipe(jm), jm.control()
    step = jax.jit(lambda s: jsol.step(s, None, jc, jp.collide(s), dt))
    s78 = jsol.init_state(jm.state())
    for _ in range(78):
        s78 = step(s78)
    s100 = s78
    for _ in range(22):
        s100 = step(s100)
    assert float(np.abs(np.asarray(s100.particle_qd)).max()) > 8.0
    outs = []
    for f64 in (False, True):
        m = map_tensors(tm, lambda t: t.double() if t.is_floating_point()
                        else t) if f64 else tm
        solver = make_coupled(nt, m, "cloth_ball")[0]
        pipe = nt.CollisionPipeline(m)
        st = _port_state(s78)
        if f64:
            st = map_tensors(st, lambda t: t.double()
                             if t.is_floating_point() else t)
        for _ in range(22):
            st = solver.step(st, None, m.control(), pipe.collide(st), dt)
        outs.append(st.particle_qd.double())
    assert float(outs[0].abs().max()) > 8.0
    assert float((outs[0] - outs[1]).abs().max()) > 0.5


def test_coupled_errors_and_init_state():
    """The JAX package's constructor errors, and ``init_state``'s
    residual buffer (consensus_iters,), zeros, on the state's device."""
    m = cs.head_on_pair_scene(nt, 1).finalize("cpu")
    xp = nt.SolverXPBD(m)
    with pytest.raises(ValueError, match="requires second_rigid_solver"):
        nt.SolverCoupled(m, xp, body_partition=[True, False])
    with pytest.raises(ValueError, match=r"\(body_count,\)"):
        nt.SolverCoupled(m, xp, second_rigid_solver=xp,
                         body_partition=[True])
    with pytest.raises(ValueError, match="needs a particle_solver"):
        nt.SolverCoupled(m, xp)
    s = nt.SolverCoupled(m, xp, xp, consensus_iters=5).init_state(m.state())
    r = s.custom["coupled:residuals"]
    assert r.shape == (5,) and r.dtype == torch.float32 and not r.any()
    s2 = nt.SolverCoupled(m, xp, xp, consensus_iters=0).init_state(s)
    assert s2.custom["coupled:residuals"] is r     # kept where allocated


@gpu
def test_coupled_substep_on_card(cuda):
    """The seesaw and the mixed tower at 4 worlds: 4 substeps on the card
    equal the CPU's at the tolerances; two card runs of a substep are
    equal bit for bit."""
    for scene, make in (("seesaw", cs.seesaw_scene),
                        ("tower", cs.mixed_tower_scene)):
        b = make(nt, 4)
        outs = []
        for dev in (cuda, "cpu"):
            m = b.finalize(dev)
            solver, dt = make_coupled(nt, m, scene)
            pipe = nt.CollisionPipeline(m)
            s = solver.init_state(nt.eval_fk(m, m.joint_q0, m.joint_qd0,
                                             m.state()))
            c = m.control()
            for _ in range(4):
                s = solver.step(s, None, c, pipe.collide(s), dt)
            if dev != "cpu":
                ct = pipe.collide(s)
                a = solver.step(s, None, c, ct, dt)
                a2 = solver.step(s, None, c, ct, dt)
                for f in ("body_q", "body_qd", "particle_q", "particle_qd"):
                    assert torch.equal(getattr(a, f), getattr(a2, f)), f
            outs.append(s.to("cpu"))
        _close(outs[0], outs[1], f"{scene} card vs CPU")
