"""Contact warm start and sleeping in the port against the JAX package on
the CPU: warm impulses (stored in full slot space, block order [n | t1 |
t2] in the port, interleaved per contact in the JAX package's ``step``)
and states over several substeps of ``step`` and ``step_batched``, with
and without top-K compaction; the sleep counters and the frozen worlds;
tests/test_utils.py:139's gate (test_sleep_and_warm_start) on the port's
``assets/ant.xml``; example_mujoco_sleeping.py's gates.

Tolerances: joint_q and body_q atol 2e-4, joint_qd 5e-3, the impulses
1e-3 of their largest (tests/test_batched_step.py:69-75); counters
exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phase 29)

torch.set_num_threads(1)

DT = 1.0 / 240.0
ANT = os.path.join(nt.ASSET_DIR, "ant.xml")
ANT_KW = dict(contact_iterations=4, warm_start=True, sleep_threshold=0.05,
              sleep_steps=8)


def _ant(lib, n=1):
    robot = lib.ModelBuilder()
    robot.add_mjcf(ANT)
    if n == 1:
        return robot
    b = lib.ModelBuilder()
    b.replicate(robot, n)
    return b


def _assert_close(t, j, names=("joint_q", "body_q", "joint_qd")):
    for name in names:
        tol = 5e-3 if name.endswith("qd") else 2e-4
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=tol,
                                   rtol=tol, err_msg=name)


def _lam_blocks(jlam):
    """The JAX step's (n, 3c) interleaved impulses in block order."""
    a = np.asarray(jlam)
    n = a.shape[0]
    return a.reshape(n, -1, 3).transpose(0, 2, 1).reshape(n, -1)


def _kicked(m, seed, n_world):
    """The model's initial coordinates with its roots lowered 0.05 m and
    seeded velocities (the feet in contact from the first substep)."""
    rng = np.random.RandomState(seed)
    nq = m.joint_coord_count // n_world
    q = np.asarray(m.joint_q0.cpu() if torch.is_tensor(m.joint_q0)
                   else m.joint_q0).copy().reshape(n_world, nq)
    q[:, 2] -= 0.05
    qd = 0.3 * rng.randn(m.joint_dof_count).astype(np.float32)
    return q.reshape(-1).astype(np.float32), qd


@pytest.mark.parametrize("cap", [None, 8])
def test_warm_start_step_matches_jax(cap):
    """The ant x 2 through step with warm_start (cap None: its 25 slots
    uncompacted; cap 8: top-8 compaction), 12 substeps: states and the
    stored impulses."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    kw = dict(contact_iterations=4, warm_start=True, contact_cap=cap)
    jm, pm = _ant(jt, 2).finalize(), _ant(nt, 2).finalize("cpu")
    q, qd = _kicked(pm, 0, 2)
    js = jt.solvers.SolverFeatherstone(jm, **kw)
    ps = nt.SolverFeatherstone(pm, **kw)
    a = js.init_state(eval_fk(jm, jnp.asarray(q), jnp.asarray(qd),
                              jm.state()))
    b = ps.init_state(nt.eval_fk(pm, torch.as_tensor(q), torch.as_tensor(qd),
                                 pm.state()))
    assert sorted(a.custom) == sorted(b.custom)
    jp, pp = JPipe(jm), nt.CollisionPipeline(pm)
    step = jax.jit(lambda s: js.step(s, None, jm.control(), jp.collide(s),
                                     DT))
    peak = 0.0
    for _ in range(12):
        a = step(a)
        b = ps.step(b, None, pm.control(), pp.collide(b), DT)
        lj = _lam_blocks(a.custom["contact:lam:0"])
        lp = b.custom["contact:lam:0"].numpy()
        peak = max(peak, float(np.abs(lj).max()))
        np.testing.assert_allclose(lp, lj, atol=1e-3 * max(peak, 1e-6))
    assert peak > 0
    _assert_close(b, a)


def test_warm_start_step_batched_matches_jax():
    """The one-world ant, 4 envs through step_batched with warm_start and
    top-8 compaction against the JAX package's batched path, 10
    substeps; its stored impulses (W, 1, 3c) are block-ordered in both."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.parallel.envs import batch_state as jbatch
    from newton_tpu.sim.articulation import eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    kw = dict(contact_iterations=4, warm_start=True, contact_cap=8)
    jm, pm = _ant(jt).finalize(), _ant(nt).finalize("cpu")
    W = 4
    rng = np.random.RandomState(5)
    q = np.tile(np.asarray(pm.joint_q0), (W, 1))
    q[:, 2] -= 0.05
    qd = (0.3 * rng.randn(W, pm.joint_dof_count)).astype(np.float32)
    js = jt.solvers.SolverFeatherstone(jm, **kw)
    ps = nt.SolverFeatherstone(pm, **kw)
    a = jbatch(js.init_state(eval_fk(jm, jm.joint_q0, jm.joint_qd0,
                                     jm.state())), W)
    a = jax.vmap(lambda s, x, v: eval_fk(jm, x, v, s))(
        a, jnp.asarray(q), jnp.asarray(qd))
    b = nt.batch_state(ps.init_state(nt.eval_fk(pm, pm.joint_q0,
                                                pm.joint_qd0, pm.state())), W)
    b = nt.eval_fk(pm, torch.as_tensor(q), torch.as_tensor(qd), b)
    jp, pp = JPipe(jm), nt.CollisionPipeline(pm)
    jc = jax.vmap(jp.collide)
    step = jax.jit(lambda s: js.step_batched(s, None, None, jc(s), DT))
    peak = 0.0
    for _ in range(10):
        a = step(a)
        b = ps.step_batched(b, None, None, pp.collide(b), DT)
        lj = np.asarray(a.custom["contact:lam:0"])
        lp = b.custom["contact:lam:0"].numpy()
        assert lp.shape == lj.shape
        peak = max(peak, float(np.abs(lj).max()))
        np.testing.assert_allclose(lp, lj, atol=1e-3 * max(peak, 1e-6))
    assert peak > 0
    _assert_close(b, a)


def test_sleep_counters_and_freeze_match_jax():
    """example_mujoco_sleeping.py's boxes x 2 through step for 60
    substeps: the counters equal the JAX package's and asleep worlds keep
    their poses bit for bit from one substep to the next."""
    import jax
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    kw = dict(sleep_threshold=0.12, sleep_steps=8)
    jm = cs.sleeping_scene(jt, 2).finalize()
    pm = cs.sleeping_scene(nt, 2).finalize("cpu")
    js, ps = jt.solvers.SolverFeatherstone(jm, **kw), \
        nt.SolverFeatherstone(pm, **kw)
    a = js.init_state(eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state()))
    b = ps.init_state(nt.eval_fk(pm, pm.joint_q0, pm.joint_qd0, pm.state()))
    jp, pp = JPipe(jm), nt.CollisionPipeline(pm)
    step = jax.jit(lambda s: js.step(s, None, jm.control(), jp.collide(s),
                                     DT))
    asleep_seen = False
    for _ in range(60):
        a = step(a)
        prev = b
        b = ps.step(b, None, pm.control(), pp.collide(b), DT)
        np.testing.assert_array_equal(b.custom["sleep:count:0"].numpy(),
                                      np.asarray(a.custom["sleep:count:0"]))
        asleep = (prev.custom["sleep:count:0"] >= 8) & \
            (b.custom["sleep:count:0"] >= 8)
        if bool(asleep.any()):
            asleep_seen = True
            rows = ps.groups[0].tables.row_body[asleep]
            assert torch.equal(b.body_q[rows], prev.body_q[rows])
            assert float(b.body_qd[rows].abs().max()) == 0.0
    assert asleep_seen
    _assert_close(b, a)


def test_sleep_step_batched_needs_counters():
    m = _ant(nt).finalize("cpu")
    solver = nt.SolverFeatherstone(m, sleep_threshold=0.05)
    s = nt.batch_state(nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state()), 2)
    with pytest.raises(ValueError, match="init_state"):
        solver.step_batched(s, None, None, None, DT)
    # step allocates them lazily, as the JAX package's
    s1 = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    out = solver.step(s1, None, m.control(), None, DT)
    assert "sleep:count:0" in out.custom


def test_joint_f_wakes_a_world():
    """A world quiet for sleep_steps sleeps; joint_f on its dofs resets
    its counter (the wake test reads control.joint_f only)."""
    m = cs.sleeping_scene(nt, 1).finalize("cpu")
    solver = nt.SolverFeatherstone(m, sleep_threshold=0.12, sleep_steps=8)
    pipe = nt.CollisionPipeline(m)
    s = solver.init_state(nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state()))
    ctl = m.control()
    for _ in range(60):
        s = solver.step(s, None, ctl, pipe.collide(s), DT)
    assert int(s.custom["sleep:count:0"][0]) >= 8
    ctl.joint_f[2] = 1.0
    s = solver.step(s, None, ctl, pipe.collide(s), DT)
    assert int(s.custom["sleep:count:0"][0]) == 0


def test_sleep_and_warm_start_gate():
    """tests/test_utils.py:139 on the port's assets/ant.xml: 60 frames of
    4 substeps with warm start and sleeping; finite, 0.3 < root z < 0.8."""
    m = _ant(nt).finalize("cpu")
    solver = nt.SolverFeatherstone(m, **ANT_KW)
    pipe = nt.CollisionPipeline(m)
    s = solver.init_state(nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state()))
    assert "sleep:count:0" in s.custom and "contact:lam:0" in s.custom
    ctrl = m.control()
    for _ in range(60 * 4):
        s = solver.step(s, None, ctrl, pipe.collide(s), DT)
    assert np.isfinite(s.joint_q.numpy()).all()
    assert 0.3 < float(s.joint_q[2]) < 0.8


def test_sleeping_example_gates():
    """example_mujoco_sleeping.py's test_final on the port (its 60
    frames)."""
    m = cs.sleeping_scene(nt, 1).finalize("cpu")
    solver = nt.SolverFeatherstone(m, sleep_threshold=0.12, sleep_steps=8)
    pipe = nt.CollisionPipeline(m)
    s = solver.init_state(nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state()))
    ctl = m.control()
    for _ in range(60 * 4):
        s = solver.step(s, None, ctl, pipe.collide(s), DT)
    assert int((s.custom["sleep:count:0"] >= 8).sum()) >= 1
    assert float(s.body_qd.abs().max()) < 0.12 + 0.3
    assert float((s.body_q[:, 2] - 0.2).abs().max()) < 0.03
    assert torch.isfinite(s.body_q).all()
