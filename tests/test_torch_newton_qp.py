"""Parity: the port's contact and limit options of the generalized solver
against the JAX package's: the active-set Newton QP on pyramid facets
(``contact_solver="newton"``, ``SolverMuJoCo(solver="newton"|"cg")``),
penalty joint limits (``limit_mode="penalty"``) and
``apply_body_forces=False``.

Tolerances: ant substeps at the ant's (joint_q/body_q 2e-4, joint_qd
5e-3, tests/test_batched_step.py:69-75); the resting ball at the JAX
package's own gates (tests/test_parity_mujoco.py:188): the mean normal
force over the last 10 steps within 1% of the weight, z within 2e-3 of the
radius.
"""

import os

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.utils import bridge

torch.set_num_threads(1)

ANT = os.path.join(nt.ASSET_DIR, "ant.xml")
DT = 1.0 / 240.0
W = 4
BALL = """
<mujoco model="ball">
  <option gravity="0 0 -9.81" timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body name="ball" pos="0 0 0.25">
      <freejoint/>
      <geom type="sphere" size="0.1" density="1000"/>
    </body>
  </worldbody>
</mujoco>
"""


def _np(obj, fields):
    out = {n: None if getattr(obj, n, None) is None
           else np.asarray(getattr(obj, n)) for n in fields}
    out["custom"] = {k: np.asarray(v) for k, v in
                     getattr(obj, "custom", {}).items()}
    return out


def _assert_states(got, ref, q_atol=2e-4, qd_atol=5e-3):
    for name, atol in (("joint_q", q_atol), ("joint_qd", qd_atol),
                       ("body_q", q_atol)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=atol, err_msg=name)


@pytest.fixture(scope="module")
def ant():
    """gymnasium's ant on both sides: dropped envs with random ctrl and
    body wrenches, the batched JAX collide."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.parallel import batch_state as j_batch_state
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jb = jt.ModelBuilder()
    jb.add_mjcf(ANT)
    jm = jb.finalize()
    b = nt.ModelBuilder()
    b.add_mjcf(ANT)
    tm = b.finalize("cpu")
    rng = np.random.RandomState(3)
    q = np.tile(np.asarray(jm.joint_q0), (W, 1)) \
        + 0.05 * rng.randn(W, 15).astype(np.float32)
    q[:, 2] -= 0.06
    qd = (0.3 * rng.randn(W, 14)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (W, 8)).astype(np.float32)
    sb = jax.vmap(lambda a, b_, s: j_eval_fk(jm, a, b_, s))(
        jnp.asarray(q), jnp.asarray(qd), j_batch_state(jm.state(), W))
    body_f = (5.0 * rng.randn(W, 13, 6)).astype(np.float32)
    sb = sb.replace(body_f=jnp.asarray(body_f))
    control = jm.control()
    cb = jax.vmap(lambda cv: control.replace(
        custom={**control.custom, "mjc:ctrl": cv}))(jnp.asarray(ctrl))

    class NS:
        pass
    ns = NS()
    ns.jm, ns.tm, ns.sb, ns.cb = jm, tm, sb, cb
    ns.s = bridge.state_from_numpy(_np(sb, bridge.STATE_FIELDS), "cpu")
    ns.c = bridge.control_from_numpy(_np(cb, bridge.CONTROL_FIELDS), "cpu")
    ns.pipe = nt.CollisionPipeline(tm)
    ns.j_collide = jax.jit(jax.vmap(JPipe(jm).collide))
    return ns


@pytest.mark.parametrize("kw", [
    dict(solver="newton"),
    dict(limit_mode="penalty", apply_body_forces=False),
], ids=["newton_qp", "penalty_no_body_forces"])
def test_ant_options_match_jax(ant, kw):
    """Two substeps of W = 4 dropped ant envs (contacts active, random
    ctrl and body wrenches) under ``SolverMuJoCo(iterations=8,
    integrator="euler", **kw)``, the port's ``step_batched`` against the
    JAX package's (the vmapped per-env ``step`` for the Newton QP, the
    batched fast path for the PGS options)."""
    import jax
    from newton_tpu.solvers import SolverFeatherstone as JFeather
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    if "solver" in kw:
        js = JSolver(ant.jm, iterations=8, integrator="euler", **kw)
    else:
        # the JAX SolverMuJoCo drops apply_body_forces with a warning; its
        # base takes it
        js = JFeather(ant.jm, contact_iterations=8, integrator="euler", **kw)
    ts = nt.SolverMuJoCo(ant.tm, iterations=8, integrator="euler", **kw)
    j_step = jax.jit(lambda s, c, ct: js.step_batched(s, None, c, ct, DT))
    sb, s = ant.sb, ant.s
    rec = {}
    for _ in range(2):
        sb = j_step(sb, ant.cb, ant.j_collide(sb))
        s = ts.step_batched(s, None, ant.c, ant.pipe.collide(s), DT,
                            record=rec)
    _assert_states(s, sb)
    if kw.get("limit_mode") == "penalty":
        # the limit rows leave the impulse solve: B2 at (25, 0, 14)
        args, k = rec["pgs"]
        assert k["ld"].numel() == 0 and args[3].shape[1] == 75
    else:
        assert "newton_H" in rec and rec["newton_H"][0].shape == (W, 116, 116)


def test_body_forces_move_the_ant(ant):
    """The same substep with and without ``apply_body_forces`` differs (the
    wrenches reach tau only with it), so the option is exercised."""
    outs = []
    for flag in (True, False):
        ts = nt.SolverMuJoCo(ant.tm, iterations=8, integrator="euler",
                             apply_body_forces=flag)
        outs.append(ts.step_batched(ant.s, None, ant.c,
                                    ant.pipe.collide(ant.s), DT).joint_qd)
    assert (outs[0] - outs[1]).abs().max() > 1e-3


def test_resting_ball_newton_force(tmp_path):
    """The JAX package's resting-ball gate on the port: 300 steps of 2 ms
    under ``contact_solver="newton"``; the normal impulse over dt averaged
    over the last 10 steps equals the weight within 1%, z the radius within
    2e-3."""
    path = tmp_path / "ball.xml"
    path.write_text(BALL)
    b = nt.ModelBuilder()
    b.add_mjcf(str(path))
    m = b.finalize("cpu")
    solver = nt.SolverMuJoCo(m, integrator="euler", solver="newton")
    assert solver.contact_solver == "newton"
    pipe = nt.CollisionPipeline(m)
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    ctl = m.control()
    dt = 0.002
    forces = []
    for _ in range(300):
        rec = {}
        s = solver.step(s, None, ctl, pipe.collide(s), dt, record=rec)
        c = rec["pgs"][1]["c"]
        forces.append(float(rec["lam"][0, :c].sum()) / dt)
    weight = 1000 * 4 / 3 * np.pi * 0.1 ** 3 * 9.81
    assert abs(np.mean(forces[-10:]) - weight) < 0.01 * weight
    assert abs(float(s.joint_q[2]) - 0.1) < 2e-3


def test_solver_option_mapping():
    """``SolverMuJoCo(solver="cg", ls_iterations=12)`` maps as the JAX
    package's: the Newton QP with max(8, 12) iterations; ``"newton"``
    without ls_iterations keeps 8; the other stored options are taken and
    an unknown keyword raises."""
    import newton_tpu as jt
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    jb = jt.ModelBuilder()
    jb.add_mjcf(ANT)
    jm = jb.finalize()
    b = nt.ModelBuilder()
    b.add_mjcf(ANT)
    tm = b.finalize("cpu")
    for kw in (dict(solver="cg", ls_iterations=12),
               dict(solver="newton", ls_iterations=4),
               dict(solver="newton"), dict(solver="pgs")):
        j, t = JSolver(jm, **kw), nt.SolverMuJoCo(tm, **kw)
        assert (t.contact_solver, t.newton_iterations) == \
            (j.contact_solver, j.newton_iterations)
    t = nt.SolverMuJoCo(tm, angular_damping=0.1,
                        update_mass_matrix_interval=2)
    assert (t.angular_damping, t.update_mass_matrix_interval) == (0.1, 2)
    with pytest.raises(TypeError):
        nt.SolverMuJoCo(tm, pgs_backend="xla")
