"""Parity: the port's RK4 integrator (``SolverMuJoCo(integrator="rk4")``,
and ``"auto"`` on assets that declare ``<option integrator="RK4">``)
against the JAX package's RK4 and MuJoCo-C's.

RK4 runs four evaluations of the smooth dynamics per substep (FK at the
stage coordinates, explicit joint damping, CRBA and one B1 solve of
``M a = tau`` each); stage 1's ``M^-1`` feeds the contact/limit solve, and
the coordinates advance with the tableau-weighted stage velocities plus
the impulse delta.

Tolerances: the double pendulum (tests/test_parity_mujoco.py:40-54) over
200 steps within 1e-5 rad of MuJoCo-C's RK4 (the JAX package's own gate)
and of the JAX package's RK4; hopper and ant substeps at the ant's
tolerances (joint_q/body_q 2e-4, joint_qd 5e-3); the port's ``step``
against its own ``step_batched`` exactly.
"""

import os

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.utils import bridge

torch.set_num_threads(1)

DOUBLE = """
<mujoco model="double">
  <option gravity="0 0 -9.81" timestep="0.002"/>
  <worldbody>
    <body name="l1" pos="0 0 2">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.05"/>
      <geom type="capsule" fromto="0 0 0 0 0 -0.4" size="0.04"/>
      <body name="l2" pos="0 0 -0.4">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.05"/>
        <geom type="capsule" fromto="0 0 0 0.02 0 -0.35" size="0.03"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""
HOPPER = os.path.join(nt.ASSET_DIR, "hopper.xml")
ANT = os.path.join(nt.ASSET_DIR, "ant.xml")
DT = 1.0 / 240.0


def _port_control(tm, n):
    """Zero targets and forces for n envs (the damping drives read them)."""
    c = tm.control()
    D = tm.structure.joint_dof_count
    return nt.Control(joint_target_q=c.joint_target_q.expand(n, -1).clone(),
                      joint_target_qd=torch.zeros(n, D),
                      joint_f=torch.zeros(n, D), custom={})


def _assert_states(got, ref, q_atol=2e-4, qd_atol=5e-3):
    for name, atol in (("joint_q", q_atol), ("joint_qd", qd_atol),
                       ("body_q", q_atol)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=atol, err_msg=name)


def _np(obj, fields):
    out = {n: np.asarray(getattr(obj, n)) for n in fields}
    out["custom"] = {k: np.asarray(v) for k, v in
                     getattr(obj, "custom", {}).items()}
    return out


def test_double_pendulum_matches_jax_and_mujoco(tmp_path):
    """200 RK4 steps of 2 ms from (1.2, 0.5) rad: the port within 1e-5 rad
    of the JAX package's RK4 and of MuJoCo-C's RK4 at every step, and
    farther than 1e-4 from MuJoCo-C's Euler (the scene tells the two
    integrators apart)."""
    from newton_tpu.utils import parity as P
    T, dt = 200, 0.002
    q0 = np.array([1.2, 0.5])
    mj = P.mujoco_rollout(DOUBLE, T, qpos0=q0, integrator="rk4")
    jm, _ = P.build_newton_model(DOUBLE)
    jx = P.newton_rollout(jm, T, dt, qpos0_mj=q0, collide=False,
                          solver_kwargs={"integrator": "rk4"})
    path = tmp_path / "double.xml"
    path.write_text(DOUBLE)
    b = nt.ModelBuilder()
    b.add_mjcf(str(path))
    tm = b.finalize("cpu")
    solver = nt.SolverMuJoCo(tm, integrator="rk4")
    assert solver.integrator == "rk4"
    s = nt.eval_fk(tm, torch.as_tensor(q0, dtype=torch.float32)[None],
                   torch.zeros(1, 2), nt.batch_state(tm.state(), 1))
    c = _port_control(tm, 1)
    qpos = [q0]
    for _ in range(T):
        s = solver.step_batched(s, None, c, None, dt)
        qpos.append(s.joint_q[0].numpy().astype(np.float64))
    qpos = np.asarray(qpos)
    assert np.abs(qpos - jx.qpos).max() < 1e-5
    assert np.abs(qpos - mj.qpos).max() < 1e-5
    mj_e = P.mujoco_rollout(DOUBLE, T, qpos0=q0, integrator="euler")
    assert np.abs(qpos - mj_e.qpos).max() > 1e-4


@pytest.fixture(scope="module")
def hopper():
    """hopper on both sides, RK4, 8 PGS iterations: the JAX builder given
    MuJoCo's root anchor (the root hinge's pos; reference defect, ROADMAP
    C) and the jitted JAX ``step``."""
    import jax
    import newton_tpu as jt
    from newton_tpu.core.host_math import np_transform
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    jb = jt.ModelBuilder()
    jb.add_mjcf(HOPPER)
    jb.joint_X_p[0] = np_transform([0.0, 0.0, 1.25])
    jb.joint_X_c[0] = np_transform([0.0, 0.0, 0.0])
    jm = jb.finalize()
    js = JSolver(jm, iterations=8, integrator="rk4")

    class NS:
        pass
    ns = NS()
    ns.jm = jm
    b = nt.ModelBuilder()
    b.add_mjcf(HOPPER)
    ns.tm = b.finalize("cpu")
    ns.ts = nt.SolverMuJoCo(ns.tm, iterations=8)
    ns.pipe = nt.CollisionPipeline(ns.tm)
    ns.jpipe = JPipe(jm)
    ns.j_step = jax.jit(lambda s, c, ct: js.step(s, None, c, ct, DT))
    ns.j_collide = jax.jit(ns.jpipe.collide)
    return ns


@pytest.mark.parametrize("substeps", [1, 4])
def test_hopper_step_matches_jax(hopper, substeps):
    """``integrator`` left at "auto" reads the asset's RK4. From q_lin = 0
    and a torso at rest, with the foot tilted onto the plane (contacts
    active) and random ctrl and leg rates, 1 and 4 substeps of the port's
    ``step`` against the JAX package's. Past the first substep the root
    has translated and the JAX subspace's anchor defect (ROADMAP C) moves
    joint_qd by up to 1.4e-3 here (the port with that defect copied
    agrees to 1e-6); a torso started with a velocity leaves the gate."""
    import jax.numpy as jnp
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    assert hopper.ts.integrator == "rk4"
    jm, tm = hopper.jm, hopper.tm
    rng = np.random.RandomState(0)
    q = np.zeros(6, np.float32)
    q[3:5] = rng.uniform(-0.3, 0.0, 2)
    q[5] = 0.6
    qd = (0.2 * rng.randn(6)).astype(np.float32)
    qd[:3] = 0.0
    ctrl = rng.uniform(-1, 1, 3).astype(np.float32)
    js = j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state())
    jc = jm.control()
    jc = jc.replace(custom={**jc.custom, "mjc:ctrl": jnp.asarray(ctrl)})
    ts = nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd), tm.state())
    tc = tm.control()
    tc.custom["mjc:ctrl"] = torch.as_tensor(ctrl)
    for _ in range(substeps):
        contacts = hopper.j_collide(js)
        assert np.asarray(contacts.rigid_contact_mask).any()
        js = hopper.j_step(js, jc, contacts)
        ts = hopper.ts.step(ts, None, tc, hopper.pipe.collide(ts), DT)
    _assert_states(ts, js)


def test_replicated_hopper_step_equals_step_batched():
    """hopper x 4 through ``replicate`` + ``step`` (RK4 read from the
    asset) equals ``step_batched`` of the one-world hopper on the same
    worlds exactly, over 4 substeps with contacts."""
    r = nt.ModelBuilder()
    r.add_mjcf(HOPPER)
    b = nt.ModelBuilder()
    b.replicate(r, 4)
    m = b.finalize("cpu")
    one = r.finalize("cpu")
    sm, so = nt.SolverMuJoCo(m, iterations=8), nt.SolverMuJoCo(one,
                                                                iterations=8)
    assert sm.integrator == so.integrator == "rk4"
    rng = np.random.RandomState(5)
    q = np.zeros((4, 6), np.float32)
    q[:, 1] = rng.uniform(-0.1, 0.0, 4)
    q[:, 3:] = rng.uniform(-0.4, 0.4, (4, 3))
    qd = (0.3 * rng.randn(4, 6)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (4, 3)).astype(np.float32)
    sf = nt.eval_fk(m, torch.as_tensor(q.reshape(-1)),
                    torch.as_tensor(qd.reshape(-1)), m.state())
    cf = m.control()
    cf.custom["mjc:ctrl"] = torch.as_tensor(ctrl.reshape(-1))
    sb = nt.eval_fk(one, torch.as_tensor(q), torch.as_tensor(qd),
                    nt.batch_state(one.state(), 4))
    cb = _port_control(one, 4)
    cb.custom["mjc:ctrl"] = torch.as_tensor(ctrl)
    pf, pb = nt.CollisionPipeline(m), nt.CollisionPipeline(one)
    for _ in range(4):
        sf = sm.step(sf, None, cf, pf.collide(sf), DT)
        sb = so.step_batched(sb, None, cb, pb.collide(sb), DT)
    assert torch.equal(sf.joint_q, sb.joint_q.reshape(-1))
    assert torch.equal(sf.joint_qd, sb.joint_qd.reshape(-1))
    assert torch.equal(sf.body_q, sb.body_q.reshape(-1, 7))


@pytest.fixture(scope="module")
def ant():
    """gymnasium's ant on both sides, RK4, 8 PGS iterations, with the
    jitted JAX batched step and collide."""
    import jax
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    jb = jt.ModelBuilder()
    jb.add_mjcf(ANT)
    jm = jb.finalize()
    js = JSolver(jm, iterations=8, integrator="rk4")

    class NS:
        pass
    ns = NS()
    ns.jm = jm
    b = nt.ModelBuilder()
    b.add_mjcf(ANT)
    ns.tm = b.finalize("cpu")
    ns.ts = nt.SolverMuJoCo(ns.tm, iterations=8)
    ns.pipe = nt.CollisionPipeline(ns.tm)
    ns.j_step = jax.jit(lambda s, c, ct: js.step_batched(s, None, c, ct, DT))
    ns.j_collide = jax.jit(jax.vmap(JPipe(jm).collide))
    return ns


@pytest.mark.parametrize("substeps", [1, 4])
def test_ant_auto_rk4_matches_jax(ant, substeps):
    """gymnasium's ant under ``integrator="auto"`` (its asset declares RK4;
    the stages integrate the free joint from the substep's start): W = 4
    dropped envs with random ctrl, 1 and 4 substeps of ``step_batched``
    against the JAX package's RK4 ``step_batched``."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.parallel import batch_state as j_batch_state
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    Wn = 4
    jm, ts = ant.jm, ant.ts
    assert ts.integrator == "rk4"
    rng = np.random.RandomState(7)
    q = np.tile(np.asarray(jm.joint_q0), (Wn, 1)) \
        + 0.02 * rng.randn(Wn, 15).astype(np.float32)
    q[:, 2] -= 0.06
    qd = (0.1 * rng.randn(Wn, 14)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, (Wn, 8)).astype(np.float32)
    sb = jax.vmap(lambda a, b_, s: j_eval_fk(jm, a, b_, s))(
        jnp.asarray(q), jnp.asarray(qd), j_batch_state(jm.state(), Wn))
    control = jm.control()
    cb = jax.vmap(lambda cv: control.replace(
        custom={**control.custom, "mjc:ctrl": cv}))(jnp.asarray(ctrl))
    s = bridge.state_from_numpy(_np(sb, bridge.STATE_FIELDS), "cpu")
    c = bridge.control_from_numpy(_np(cb, bridge.CONTROL_FIELDS), "cpu")
    assert bool(ant.pipe.collide(s).rigid_contact_mask.any())
    for _ in range(substeps):
        sb = ant.j_step(sb, cb, ant.j_collide(sb))
        s = ts.step_batched(s, None, c, ant.pipe.collide(s), DT)
    _assert_states(s, sb)
