#!/usr/bin/env python3
"""The errors behind the CPU gates of the planar robots and RK4 on the port.

    JAX_PLATFORMS=cpu python3 tools/torch_planar_parity.py [--out FILE]

Runs, on the CPU, the comparisons that tests/test_torch_planar.py and
tests/test_torch_rk4.py assert, and prints the measured errors instead of
a pass: one JSON object with
  - the double pendulum, 200 RK4 steps: max |dq| of the port against the
    JAX package's RK4 and MuJoCo-C's RK4, and of the JAX package against
    MuJoCo-C's RK4;
  - the hopper (RK4) after 1 and 4 substeps of ``step`` and the ant (RK4,
    W = 4) after 1 and 4 substeps of ``step_batched``, port against JAX:
    max |d joint_q|, |d joint_qd|, |d body_q|;
  - one half_cheetah euler substep (W = 8) from q_lin = 0, port against
    JAX;
  - translation invariance of half_cheetah after 4 substeps (port) and
    the JAX package's velocity difference after one substep;
  - hopper and walker2d against MuJoCo-C over 300 steps, euler and RK4:
    qpos RMS and the settled contact-force sums.
It needs jax, mujoco and the test modules beside it (tests/).
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]


def _maxdiff(got, ref):
    import numpy as np
    return {name: float(np.abs(getattr(got, name).numpy()
                               - np.asarray(getattr(ref, name))).max())
            for name in ("joint_q", "joint_qd", "body_q")}


def double_pendulum():
    import tempfile
    import numpy as np
    import torch
    import newton_tpu_torch as nt
    from newton_tpu.utils import parity as P
    import test_torch_rk4 as R
    T, dt, q0 = 200, 0.002, np.array([1.2, 0.5])
    mj = P.mujoco_rollout(R.DOUBLE, T, qpos0=q0, integrator="rk4")
    jm, _ = P.build_newton_model(R.DOUBLE)
    jx = P.newton_rollout(jm, T, dt, qpos0_mj=q0, collide=False,
                          solver_kwargs={"integrator": "rk4"})
    with tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False) as f:
        f.write(R.DOUBLE)
    b = nt.ModelBuilder()
    b.add_mjcf(f.name)
    os.unlink(f.name)
    tm = b.finalize("cpu")
    solver = nt.SolverMuJoCo(tm, integrator="rk4")
    s = nt.eval_fk(tm, torch.as_tensor(q0, dtype=torch.float32)[None],
                   torch.zeros(1, 2), nt.batch_state(tm.state(), 1))
    c = R._port_control(tm, 1)
    q = [q0]
    for _ in range(T):
        s = solver.step_batched(s, None, c, None, dt)
        q.append(s.joint_q[0].numpy().astype(np.float64))
    q = np.asarray(q)
    return dict(port_vs_jax=float(np.abs(q - jx.qpos).max()),
                port_vs_mujoco=float(np.abs(q - mj.qpos).max()),
                jax_vs_mujoco=float(np.abs(jx.qpos - mj.qpos).max()))


def hopper_rk4():
    import jax.numpy as jnp
    import numpy as np
    import torch
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    import newton_tpu_torch as nt
    import test_torch_rk4 as R
    h = R.hopper.__wrapped__()
    out = {}
    for substeps in (1, 4):
        rng = np.random.RandomState(0)
        q = np.zeros(6, np.float32)
        q[3:5] = rng.uniform(-0.3, 0.0, 2)
        q[5] = 0.6
        qd = (0.2 * rng.randn(6)).astype(np.float32)
        qd[:3] = 0.0
        ctrl = rng.uniform(-1, 1, 3).astype(np.float32)
        js = j_eval_fk(h.jm, jnp.asarray(q), jnp.asarray(qd), h.jm.state())
        jc = h.jm.control()
        jc = jc.replace(custom={**jc.custom, "mjc:ctrl": jnp.asarray(ctrl)})
        ts = nt.eval_fk(h.tm, torch.as_tensor(q), torch.as_tensor(qd),
                        h.tm.state())
        tc = h.tm.control()
        tc.custom["mjc:ctrl"] = torch.as_tensor(ctrl)
        for _ in range(substeps):
            js = h.j_step(js, jc, h.j_collide(js))
            ts = h.ts.step(ts, None, tc, h.pipe.collide(ts), R.DT)
        out[f"{substeps} substeps"] = _maxdiff(ts, js)
    return out


def ant_rk4():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from newton_tpu.parallel import batch_state as j_batch_state
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu_torch.utils import bridge
    import test_torch_rk4 as R
    a = R.ant.__wrapped__()
    out = {}
    for substeps in (1, 4):
        rng = np.random.RandomState(7)
        q = np.tile(np.asarray(a.jm.joint_q0), (4, 1)) \
            + 0.02 * rng.randn(4, 15).astype(np.float32)
        q[:, 2] -= 0.06
        qd = (0.1 * rng.randn(4, 14)).astype(np.float32)
        ctrl = rng.uniform(-1, 1, (4, 8)).astype(np.float32)
        sb = jax.vmap(lambda x, y, s: j_eval_fk(a.jm, x, y, s))(
            jnp.asarray(q), jnp.asarray(qd), j_batch_state(a.jm.state(), 4))
        control = a.jm.control()
        cb = jax.vmap(lambda cv: control.replace(
            custom={**control.custom, "mjc:ctrl": cv}))(jnp.asarray(ctrl))
        s = bridge.state_from_numpy(R._np(sb, bridge.STATE_FIELDS), "cpu")
        c = bridge.control_from_numpy(R._np(cb, bridge.CONTROL_FIELDS), "cpu")
        for _ in range(substeps):
            sb = a.j_step(sb, cb, a.j_collide(sb))
            s = a.ts.step_batched(s, None, c, a.pipe.collide(s), R.DT)
        out[f"{substeps} substeps"] = _maxdiff(s, sb)
    return out


def cheetah():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from newton_tpu.parallel import batch_state as j_batch_state
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu_torch.utils import bridge
    import test_torch_planar as T
    ch = T.cheetah.__wrapped__()
    jm = ch.jm
    q, qd = T._cheetah_coords(1)
    sb = jax.vmap(lambda a, b, s: j_eval_fk(jm, a, b, s))(
        jnp.asarray(q), jnp.asarray(qd), j_batch_state(jm.state(), T.W))
    ctrl = np.random.RandomState(2).uniform(-1, 1, (T.W, 6)) \
        .astype(np.float32)
    control = jm.control()
    cb = jax.vmap(lambda cv: control.replace(
        custom={**control.custom, "mjc:ctrl": cv}))(jnp.asarray(ctrl))
    contacts = ch.j_collide(sb)
    ref = ch.j_step(sb, cb, contacts)
    got = ch.ts.step_batched(
        bridge.state_from_numpy(T._np(sb, bridge.STATE_FIELDS), "cpu"), None,
        bridge.control_from_numpy(T._np(cb, bridge.CONTROL_FIELDS), "cpu"),
        bridge.contacts_from_numpy(T._np(contacts, bridge.CONTACT_FIELDS),
                                   "cpu"), T.DT)
    ctrl = np.random.RandomState(4).uniform(-1, 1, (T.W, 6)) \
        .astype(np.float32)
    runs = []
    for shift in (0.0, 5.0):
        q, qd = T._cheetah_coords(3, shift, pitch_rate=3.0)
        runs.append(T._cheetah_run(ch.tm, ch.ts, ch.pipe, q, qd, ctrl, 4))
    qa, qb = runs[0].joint_q.clone(), runs[1].joint_q.clone()
    qb[:, 0] -= 5.0
    cb = jax.vmap(lambda cv: control.replace(
        custom={**control.custom, "mjc:ctrl": cv}))(jnp.asarray(ctrl))
    jqd = []
    for shift in (0.0, 5.0):
        q, qd = T._cheetah_coords(3, shift, pitch_rate=3.0)
        s = jax.vmap(lambda a, b, s: j_eval_fk(jm, a, b, s))(
            jnp.asarray(q), jnp.asarray(qd), j_batch_state(jm.state(), T.W))
        jqd.append(np.asarray(ch.j_step(s, cb, ch.j_collide(s)).joint_qd))
    return dict(
        substep_vs_jax=_maxdiff(got, ref),
        active_contacts=int(np.asarray(contacts.rigid_contact_mask).sum()),
        shift_port_4_substeps=dict(
            joint_q=float((qa - qb).abs().max()),
            joint_qd=float((runs[0].joint_qd - runs[1].joint_qd).abs()
                           .max())),
        shift_jax_1_substep_joint_qd=float(np.abs(jqd[0] - jqd[1]).max()))


def mujoco_gates():
    import mujoco
    import numpy as np
    from newton_tpu.utils import parity as P
    import test_torch_planar as T
    out = {}
    for robot in ("hopper", "walker2d"):
        for integ in ("euler", "rk4"):
            mjm = mujoco.MjModel.from_xml_path(T._xml(robot))
            qpos0 = mjm.qpos0.copy()
            qpos0[1] += 0.1
            mj = P.mujoco_rollout(T._xml(robot), 300, qpos0=qpos0,
                                  integrator=integ)
            qpos, force = T._port_rollout(robot, qpos0, 300, integ)
            out[f"{robot} {integ}"] = dict(
                qpos_rms=float(np.sqrt(np.mean((mj.qpos - qpos) ** 2))),
                force_mujoco=float(np.mean(mj.contact_normal_force[-10:])),
                force_port=float(np.mean(force[-10:])))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON object here")
    a = ap.parse_args()
    import torch
    torch.set_num_threads(1)
    res = dict(double_pendulum=double_pendulum(), hopper_rk4=hopper_rk4(),
               ant_rk4=ant_rk4(), half_cheetah=cheetah(),
               mujoco=mujoco_gates())
    line = json.dumps(res)
    print(line)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
