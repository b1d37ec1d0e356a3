"""The slice's main path (``chip_smoke.py`` phase 54) on two ants for 5
frames in both packages (the legs press on the ground from the fourth),
its world reset moved from frame 20 to frame 2 (world 0 is reset
there): the port's ``chip_smoke.PolicyAnt`` against the
same loop written with the JAX package's ArticulationView, SensorIMU,
SensorContact, OnnxModule, Actuator, ControllerPD, ClampMaxEffort,
SolverMuJoCo.step_with_contacts, reset and masked FK, from the same
policy bytes. Tolerances: the first frame's observation and action 1e-5
(absolute and relative); joint_q 2e-4 and joint_qd 5e-3 after every
frame (tests/test_batched_step.py's); the contact sensor's force after
every frame 1e-3 of the largest (the force-report tests' FTOL); the
reset world bit for bit at the model's initial coordinates."""

import os
import sys

import numpy as np
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (phase 54's scene and loop)
from test_torch_worlds import _tiled_actuation  # noqa: E402

torch.set_num_threads(1)
N, FRAMES, RESET_FRAME = 2, 5, 2
OBS_TOL = 1e-5
QTOL, QDTOL, FTOL = 2e-4, 5e-3, 1e-3


def _jax_loop(jm, layers):
    """Phase 54's frame in the JAX package; yields per frame (state,
    observation, action, contact sensor force)."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.actuators import Actuator, ClampMaxEffort
    from newton_tpu.controllers import ControllerPD, OnnxModule, encode_mlp
    from newton_tpu.sensors import SensorContact, SensorIMU
    from newton_tpu.sim.articulation import eval_fk
    from newton_tpu.sim.collide import CollisionPipeline
    from newton_tpu.solvers import SolverMuJoCo
    from newton_tpu.utils.selection import ArticulationView
    st = jm.structure
    pipe = CollisionPipeline(jm)
    solver = SolverMuJoCo(jm, iterations=cs.ITERS, integrator="euler")
    v = ArticulationView(jm, "*")
    imu = SensorIMU(jm, np.nonzero(np.asarray(st.shape_key) == "imu")[0])
    legs, floors = cs.policy_sensor_sets(st, N)
    contact = SensorContact(jm, legs.tolist(), [[f] for f in floors])
    policy = OnnxModule(encode_mlp(layers, "Tanh", "Tanh"))
    act = Actuator(jm, v.dof_idx[:, 6:].reshape(-1),
                   ControllerPD(cs.POLICY_KP, cs.POLICY_KD,
                                coord_indices=v.coord_idx[:, 7:].reshape(-1)),
                   ClampMaxEffort(cs.POLICY_EFFORT),
                   delay_steps=cs.POLICY_DELAY)
    lo, hi = (x[:, 6:] for x in v.get_dof_limits())
    mid, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
    weight = jm.body_mass.reshape(N, -1).sum(1, keepdims=True) * 9.81
    control = jm.control()
    # mjc:ctrl stays 0 (the JAX builder's tables are the N worlds' ones)
    control.custom["mjc:ctrl"] = jnp.zeros(N * 8)
    every = jnp.arange(N) % cs.POLICY_RESET_EVERY == 0
    sub = jax.jit(lambda s, ctl: solver.step_with_contacts(
        s, None, ctl, pipe.collide(s), cs.DT))
    s = eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state())
    prev, contacts, carry = None, pipe.collide(s), act.init_carry()
    for k in range(FRAMES):
        root = v.get_root_transforms(s)
        acc, gyro = imu.update(s, prev, cs.SUBSTEPS * cs.DT)
        force, _ = contact.update(contacts)
        obs = jnp.concatenate([root[:, 2:3], root[:, 3:7],
                               v.get_dof_positions(s)[:, 7:],
                               v.get_root_velocities(s),
                               v.get_dof_velocities(s)[:, 6:], acc / 9.81,
                               gyro, force / weight], 1)
        action = policy(obs)
        carry, ctl = act(carry, s, control,
                         (mid + half * action).reshape(-1))
        prev = s
        for _ in range(cs.SUBSTEPS):
            s, contacts = sub(s, ctl)
        z = v.get_root_transforms(s)[:, 2]
        mask = (z < cs.POLICY_HEALTHY[0]) | (z > cs.POLICY_HEALTHY[1])
        if k == RESET_FRAME:
            mask = mask | every
        s = v.eval_fk(solver.reset(s, mask), mask)
        yield s, obs, action, contact.update(contacts)[0]


def test_policy_loop_matches_jax():
    import newton_tpu as jt
    layers = cs.policy_layers()
    jb = cs.policy_ant_scene(jt, N)
    r = jt.ModelBuilder()
    r.add_mjcf(nt.ASSET_DIR + "/ant.xml")
    jb.mjc_actuation = _tiled_actuation(r, N)
    jm = jb.finalize()
    tm = cs.policy_ant_scene(nt, N).finalize("cpu")
    loop = cs.PolicyAnt(nt, tm, N, torch.device("cpu"), layers, RESET_FRAME)
    c = loop.start()
    for k, (js, jobs, jact, jforce) in enumerate(_jax_loop(jm, layers)):
        c, obs, action, mask, before = loop.frame(c, k)
        if k == 0:
            for got, ref in ((obs, jobs), (action, jact)):
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           atol=OBS_TOL, rtol=OBS_TOL)
        s = c["state"]
        np.testing.assert_allclose(s.joint_q.numpy(), np.asarray(js.joint_q),
                                   atol=QTOL, rtol=QTOL, err_msg=f"q {k}")
        np.testing.assert_allclose(s.joint_qd.numpy(),
                                   np.asarray(js.joint_qd), atol=QDTOL,
                                   rtol=QDTOL, err_msg=f"qd {k}")
        force = loop.contact.update(c["contacts"])[0].numpy()
        ref = np.asarray(jforce)
        np.testing.assert_allclose(
            force, ref, rtol=0, atol=FTOL * max(float(np.abs(ref).max()),
                                                1.0), err_msg=f"force {k}")
        if k >= 3:
            assert np.abs(ref).max() > 1.0          # the legs press
        if k == RESET_FRAME:
            assert mask.tolist() == [True, False]
            q = s.joint_q.view(N, -1)
            assert torch.equal(q[0], tm.joint_q0.view(N, -1)[0])
            assert torch.equal(q[1], before.joint_q.view(N, -1)[1])
            np.testing.assert_array_equal(np.asarray(js.joint_q)[:15],
                                          q[0].numpy())
