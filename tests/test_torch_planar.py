"""Parity: gymnasium's planar robots on the port (half_cheetah, hopper,
walker2d), whose torsos ride one D6 joint of two linear axes (rootx,
rootz) and one angular axis (rooty).

Three reference defects shape the comparisons (ROADMAP C):
- the JAX importer anchors that D6 joint at the first MJCF joint's
  ``pos`` (hopper and walker2d: 1.25 m below the torso), where MuJoCo
  rotates about the hinge's ``pos``;
- the JAX dof subspace rotates the angular dof of a D6 joint with linear
  axes about the untranslated joint origin, where FK rotates about the
  translated anchor, so its dynamics change when the root has moved;
- the JAX importer ignores ``<compiler settotalmass>`` (half_cheetah).
So the JAX builder is given MuJoCo's anchor and masses before it
finalizes, the port is held against the JAX step only from ``q_lin = 0``
(one substep, where both subspaces agree), and longer trajectories are
held against MuJoCo-C, as the JAX package's own planar gate does
(tests/test_parity_mujoco.py:249-270).

Tolerances: finalize leaves 1e-6; FK against ``mj_kinematics`` 1e-5; one
substep joint_q/body_q atol = rtol = 2e-4, joint_qd 5e-3
(tests/test_batched_step.py:69-75); translation invariance 1e-4 in q and
1e-3 in qd after 4 substeps; MuJoCo-C: qpos RMS < 0.05 over 300 steps and
the settled contact-force sums within 10%.
"""

import os

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, MODEL_INT_FIELDS
from newton_tpu_torch.utils import bridge

torch.set_num_threads(1)

DT = 1.0 / 240.0
W = 8
COUNTS = {"half_cheetah": (9, 9), "hopper": (6, 6), "walker2d": (9, 9)}


def _xml(robot):
    return os.path.join(nt.ASSET_DIR, robot + ".xml")


def _port_model(robot):
    b = nt.ModelBuilder()
    b.add_mjcf(_xml(robot))
    return b.finalize("cpu")


def _jax_builder(robot, as_mujoco=True):
    """The JAX package's builder of ``robot``; with ``as_mujoco`` given
    MuJoCo's root anchor (the root hinge's ``pos``) and MuJoCo's masses
    (``settotalmass`` applied) before it finalizes."""
    import mujoco
    import newton_tpu as jt
    from newton_tpu.core.host_math import np_transform, np_transform_multiply
    jb = jt.ModelBuilder()
    jb.add_mjcf(_xml(robot))
    if not as_mujoco:
        return jb
    mjm = mujoco.MjModel.from_xml_path(_xml(robot))
    scale = mjm.body_mass.sum() / sum(jb.body_mass)
    jb.body_mass = [m * scale for m in jb.body_mass]
    jb.body_inertia = [inertia * scale for inertia in jb.body_inertia]
    hinge = next(i for i in range(mjm.njnt) if mjm.jnt_bodyid[i] == 1
                 and mjm.jnt_type[i] == mujoco.mjtJoint.mjJNT_HINGE)
    anchor = np_transform(mjm.jnt_pos[hinge])
    jb.joint_X_p[0] = np_transform_multiply(np_transform(mjm.body_pos[1]),
                                            anchor)
    jb.joint_X_c[0] = anchor
    return jb


def _np(obj, fields):
    out = {n: np.asarray(getattr(obj, n)) for n in fields}
    out["custom"] = {k: np.asarray(v) for k, v in
                     getattr(obj, "custom", {}).items()}
    return out


def _qref(model):
    r = model.custom.get("mjc:qpos_ref")
    return (np.zeros(model.structure.joint_coord_count) if r is None
            else r.numpy().astype(np.float64))


# ----------------------------------------------------------------------
# builder and importer
# ----------------------------------------------------------------------
@pytest.mark.parametrize("robot", list(COUNTS))
def test_finalize_leaves_match_jax(robot):
    """Every float leaf within 1e-6 and every structure table equal to the
    JAX builder's (given MuJoCo's anchor and masses); the root is one D6
    joint of 2 linear + 1 angular axes; rootz's ``ref`` sits at its own
    coordinate."""
    jm = _jax_builder(robot).finalize()
    tm = _port_model(robot)
    st = tm.structure
    assert (st.joint_coord_count, st.joint_dof_count) == COUNTS[robot]
    assert int(st.joint_type[0]) == int(nt.JointType.D6)
    assert tuple(st.joint_dof_dim[0]) == (2, 1)
    for name in MODEL_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    for name in MODEL_INT_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for name in ("joint_q_start", "joint_qd_start", "joint_dof_dim",
                 "joint_parent", "joint_child", "candidate_pairs",
                 "rigid_contact_max"):
        np.testing.assert_array_equal(np.asarray(getattr(st, name)),
                                      np.asarray(getattr(jm.structure, name)),
                                      err_msg=name)
    ref = np.asarray(jm.custom.get("mjc:qpos_ref",
                                   np.zeros(st.joint_coord_count)))
    np.testing.assert_array_equal(_qref(tm), ref.astype(np.float64))


@pytest.mark.parametrize("n_lin, n_ang", [(1, 0), (2, 1), (3, 0), (3, 3),
                                          (1, 2), (0, 2)])
def test_add_joint_d6_counts_match_jax(n_lin, n_ang):
    """``add_joint_d6`` with n_lin linear and n_ang angular axes (limits,
    armature and gains per axis) below a free body: coordinate and dof
    starts, ``joint_dof_dim`` and the per-dof leaves equal the JAX
    builder's; linear dofs come first."""
    import newton_tpu as jt

    def build(lib):
        b = lib.ModelBuilder()
        root = b.add_body(xform=[0, 0, 1, 0, 0, 0, 1])
        b.add_shape_sphere(root, radius=0.1)
        b.add_joint_free(root)
        child = b.add_body(xform=[0.3, 0, 1, 0, 0, 0, 1])
        b.add_shape_capsule(child, radius=0.05, half_height=0.2)
        axes = ("X", "Y", "Z")
        lin = [lib.JointDofConfig(axis=axes[k], limit_lower=-0.1 * (k + 1),
                                  limit_upper=0.2, armature=0.01 * k,
                                  target_ke=5.0 * k) for k in range(n_lin)]
        ang = [lib.JointDofConfig(axis=axes[k], limit_lower=-1.0,
                                  limit_upper=0.5 * (k + 1),
                                  target_kd=0.5 + k) for k in range(n_ang)]
        j = b.add_joint_d6(root, child, linear_axes=lin, angular_axes=ang,
                           xform_p=[0.3, 0, 0, 0, 0, 0, 1])
        assert b.joint_dof_dim[j] == (n_lin, n_ang)
        return b.finalize() if lib is jt else b.finalize("cpu")
    jm, tm = build(jt), build(nt)
    st = tm.structure
    assert st.joint_dof_count == 6 + n_lin + n_ang
    assert st.joint_coord_count == 7 + n_lin + n_ang
    for name in ("joint_q_start", "joint_qd_start", "joint_dof_dim"):
        np.testing.assert_array_equal(np.asarray(getattr(st, name)),
                                      np.asarray(getattr(jm.structure, name)),
                                      err_msg=name)
    for name in ("joint_axis", "joint_limit_lower", "joint_limit_upper",
                 "joint_armature", "joint_target_ke", "joint_target_kd",
                 "joint_q0"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), atol=0,
                                   err_msg=name)


POSES = {"rooty +0.5": (0.0, 0.0, 0.5), "rooty -0.5": (0.0, 0.0, -0.5),
         "rootx 5": (5.0, 0.3, 0.5)}


@pytest.mark.parametrize("pose", list(POSES))
@pytest.mark.parametrize("robot", list(COUNTS))
def test_fk_matches_mujoco(robot, pose):
    """Body positions and orientations of port FK at tilted and
    translated roots (leg hinges random) against ``mj_kinematics``."""
    import mujoco
    tm = _port_model(robot)
    mjm = mujoco.MjModel.from_xml_path(_xml(robot))
    d = mujoco.MjData(mjm)
    qpos = mjm.qpos0.copy()
    qpos[:3] += POSES[pose]
    qpos[3:] = np.random.RandomState(len(pose)).uniform(-0.4, 0.4,
                                                        mjm.nq - 3)
    d.qpos[:] = qpos
    mujoco.mj_kinematics(mjm, d)
    q = torch.as_tensor(qpos - _qref(tm), dtype=torch.float32)
    s = nt.eval_fk(tm, q, torch.zeros(mjm.nv), tm.state())
    np.testing.assert_allclose(s.body_q[:, :3].numpy(), d.xpos[1:],
                               atol=1e-5, rtol=0)
    quat = s.body_q[:, 3:].numpy()
    mjq = d.xquat[1:][:, [1, 2, 3, 0]]
    sign = np.sign((quat * mjq).sum(1, keepdims=True))
    np.testing.assert_allclose(quat * sign, mjq, atol=1e-5, rtol=0)


def test_jax_anchor_defect_pinned():
    """Reference defect (ROADMAP C): the JAX importer anchors hopper's
    root D6 joint at rootx's ``pos`` (0, 0, -1.25), so at rooty = 0.5 its
    torso sits at (0.599, 0, 1.097); MuJoCo and the port put it at
    (0, 0, 1.25)."""
    import jax.numpy as jnp
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    jm = _jax_builder("hopper", as_mujoco=False).finalize()
    tm = _port_model("hopper")
    q = np.zeros(6, np.float32)
    q[2] = 0.5
    js = j_eval_fk(jm, jnp.asarray(q), jnp.zeros(6), jm.state())
    ts = nt.eval_fk(tm, torch.as_tensor(q), torch.zeros(6), tm.state())
    np.testing.assert_allclose(np.asarray(js.body_q[0, :3]),
                               [0.599, 0.0, 1.097], atol=1e-3)
    np.testing.assert_allclose(ts.body_q[0, :3].numpy(), [0.0, 0.0, 1.25],
                               atol=1e-6)


def test_settotalmass_scales_bodies():
    """``<compiler settotalmass="14">`` (half_cheetah): the port scales
    every body's mass and inertia to 14 kg as MuJoCo does; the JAX
    importer ignores it (21.18 kg; reference defect, ROADMAP C)."""
    import mujoco
    mjm = mujoco.MjModel.from_xml_path(_xml("half_cheetah"))
    tm = _port_model("half_cheetah")
    np.testing.assert_allclose(tm.body_mass.numpy(), mjm.body_mass[1:],
                               rtol=1e-6)
    eig = np.linalg.eigvalsh(tm.body_inertia.numpy().astype(np.float64))
    np.testing.assert_allclose(eig, np.sort(mjm.body_inertia[1:], 1),
                               rtol=1e-5, atol=1e-9)
    jb = _jax_builder("half_cheetah", as_mujoco=False)
    assert abs(sum(jb.body_mass) - 21.18) < 0.01
    assert abs(float(tm.body_mass.sum()) - 14.0) < 1e-5


# ----------------------------------------------------------------------
# the substep: against the JAX step from q_lin = 0, translation
# invariance, and MuJoCo-C trajectories
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def cheetah():
    """half_cheetah on both sides (JAX with MuJoCo's anchor and masses),
    euler, 8 PGS iterations, and the jitted JAX batched step."""
    import jax
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    jm = _jax_builder("half_cheetah").finalize()
    js = JSolver(jm, iterations=8, integrator="euler")

    class NS:
        pass
    ns = NS()
    ns.jm, ns.tm = jm, _port_model("half_cheetah")
    ns.ts = nt.SolverMuJoCo(ns.tm, iterations=8, integrator="euler")
    ns.pipe = nt.CollisionPipeline(ns.tm)
    ns.j_step = jax.jit(lambda s, c, ct: js.step_batched(s, None, c, ct, DT))
    ns.j_collide = jax.jit(jax.vmap(JPipe(jm).collide))
    return ns


def _cheetah_coords(seed, shift=0.0, pitch_rate=0.0):
    """W perturbed half_cheetah coordinates with rootx = shift, rootz = 0
    and the rooty rate ``pitch_rate``: legs spread so that some feet
    touch the plane."""
    rng = np.random.RandomState(seed)
    q = np.zeros((W, 9), np.float32)
    q[:, 2] = rng.uniform(-0.6, 0.6, W)
    q[:, 3:] = rng.uniform(-0.5, 0.5, (W, 6))
    q[:, 0] = shift
    qd = (0.3 * rng.randn(W, 9)).astype(np.float32)
    qd[:, 2] += pitch_rate
    return q, qd


def _port_control(tm, ctrl):
    c = tm.control()
    n = ctrl.shape[0]
    return nt.Control(
        joint_target_q=c.joint_target_q.expand(n, -1).clone(),
        joint_target_qd=torch.zeros(n, tm.structure.joint_dof_count),
        joint_f=torch.zeros(n, tm.structure.joint_dof_count),
        custom={"mjc:ctrl": torch.as_tensor(ctrl)})


def test_half_cheetah_substep_matches_jax(cheetah):
    """One euler substep of W = 8 envs from q_lin = 0 (pitched torsos,
    spread legs, random ctrl in [-1, 1]; contacts active) against the JAX
    package's ``step_batched``: joint_q/body_q 2e-4, joint_qd 5e-3."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.parallel import batch_state as j_batch_state
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    jm = cheetah.jm
    q, qd = _cheetah_coords(1)
    sb = jax.vmap(lambda a, b, s: j_eval_fk(jm, a, b, s))(
        jnp.asarray(q), jnp.asarray(qd), j_batch_state(jm.state(), W))
    ctrl = np.random.RandomState(2).uniform(-1, 1, (W, 6)).astype(np.float32)
    control = jm.control()
    cb = jax.vmap(lambda cv: control.replace(
        custom={**control.custom, "mjc:ctrl": cv}))(jnp.asarray(ctrl))
    contacts = cheetah.j_collide(sb)
    assert np.asarray(contacts.rigid_contact_mask).any()
    ref = cheetah.j_step(sb, cb, contacts)
    got = cheetah.ts.step_batched(
        bridge.state_from_numpy(_np(sb, bridge.STATE_FIELDS), "cpu"), None,
        bridge.control_from_numpy(_np(cb, bridge.CONTROL_FIELDS), "cpu"),
        bridge.contacts_from_numpy(_np(contacts, bridge.CONTACT_FIELDS),
                                   "cpu"), DT)
    for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                       ("body_q", 2e-4)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=atol, err_msg=name)


def _cheetah_run(tm, solver, pipe, q, qd, ctrl, substeps):
    s = nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd),
                   nt.batch_state(tm.state(), W))
    c = _port_control(tm, ctrl)
    for _ in range(substeps):
        s = solver.step_batched(s, None, c, pipe.collide(s), DT)
    return s


def test_translation_invariance(cheetah):
    """The same envs (pitch rate 3 rad/s, random ctrl) started at rootx = 0
    and at rootx = 5 m: after 4 substeps joint_q (rootx less 5) agrees to
    1e-4 and joint_qd to 1e-3. The JAX package's subspace fails this by
    orders of magnitude (``test_jax_subspace_defect_pinned``)."""
    ctrl = np.random.RandomState(4).uniform(-1, 1, (W, 6)).astype(np.float32)
    outs = []
    for shift in (0.0, 5.0):
        q, qd = _cheetah_coords(3, shift, pitch_rate=3.0)
        outs.append(_cheetah_run(cheetah.tm, cheetah.ts, cheetah.pipe, q, qd,
                                 ctrl, 4))
    a, b = outs
    q_b = b.joint_q.clone()
    q_b[:, 0] -= 5.0
    np.testing.assert_allclose(q_b.numpy(), a.joint_q.numpy(), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(b.joint_qd.numpy(), a.joint_qd.numpy(),
                               atol=1e-3, rtol=0)
    assert torch.isfinite(a.joint_q).all()


def test_jax_subspace_defect_pinned(cheetah):
    """Reference defect (ROADMAP C): the JAX subspace rotates rooty about
    the untranslated joint origin, so one JAX substep of the same envs at
    rootx = 0 and rootx = 5 m ends with velocities that differ by more
    than 0.1 (the port: 1e-3 after 4 substeps)."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.parallel import batch_state as j_batch_state
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    jm = cheetah.jm
    ctrl = np.random.RandomState(4).uniform(-1, 1, (W, 6)).astype(np.float32)
    control = jm.control()
    cb = jax.vmap(lambda cv: control.replace(
        custom={**control.custom, "mjc:ctrl": cv}))(jnp.asarray(ctrl))
    qds = []
    for shift in (0.0, 5.0):
        q, qd = _cheetah_coords(3, shift, pitch_rate=3.0)
        sb = jax.vmap(lambda a, b, s: j_eval_fk(jm, a, b, s))(
            jnp.asarray(q), jnp.asarray(qd), j_batch_state(jm.state(), W))
        qds.append(np.asarray(cheetah.j_step(sb, cb,
                                             cheetah.j_collide(sb)).joint_qd))
    assert np.abs(qds[1] - qds[0]).max() > 0.1


def _port_rollout(robot, qpos0, steps, integrator):
    """One env of ``robot`` through the port from MuJoCo's qpos0 for
    ``steps`` steps of the asset's timestep: MuJoCo-layout qpos per step
    and the contact normal-force sum (normal impulses / dt)."""
    import mujoco
    tm = _port_model(robot)
    dt = mujoco.MjModel.from_xml_path(_xml(robot)).opt.timestep
    solver = nt.SolverMuJoCo(tm, iterations=8, integrator=integrator)
    pipe = nt.CollisionPipeline(tm)
    qref = _qref(tm)
    D = tm.structure.joint_dof_count
    s = nt.eval_fk(tm, torch.as_tensor(qpos0 - qref, dtype=torch.float32)[None],
                   torch.zeros(1, D), nt.batch_state(tm.state(), 1))
    c = _port_control(tm, np.zeros((1, tm.structure.mjc_actuation.n),
                                   np.float32))
    qpos, force = [qpos0], [0.0]
    for _ in range(steps):
        rec = {}
        s = solver.step_batched(s, None, c, pipe.collide(s), dt, record=rec)
        n = rec["pgs"][1]["c"]
        force.append(float(rec["lam"][0, :n].sum()) / dt)
        qpos.append(s.joint_q[0].numpy().astype(np.float64) + qref)
    return np.asarray(qpos), np.asarray(force)


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
@pytest.mark.parametrize("robot", ["hopper", "walker2d"])
def test_planar_matches_mujoco(robot, integrator):
    """Drop, land, settle (the JAX package's gate,
    tests/test_parity_mujoco.py:249-270): from 0.1 m above the rest pose,
    300 steps of the asset's 2 ms against MuJoCo-C under the same
    integrator; qpos RMS < 0.05 and the mean contact-force sum of the last
    10 steps within 10%."""
    from newton_tpu.utils import parity as P
    import mujoco
    mjm = mujoco.MjModel.from_xml_path(_xml(robot))
    qpos0 = mjm.qpos0.copy()
    qpos0[1] += 0.1
    mj = P.mujoco_rollout(_xml(robot), 300, qpos0=qpos0,
                          integrator=integrator)
    qpos, force = _port_rollout(robot, qpos0, 300, integrator)
    rms = np.sqrt(np.mean((mj.qpos - qpos) ** 2))
    assert rms < 0.05, f"{robot} qpos RMS {rms}"
    f_mj = np.mean(mj.contact_normal_force[-10:])
    f_nt = np.mean(force[-10:])
    assert abs(f_mj - f_nt) < 0.1 * max(f_mj, 1.0), (f_mj, f_nt)
