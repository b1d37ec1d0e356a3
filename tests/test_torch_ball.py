"""Ball joints in the port against the JAX package on the CPU: the builder
(``add_joint_ball`` and the ball-jointed ``add_rod``), the MJCF importer
(``type="ball"`` and its wxyz qpos), FK, the quaternion-error drive, Euler
and RK4 substeps of ball chains.

Tolerances: finalize leaves 1e-6 (float32 of the same float64 host
values), FK 1e-5 (float32 transform chains), ``step`` joint_q/body_q
atol = rtol = 2e-4 and joint_qd 5e-3 (tests/test_batched_step.py:69-75).
"""

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, MODEL_INT_FIELDS

torch.set_num_threads(1)

ROD_DT = 1.0 / 480.0
STRUCTURE = ("joint_type", "joint_parent", "joint_child", "joint_q_start",
             "joint_qd_start", "joint_dof_dim", "articulation_start",
             "joint_parent_joint", "candidate_pairs", "candidate_pair_slots",
             "rigid_contact_max")

BALL_MJCF = """
<mujoco model="balls">
  <compiler angle="radian"/>
  <custom>
    <numeric name="init_qpos"
             data="0.9689 0.1987 -0.1489 0.0 0.8776 0.0 0.4794 0.0 0.3"/>
  </custom>
  <worldbody>
    <geom name="floor" type="plane" size="5 5 1"/>
    <body name="upper" pos="0 0 1.5">
      <joint name="shoulder" type="ball" pos="0 0 0.2" armature="0.02"/>
      <geom type="capsule" fromto="0 0 0.2 0 0 -0.3" size="0.05"/>
      <body name="lower" pos="0 0 -0.3">
        <joint name="elbow" type="ball" pos="0 0 0"/>
        <geom type="capsule" fromto="0 0 0 0.1 0 -0.4" size="0.04"/>
        <body name="hand" pos="0.1 0 -0.4">
          <joint name="wrist" type="hinge" axis="0 1 0"/>
          <geom type="sphere" size="0.06"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


def _rod(lib, n=4, root="fixed", spacing=(0.0, 0.1, 0.0)):
    r = lib.ModelBuilder()
    r.add_rod([0.0, 0.0, 1.0], [1.0, 0.0, 1.0], segments=8, radius=0.02,
              bend_ke=200.0, bend_kd=3.0, root_joint=root, key="rod")
    if n == 1:
        return r
    b = lib.ModelBuilder()
    b.replicate(r, n, spacing=spacing)
    return b


def _joint_scene(lib):
    """Two capsules under a ball joint each, one from the world, one from
    the first, with their own frames and an armature."""
    b = lib.ModelBuilder()
    cfg = lib.ShapeConfig(density=800.0)
    p = b.add_body(xform=[0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0])
    b.add_shape_capsule(p, radius=0.05, half_height=0.2, cfg=cfg)
    b.add_joint_ball(-1, p, xform_p=[0.0, 0.0, 1.3, 0.0, 0.0, 0.0, 1.0],
                     xform_c=[0.0, 0.0, 0.3, 0.0, 0.0, 0.0, 1.0],
                     armature=0.05)
    c = b.add_body(xform=[0.2, 0.0, 0.6, 0.0, 0.0, 0.0, 1.0])
    b.add_shape_capsule(c, radius=0.04, half_height=0.15, cfg=cfg,
                        axis="X")
    b.add_joint_ball(p, c, xform_p=[0.0, 0.0, -0.3, 0.0, 0.0, 0.0, 1.0],
                     xform_c=[-0.2, 0.0, 0.1, 0.3826834, 0.0, 0.0,
                              0.9238795])
    return b


def _assert_leaves(tm, jm):
    for name in MODEL_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    for name in MODEL_INT_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for name in STRUCTURE:
        np.testing.assert_array_equal(
            np.asarray(getattr(tm.structure, name)),
            np.asarray(getattr(jm.structure, name)), err_msg=name)


@pytest.mark.parametrize("scene", ["joints", "rod fixed", "rod ball",
                                   "rod free", "rod x 3 spaced"])
def test_ball_builder_leaves_match_jax(scene):
    """``add_joint_ball`` (three canonical dofs, one config, an identity
    quaternion coordinate) and ``add_rod`` with a fixed, ball or free root
    (bend gains on every ball dof), alone and replicated with spacing
    (each world's root ``joint_X_p`` moves): every leaf equals the JAX
    builder's."""
    import newton_tpu as jt
    if scene == "joints":
        tm, jm = _joint_scene(nt).finalize("cpu"), _joint_scene(jt).finalize()
    elif scene == "rod x 3 spaced":
        tm, jm = _rod(nt, 3).finalize("cpu"), _rod(jt, 3).finalize()
    else:
        root = scene.split()[1]
        tm = _rod(nt, 1, root).finalize("cpu")
        jm = _rod(jt, 1, root).finalize()
    _assert_leaves(tm, jm)
    assert int(nt.JointType.BALL) in tm.structure.joint_type.tolist()


def test_ball_mjcf_import_matches_jax(tmp_path):
    """An MJCF body with one ``type="ball"`` joint imports as a ball joint
    anchored at its ``pos`` with its armature; ``init_qpos``'s wxyz
    quaternions become xyzw; the leaves equal the JAX importer's. A ball
    joint's damping lands on its three dofs' drive gains (MuJoCo's joint
    damping; the JAX importer drops it: ROADMAP C), and a ball joint
    mixed with another joint in one body, or limited, raises."""
    import newton_tpu as jt
    path = tmp_path / "balls.xml"
    path.write_text(BALL_MJCF)
    tb, jb = nt.ModelBuilder(), jt.ModelBuilder()
    tb.add_mjcf(str(path))
    jb.add_mjcf(str(path))
    tm, jm = tb.finalize("cpu"), jb.finalize()
    _assert_leaves(tm, jm)
    B = int(nt.JointType.BALL)
    assert tm.structure.joint_type.tolist() == [B, B,
                                                int(nt.JointType.REVOLUTE)]
    np.testing.assert_allclose(tm.joint_q0.numpy()[:8],
                               [0.1987, -0.1489, 0.0, 0.9689,
                                0.0, 0.4794, 0.0, 0.8776], atol=1e-6)
    np.testing.assert_allclose(tm.joint_armature.numpy()[:3], 0.02)
    damped = BALL_MJCF.replace('armature="0.02"',
                               'armature="0.02" damping="0.7"')
    path.write_text(damped)
    tb = nt.ModelBuilder()
    tb.add_mjcf(str(path))
    assert tb.joint_target_kd[:3] == [0.7] * 3
    for bad in ('<joint name="elbow" type="ball" pos="0 0 0"/>'
                '<joint name="twist" type="hinge"/>',
                '<joint name="elbow" type="ball" limited="true" '
                'range="0 1"/>'):
        path.write_text(BALL_MJCF.replace(
            '<joint name="elbow" type="ball" pos="0 0 0"/>', bad))
        with pytest.raises(NotImplementedError, match="ball"):
            nt.ModelBuilder().add_mjcf(str(path))


def _random_ball_coords(st, rng, q0, scale=0.4):
    """joint_q0 with every ball quaternion turned by a random rotation
    (about scale rad) and, for half the joints, negated (q and -q are one
    rotation); random dof velocities."""
    q = np.asarray(q0, dtype=np.float64).copy()
    for j in np.nonzero(st.joint_type == int(nt.JointType.BALL))[0]:
        s = st.joint_q_start[j]
        v = np.r_[scale * rng.randn(3), 1.0]
        v /= np.linalg.norm(v)
        q[s:s + 4] = v if j % 2 else -v
    qd = 0.5 * rng.randn(st.joint_dof_count)
    return q.astype(np.float32), qd.astype(np.float32)


@pytest.mark.parametrize("scene", ["joints", "rod x 4 spaced"])
def test_ball_fk_matches_jax(scene):
    """FK at random ball quaternions (some negated) and velocities: body
    poses and twists within 1e-5 of the JAX package's."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    make = _joint_scene if scene == "joints" else _rod
    tm, jm = make(nt).finalize("cpu"), make(jt).finalize()
    q, qd = _random_ball_coords(tm.structure, np.random.RandomState(3),
                                tm.joint_q0.numpy())
    ts = nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd), tm.state())
    js = j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state())
    for name in ("body_q", "body_qd"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def rod4():
    """rod x 4 (example_rod_swing.py's rod, 0.1 m apart in y) on both
    sides, from random ball coordinates, with the JAX step jitted."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.solvers.generalized.solver import \
        SolverFeatherstone as JS
    tm, jm = _rod(nt).finalize("cpu"), _rod(jt).finalize()
    q, qd = _random_ball_coords(tm.structure, np.random.RandomState(5),
                                tm.joint_q0.numpy(), scale=0.2)
    js_ = JS(jm)
    ctl = jm.control()
    return dict(
        tm=tm, ts=nt.SolverFeatherstone(tm), tc=tm.control(),
        jstep=jax.jit(lambda s: js_.step(s, None, ctl, None, ROD_DT)),
        ts0=nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd),
                       tm.state()),
        js0=j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state()))


@pytest.mark.parametrize("substeps", [1, 8])
def test_rod_step_matches_jax(rod4, substeps):
    """1 and 8 substeps of the rod x 4 (dt 1/480, SolverFeatherstone, the
    bend drives pulling every ball joint to the identity) against the JAX
    package's ``SolverFeatherstone.step``, substep by substep; one B1
    group of d = 21."""
    assert [(g.g.n, g.g.d) for g in rod4["ts"].groups] == [(4, 21)]
    ts, js = rod4["ts0"], rod4["js0"]
    for _ in range(substeps):
        ts = rod4["ts"].step(ts, None, rod4["tc"], None, ROD_DT)
        js = rod4["jstep"](js)
        for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                           ("body_q", 2e-4)):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=atol, rtol=atol, err_msg=name)


def test_ball_drive_torque_sign_invariant():
    """The ball drive's torque is ke times the axis-angle vector of
    target * current^-1: the same for a current quaternion and its
    negation, and equal to the rotation vector that takes the current
    orientation to the target."""
    from newton_tpu_torch.solvers.generalized import batched
    m = _joint_scene(nt).finalize("cpu")
    d0 = m.structure.joint_qd_start[0]
    m.joint_target_ke[d0:d0 + 6] = 50.0
    solver = nt.SolverFeatherstone(m)
    t = solver.tables
    rng = np.random.RandomState(7)
    q, _ = _random_ball_coords(m.structure, rng, m.joint_q0.numpy(), 0.6)
    q = torch.as_tensor(np.stack([q, q]))
    q[1, t.ball_q.reshape(-1)] = -q[1, t.ball_q.reshape(-1)]
    qd = torch.zeros(2, m.structure.joint_dof_count)
    ctl = m.control()
    ctl = nt.Control(joint_target_q=ctl.joint_target_q.expand(2, -1),
                     joint_target_qd=qd, joint_f=qd, custom={})
    tau, kd = batched._applied_tau(t, q, qd, ctl)
    torch.testing.assert_close(tau[0], tau[1], atol=1e-6, rtol=0)
    # the identity target: the torque is -ke times the current rotation
    # vector (axis * angle, angle in [0, pi])
    from scipy.spatial.transform import Rotation
    for k in range(2):
        quat = q[0, t.ball_q[k]].numpy().astype(np.float64)
        rv = Rotation.from_quat(quat).as_rotvec()
        np.testing.assert_allclose(tau[0, t.ball_d[k]].numpy(), -50.0 * rv,
                                   atol=1e-4)
    assert (kd == 0).all()


def test_ball_chain_rk4_matches_jax():
    """Four RK4 substeps of the ball-jointed capsule pair (ball drives with
    gains, a kick on every dof) against the JAX package's RK4: the
    quaternion coordinates advance with the stage velocities; one B1 call
    per stage."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.solvers.generalized.solver import \
        SolverFeatherstone as JS
    from newton_tpu_torch.solvers.generalized import linalg
    tb, jb = _joint_scene(nt), _joint_scene(jt)
    for b in (tb, jb):
        b.joint_target_ke[:] = [20.0] * 6
        b.joint_target_kd[:] = [0.5] * 6
    tm, jm = tb.finalize("cpu"), jb.finalize()
    q, qd = _random_ball_coords(tm.structure, np.random.RandomState(11),
                                tm.joint_q0.numpy())
    ts_ = nt.SolverFeatherstone(tm, integrator="rk4")
    js_ = JS(jm, integrator="rk4")
    jc = jm.control()
    jstep = jax.jit(lambda s: js_.step(s, None, jc, None, 0.005))
    ts = nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd), tm.state())
    js = j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state())
    before = linalg.chol_inv_solve.launches
    for _ in range(4):
        ts = ts_.step(ts, None, tm.control(), None, 0.005)
        js = jstep(js)
    assert linalg.chol_inv_solve.launches == before     # the CPU runs plain
    for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                       ("body_q", 2e-4)):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=atol,
                                   rtol=atol, err_msg=name)
    quat = ts.joint_q.numpy()[:8].reshape(2, 4)
    np.testing.assert_allclose(np.linalg.norm(quat, axis=1), 1.0, atol=1e-5)
