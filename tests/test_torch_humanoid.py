"""Parity: the humanoid slice of the port (D6 hinge joints, fixed tendons,
sphere/capsule self-contact pairs, top-K contact compaction) against the
JAX package on the CPU, whose XLA branch is the kernels' plain reference.

Tolerances: finalize float leaves, the pair functions and the dof
subspace 1e-6 (float32, same operations); contacts 1e-5 (float32 transform
chains through 4 levels); one substep joint_q/body_q atol = rtol = 2e-4
and joint_qd 5e-3 (test_batched_step.py:69-75); the 8-substep rollout of
the whole slice joint_q 1e-3 and joint_qd 2e-2, the ant's
(test_torch_step.py), because float32 reorderings compound through 8
Jacobi sweeps per substep. Compaction indices are equal.

The fixed-tendon coordinates are checked against the MJCF hinges found by
name, not against the JAX package: its builder maps each tendon entry to
the first coordinate of the D6 joint that holds the hinge (hip_x instead
of hip_y on the humanoid)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newton_tpu as jt
from newton_tpu.geometry import narrow_phase as j_np
from newton_tpu.parallel import batch_state as j_batch_state
from newton_tpu.sim.articulation import eval_fk as j_eval_fk
from newton_tpu.sim.collide import CollisionPipeline as JPipe
from newton_tpu.solvers import SolverMuJoCo as JSolver
from newton_tpu.solvers.generalized.batched import _dof_subspace_t

import newton_tpu_torch as nt
from newton_tpu_torch.geometry import narrow_phase as t_np
from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, MODEL_INT_FIELDS
from newton_tpu_torch.solvers.generalized import batched as t_batched
from newton_tpu_torch.utils import bridge

torch.set_num_threads(1)

W = 4
DT = 1.0 / 240.0
HUMANOID = os.path.join(nt.ASSET_DIR, "humanoid.xml")
LYING = np.array([np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)])  # 90 deg x


def _np(obj, fields):
    out = {n: np.asarray(getattr(obj, n)) for n in fields}
    out["custom"] = {k: np.asarray(v) for k, v in
                     getattr(obj, "custom", {}).items()}
    return out


class _Side:
    """One JAX solver configuration and its port twin on one model."""

    def __init__(self, jm, tm, **kw):
        self.js = JSolver(jm, iterations=8, integrator="euler", **kw)
        self.ts = nt.SolverMuJoCo(tm, iterations=8, integrator="euler", **kw)
        self.step = jax.jit(
            lambda s, c, ct: self.js.step_batched(s, None, c, ct, DT))


@pytest.fixture(scope="module")
def hum():
    jb = jt.ModelBuilder()
    jb.add_mjcf(HUMANOID)
    tb = nt.ModelBuilder()
    info = tb.add_mjcf(HUMANOID)

    class NS:
        pass
    ns = NS()
    ns.jm, ns.tm, ns.info = jb.finalize(), tb.finalize("cpu"), info
    ns.jpipe, ns.tpipe = JPipe(ns.jm), nt.CollisionPipeline(ns.tm)
    ns.j_collide = jax.jit(jax.vmap(ns.jpipe.collide))
    ns.j_fk = jax.jit(jax.vmap(lambda a, b, s: j_eval_fk(ns.jm, a, b, s)))
    return ns


@pytest.fixture(scope="module")
def default(hum):
    return _Side(hum.jm, hum.tm)


@pytest.fixture(scope="module")
def cap8(hum):
    return _Side(hum.jm, hum.tm, contact_cap=8)


def _pose(hum, seed, drop=0.0, lying_z=None, hip_push=0.0):
    """Batched JAX state: joint_q0 with noise, the root lowered by ``drop``
    or laid on its side at height ``lying_z``, hips pushed past limits."""
    jm = hum.jm
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(jm.joint_q0), (W, 1)) \
        + 0.02 * rng.randn(W, 24).astype(np.float32)
    q[:, 2] -= drop
    if lying_z is not None:
        q[:, 2] = lying_z
        q[:, 3:7] = LYING
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    # hip_x of both legs (coords 10, 14) and hip_y (12, 16) past their
    # upper limits of 5 and 20 degrees
    q[:, [10, 12, 14, 16]] += hip_push
    qd = 0.1 * rng.randn(W, 23).astype(np.float32)
    return hum.j_fk(jnp.asarray(q), jnp.asarray(qd),
                    j_batch_state(jm.state(), W))


def _controls(jm, ctrl):
    control = jm.control()
    return jax.vmap(lambda cv: control.replace(
        custom={**control.custom, "mjc:ctrl": cv}))(jnp.asarray(ctrl))


def _assert_close(got, ref, q_atol=2e-4, qd_atol=5e-3):
    np.testing.assert_allclose(got.joint_q.numpy(), np.asarray(ref.joint_q),
                               atol=q_atol, rtol=2e-4)
    np.testing.assert_allclose(got.joint_qd.numpy(),
                               np.asarray(ref.joint_qd), atol=qd_atol,
                               rtol=5e-3)
    np.testing.assert_allclose(got.body_q.numpy(), np.asarray(ref.body_q),
                               atol=q_atol, rtol=2e-4)


# ---------------------------------------------------------------------------
# import and finalize
# ---------------------------------------------------------------------------

def test_humanoid_counts(hum, default):
    st = hum.tm.structure
    assert (st.body_count, st.joint_coord_count, st.joint_dof_count) == \
        (13, 24, 23)
    assert len(st.candidate_pairs) == 128 and st.rigid_contact_max == 192
    assert st.joint_dof_dim[:, 1].tolist() == \
        [1, 2, 1, 3, 1, 0, 3, 1, 0, 2, 1, 2, 1]
    assert st.mjc_actuation.n == 17 and st.tendon_count == 2
    assert default.ts._plan_cap(192) == 32 and default.ts.tables.nl == 17


def test_leaves_match_jax(hum):
    jm, tm = hum.jm, hum.tm
    for name in MODEL_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   atol=1e-6, rtol=0, err_msg=name)
    for name in MODEL_INT_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)


def test_structure_and_actuation_match_jax(hum):
    jm, tm = hum.jm, hum.tm
    for name in bridge.STRUCTURE_FIELDS:
        if name in ("tendon_coord", "tendon_dof"):
            continue            # the reference's defect: see below
        a, b = getattr(jm.structure, name), getattr(tm.structure, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            assert a == b, name
    ja, ta = jm.structure.mjc_actuation, tm.structure.mjc_actuation
    for name in bridge.ACTUATION_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ta, name)),
                                      np.asarray(getattr(ja, name)),
                                      err_msg=name)
    for k, v in jm.custom.items():
        np.testing.assert_array_equal(tm.custom[k].numpy(), np.asarray(v))


def test_tendons_address_their_hinges(hum):
    """Each tendon entry is its MJCF hinge's own coordinate and dof
    (hip_y and knee), where the JAX builder gives the first coordinate of
    the D6 hip joint (hip_x): [[14, 17], [10, 13]] against [[16, 17],
    [12, 13]]."""
    st, info = hum.tm.structure, hum.info
    names = [["left_hip_y", "left_knee"], ["right_hip_y", "right_knee"]]
    want_q = [[info["joint_coord_start"][n] for n in row] for row in names]
    want_d = [[info["joint_dof_start"][n] for n in row] for row in names]
    assert want_q == [[16, 17], [12, 13]] and want_d == [[15, 16], [11, 12]]
    np.testing.assert_array_equal(st.tendon_coord, want_q)
    np.testing.assert_array_equal(st.tendon_dof, want_d)
    np.testing.assert_array_equal(st.tendon_coef, [[-1, 1], [-1, 1]])
    np.testing.assert_array_equal(np.asarray(hum.jm.structure.tendon_coord),
                                  [[14, 17], [10, 13]])


def test_bridge_round_trip_with_tendons(hum):
    tm = hum.tm
    leaves, structure = bridge.model_to_numpy(tm)
    back = bridge.model_from_numpy(leaves, structure, "cpu")
    for name in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS:
        assert torch.equal(getattr(back, name), getattr(tm, name)), name
    for name in ("tendon_coord", "tendon_dof", "tendon_coef"):
        np.testing.assert_array_equal(getattr(back.structure, name),
                                      getattr(tm.structure, name))
    c = tm.control()
    c.tendon_f = torch.tensor([0.5, -2.0])
    c2 = bridge.control_from_numpy(bridge.control_to_numpy(c), "cpu")
    assert torch.equal(c2.tendon_f, c.tendon_f)
    c.tendon_f = None
    assert bridge.control_from_numpy(bridge.control_to_numpy(c),
                                     "cpu").tendon_f is None


# ---------------------------------------------------------------------------
# narrow phase and collision
# ---------------------------------------------------------------------------

def _random_transforms(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.uniform(-0.3, 0.3, (n, 3)), q],
                          1).astype(np.float32)


def _degenerate(name):
    """Coincident centres, parallel and coaxial segments, zero-length
    segments: every guarded division of the pair function."""
    ident = np.array([0, 0, 0, 0, 0, 0, 1], np.float32)
    X0 = np.tile(ident, (6, 1))
    X1 = np.tile(ident, (6, 1))
    X1[1, 0] = 0.1                  # parallel, side by side
    X1[2, 2] = 0.3                  # coaxial, end to end
    X1[3, 1] = 0.05                 # parallel, offset
    X1[4, 3:7] = [np.sin(0.5), 0, 0, np.cos(0.5)]
    s0 = np.tile(np.float32([0.1, 0.2, 0]), (6, 1))
    s1 = np.tile(np.float32([0.05, 0.15, 0]), (6, 1))
    s0[5, 1] = s1[5, 1] = 0.0       # zero-length segments
    s1[4, 1] = 0.0
    if name == "sphere_sphere":
        X1[4, 0:3] = 1e-10          # centres closer than eps
    return X0, X1, s0, s1


@pytest.mark.parametrize("case", ["random", "degenerate"])
@pytest.mark.parametrize("name", ["sphere_sphere", "sphere_capsule",
                                  "capsule_capsule"])
def test_pair_function_matches_jax(name, case):
    if case == "random":
        rng = np.random.RandomState(9)
        n = 64
        X0, X1 = _random_transforms(rng, n), _random_transforms(rng, n)
        s0 = rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)
        s1 = rng.uniform(0.05, 0.3, (n, 3)).astype(np.float32)
    else:
        X0, X1, s0, s1 = _degenerate(name)
    ref = getattr(j_np, name)(*map(jnp.asarray, (X0, X1, s0, s1)))
    got = getattr(t_np, name)(*map(torch.as_tensor, (X0, X1, s0, s1)))
    for r, g in zip(ref, got):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6,
                                   rtol=0)


@pytest.mark.parametrize("pose", ["standing", "lying"])
def test_collide_matches_jax(hum, pose):
    """All 192 slots, the capsule-first sphere-capsule pairs included
    (their normals flip back to shape0 -> shape1)."""
    sb = _pose(hum, 21, drop=0.1) if pose == "standing" \
        else _pose(hum, 22, lying_z=0.12)
    ref = hum.j_collide(sb)
    tsb = nt.batch_state(hum.tm.state(), W)
    tsb.body_q = torch.as_tensor(np.array(sb.body_q))
    got = hum.tpipe.collide(tsb)
    mask = np.asarray(ref.rigid_contact_mask)
    assert mask.shape == (W, 192) and mask.any()
    np.testing.assert_array_equal(got.rigid_contact_mask.numpy(), mask)
    for name in ("rigid_contact_shape0", "rigid_contact_shape1"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name in ("rigid_contact_depth", "rigid_contact_position",
                 "rigid_contact_normal"):
        np.testing.assert_allclose(getattr(got, name).numpy()[mask],
                                   np.asarray(getattr(ref, name))[mask],
                                   atol=1e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# solver stages
# ---------------------------------------------------------------------------

def test_dof_subspace_matches_jax(hum, default):
    """Multi-hinge joints: axes transported by the coordinates before
    them, at random coordinates well away from q0."""
    jm = hum.jm
    rng = np.random.RandomState(4)
    q = np.tile(np.asarray(jm.joint_q0), (W, 1)) \
        + 0.6 * rng.randn(W, 24).astype(np.float32)
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    sb = hum.j_fk(jnp.asarray(q), jnp.zeros((W, 23)),
                  j_batch_state(jm.state(), W))
    bq = np.asarray(sb.body_q)
    v_j, w_j = _dof_subspace_t(
        jm, tuple(jnp.asarray(bq[:, :, k].T) for k in range(3)),
        tuple(jnp.asarray(bq[:, :, 3 + k].T) for k in range(4)),
        jnp.asarray(q.T))
    v_t, w_t = t_batched._dof_subspace(default.ts.tables, torch.tensor(bq),
                                       torch.as_tensor(q))
    for got, ref in ((v_t, v_j), (w_t, w_j)):
        np.testing.assert_allclose(
            got.numpy(), np.stack([np.asarray(x).T for x in ref], -1),
            atol=1e-6, rtol=0)


def test_compaction_indices_match_top_k():
    """Scores with ties (inactive slots at 0, equal depths): the same K
    slots in the same order as ``jax.lax.top_k``."""
    rng = np.random.RandomState(8)
    n, c, K = 64, 192, 32
    active = rng.rand(n, c) < 0.15
    depth = np.round(rng.uniform(-0.01, 0.02, (n, c)), 2).astype(np.float32)
    score = (active * np.maximum(1.0 + depth, 0.5)).astype(np.float32)
    score[0] = 0.0                                   # all slots tied
    score[1, :40] = 1.0                              # more ties than K
    ref = np.asarray(jax.lax.top_k(jnp.asarray(score), K)[1])
    got = t_batched.compaction_indices(torch.as_tensor(score), K)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("case", ["ctrl_touchdown", "lying_cap8",
                                  "hip_limits"])
def test_substep_matches_jax(hum, default, cap8, case):
    """Random ctrl with the feet at the floor; a lying pose whose active
    contacts outnumber contact_cap=8, so compaction drops some; and hips
    pushed past their limits (limit rows active)."""
    side = cap8 if case == "lying_cap8" else default
    sb = {"ctrl_touchdown": lambda: _pose(hum, 30, drop=0.15),
          "lying_cap8": lambda: _pose(hum, 31, lying_z=0.10),
          "hip_limits": lambda: _pose(hum, 32, hip_push=0.6)}[case]()
    ctrl = np.random.RandomState(33).uniform(-0.4, 0.4, (W, 17)).astype(
        np.float32)
    cb = _controls(hum.jm, ctrl)
    contacts = hum.j_collide(sb)
    n_active = np.asarray(contacts.rigid_contact_mask).sum(1)
    if case == "lying_cap8":
        assert n_active.max() > 8
    elif case == "ctrl_touchdown":
        assert n_active.min() > 0
    ref = side.step(sb, cb, contacts)
    got = side.ts.step_batched(
        bridge.state_from_numpy(_np(sb, bridge.STATE_FIELDS), "cpu"), None,
        bridge.control_from_numpy(_np(cb, bridge.CONTROL_FIELDS), "cpu"),
        bridge.contacts_from_numpy(_np(contacts, bridge.CONTACT_FIELDS),
                                   "cpu"), DT)
    _assert_close(got, ref)


def test_rollout_matches_jax(hum, default):
    """The whole slice for 8 substeps: the port's own MJCF import,
    finalize, eval_fk, batch_state, collide and step, against the JAX
    package's, from the same coordinates (feet at the floor) and ctrl."""
    jm, tm = hum.jm, hum.tm
    sb = _pose(hum, 40, drop=0.15)
    ts = nt.eval_fk(tm, torch.as_tensor(np.array(sb.joint_q)),
                    torch.as_tensor(np.array(sb.joint_qd)),
                    nt.batch_state(tm.state(), W))
    ctrl = np.random.RandomState(41).uniform(-0.4, 0.4, (W, 17)).astype(
        np.float32)
    cb = _controls(jm, ctrl)
    c = tm.control()
    tcb = nt.Control(joint_target_q=c.joint_target_q.expand(W, -1).clone(),
                     joint_target_qd=torch.zeros(W, 23),
                     joint_f=torch.zeros(W, 23),
                     custom={"mjc:ctrl": torch.as_tensor(ctrl)})
    for _ in range(8):
        sb = default.step(sb, cb, hum.j_collide(sb))
        ts = default.ts.step_batched(ts, None, tcb, hum.tpipe.collide(ts), DT)
    assert bool(torch.isfinite(ts.joint_q).all())
    _assert_close(ts, sb, q_atol=1e-3, qd_atol=2e-2)


# ---------------------------------------------------------------------------
# fixed tendons
# ---------------------------------------------------------------------------

CHAIN = """<mujoco model="chain">
  <worldbody>
    <body name="base" pos="0 0 1">
      <geom type="sphere" size="0.05"/>
      <body name="l1" pos="0 0 -0.1">
        <joint name="h1" type="hinge" axis="0 1 0" armature="0.01"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04"/>
        <body name="l2" pos="0.3 0 0">
          <joint name="h2" type="hinge" axis="0 1 0" armature="0.01"/>
          <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.04"/>
          <body name="l3" pos="0.3 0 0">
            <joint name="h3" type="hinge" axis="1 0 0" armature="0.01"/>
            <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.03"/>
          </body>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t12" stiffness="40" damping="3">
      <joint joint="h1" coef="1"/><joint joint="h2" coef="-0.5"/>
    </fixed>
    <fixed name="t3" stiffness="5" damping="0.5">
      <joint joint="h3" coef="2"/>
    </fixed>
  </tendon>
</mujoco>"""


def test_tendon_chain_matches_jax(tmp_path):
    """Single-hinge bodies, where the JAX builder's tendon coordinates are
    right: stiffness, damping and a tendon_f input, over 4 substeps."""
    path = tmp_path / "chain.xml"
    path.write_text(CHAIN)
    jb = jt.ModelBuilder()
    jb.add_mjcf(str(path))
    jm = jb.finalize()
    tb = nt.ModelBuilder()
    tb.add_mjcf(str(path))
    tm = tb.finalize("cpu")
    np.testing.assert_array_equal(tm.structure.tendon_coord,
                                  np.asarray(jm.structure.tendon_coord))
    np.testing.assert_allclose(tm.tendon_params.numpy(),
                               np.asarray(jm.tendon_params))
    js = JSolver(jm, iterations=8, integrator="euler")
    ts = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    rng = np.random.RandomState(50)
    q = 0.4 * rng.randn(W, 3).astype(np.float32)
    qd = rng.randn(W, 3).astype(np.float32)
    tf = rng.randn(W, 2).astype(np.float32)
    sb = jax.vmap(lambda a, b, s: j_eval_fk(jm, a, b, s))(
        jnp.asarray(q), jnp.asarray(qd), j_batch_state(jm.state(), W))
    control = jm.control()
    cb = jax.vmap(lambda f: control.replace(tendon_f=f))(jnp.asarray(tf))
    tsb = nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd),
                     nt.batch_state(tm.state(), W))
    tcb = bridge.control_from_numpy(_np(cb, bridge.CONTROL_FIELDS), "cpu")
    step = jax.jit(lambda s, c: js.step_batched(s, None, c, None, DT))
    for _ in range(4):
        sb = step(sb, cb)
        tsb = ts.step_batched(tsb, None, tcb, None, DT)
    _assert_close(tsb, sb)


def test_d6_tendon_force_by_hand():
    """A tendon on the second axis of a D6 joint: tau = coef * f on that
    axis's dof and nothing on the first, f = -ke (coef q - L0) -
    kd coef qd + tendon_f."""
    b = nt.ModelBuilder()
    body = b.add_body(xform=[0, 0, 1, 0, 0, 0, 1])
    b.add_shape_sphere(body, radius=0.1)
    axes = [nt.JointDofConfig(axis=(1, 0, 0)),
            nt.JointDofConfig(axis=(0, 1, 0))]
    j = b.add_joint(nt.JointType.D6, -1, body, angular_axes=axes)
    with pytest.raises(ValueError, match="axis"):
        b.add_tendon_fixed([j], [2.0])
    b.add_tendon_fixed([j], [2.0], axes=[1], stiffness=30.0, damping=4.0,
                       rest_length=0.1)
    m = b.finalize("cpu")
    assert m.structure.tendon_coord.tolist() == [[1]]
    solver = nt.SolverMuJoCo(m, iterations=8, integrator="euler")
    q = torch.tensor([[0.3, -0.2], [0.0, 0.7]])
    qd = torch.tensor([[1.0, 0.5], [-0.4, -2.0]])
    ctl = nt.Control(joint_target_q=torch.zeros(2, 2),
                     joint_target_qd=torch.zeros(2, 2),
                     joint_f=torch.zeros(2, 2),
                     tendon_f=torch.tensor([[0.0], [1.5]]))
    tau, _ = t_batched._applied_tau(solver.tables, q, qd, ctl)
    f = -30.0 * (2.0 * q[:, 1] - 0.1) - 4.0 * 2.0 * qd[:, 1] \
        + ctl.tendon_f[:, 0]
    torch.testing.assert_close(tau[:, 1], 2.0 * f)
    torch.testing.assert_close(tau[:, 0], torch.zeros(2))
