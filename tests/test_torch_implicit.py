"""Parity: the port's implicit integrators (``integrator="implicitfast"``:
M + dt (Kd + D) with the fixed tendons' kd c c^T, the actuators' velocity
gains and the spatial tendons' kd J^T J, through B1; ``"implicit"``: plus
the Coriolis derivative d bias / d qd, solved by LU, with B2 in its
non-symmetric form) against the JAX package's, and B2's plain twin with a
non-symmetric Minv against the reference's math.

Tolerances: the double pendulum under the four integrators over 200 steps
of 2 ms within 1e-5 rad of the JAX package's trajectory (its MuJoCo-C gate
is 5e-5); the stiff tendon-damped pair (tests/test_parity_mujoco.py:302)
within 2e-4 of the JAX package's implicitfast, and settled; the humanoid
substep at the ant's (joint_q/body_q 2e-4, joint_qd 5e-3); the Coriolis
derivative 1e-4 relative to its largest entry; B2's twin within 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.solvers.generalized import batched as t_batched
from newton_tpu_torch.solvers.generalized import pgs
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
TENDON_DAMPED = """
<mujoco model="tendon_damped">
  <option gravity="0 0 -9.81" timestep="0.005"/>
  <worldbody>
    <body name="a" pos="0 0 1">
      <joint name="s1" type="slide" axis="1 0 0"/>
      <geom type="sphere" size="0.05" mass="0.3"/>
      <body name="b" pos="0.4 0 0">
        <joint name="s2" type="slide" axis="1 0 0"/>
        <geom type="sphere" size="0.05" mass="0.2"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t" stiffness="40" damping="28">
      <joint joint="s1" coef="1"/>
      <joint joint="s2" coef="-1"/>
    </fixed>
  </tendon>
</mujoco>
"""
HUMANOID = os.path.join(nt.ASSET_DIR, "humanoid.xml")
DT = 1.0 / 240.0
W = 4


def _np(obj, fields):
    out = {n: None if getattr(obj, n, None) is None
           else np.asarray(getattr(obj, n)) for n in fields}
    out["custom"] = {k: np.asarray(v) for k, v in
                     getattr(obj, "custom", {}).items()}
    return out


def _port_model(tmp_path, xml, name):
    path = tmp_path / f"{name}.xml"
    path.write_text(xml)
    b = nt.ModelBuilder()
    b.add_mjcf(str(path))
    return b.finalize("cpu")


def _port_rollout(tm, q0, T, dt, integrator):
    solver = nt.SolverMuJoCo(tm, integrator=integrator)
    s = nt.eval_fk(tm, torch.as_tensor(q0, dtype=torch.float32),
                   torch.zeros(tm.joint_dof_count), tm.state())
    c = tm.control()
    qpos, qvel = [np.asarray(q0, np.float64)], []
    for _ in range(T):
        s = solver.step(s, None, c, None, dt)
        qpos.append(s.joint_q.numpy().astype(np.float64))
        qvel.append(s.joint_qd.numpy().astype(np.float64))
    return np.asarray(qpos), np.asarray(qvel)


@pytest.mark.parametrize("integ", ["euler", "implicitfast", "implicit",
                                   "rk4"])
def test_double_pendulum_matches_jax(tmp_path, integ):
    """tests/test_parity_mujoco.py:283's scene without MuJoCo: 200 steps
    from (1.2, 0.5) rad under each integrator, the port's trajectory
    against the JAX package's (``newton_rollout``)."""
    from newton_tpu.utils import parity as P
    T, dt = 200, 0.002
    q0 = np.array([1.2, 0.5])
    jm, _ = P.build_newton_model(DOUBLE)
    jx = P.newton_rollout(jm, T, dt, qpos0_mj=q0, collide=False,
                          solver_kwargs={"integrator": integ})
    qpos, _ = _port_rollout(_port_model(tmp_path, DOUBLE, "double"), q0, T,
                            dt, integ)
    assert np.abs(qpos - jx.qpos).max() < 1e-5


def test_tendon_damping_implicitfast(tmp_path):
    """The stiff tendon-damped pair (explicit damping unstable at this dt):
    implicitfast stays stable, settles and matches the JAX package's
    implicitfast within 2e-4 over 150 steps of 5 ms."""
    from newton_tpu.utils import parity as P
    T, dt = 150, 0.005
    q0 = np.array([0.2, -0.1])
    jm, _ = P.build_newton_model(TENDON_DAMPED)
    jx = P.newton_rollout(jm, T, dt, qpos0_mj=q0, collide=False,
                          solver_kwargs={"integrator": "implicitfast"})
    qpos, qvel = _port_rollout(_port_model(tmp_path, TENDON_DAMPED, "td"),
                               q0, T, dt, "implicitfast")
    assert np.isfinite(qpos).all()
    assert np.abs(qpos - jx.qpos).max() < 2e-4
    assert np.abs(qvel[-1]).max() < 0.2


def test_option_integrator_auto(tmp_path):
    """``<option integrator="implicitfast">`` is read by
    ``integrator="auto"``; an explicit integrator wins."""
    xml = DOUBLE.replace('timestep="0.002"',
                         'timestep="0.002" integrator="implicitfast"')
    tm = _port_model(tmp_path, xml, "auto")
    assert tm.structure.mjc_options["integrator"] == "implicitfast"
    assert nt.SolverMuJoCo(tm).integrator == "implicitfast"
    assert nt.SolverMuJoCo(tm, integrator="rk4").integrator == "rk4"


@pytest.fixture(scope="module")
def hum():
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.parallel import batch_state as j_batch_state
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jb = jt.ModelBuilder()
    jb.add_mjcf(HUMANOID)
    jm = jb.finalize()
    b = nt.ModelBuilder()
    b.add_mjcf(HUMANOID)
    tm = b.finalize("cpu")
    rng = np.random.RandomState(30)
    q = np.tile(np.asarray(jm.joint_q0), (W, 1)) \
        + 0.02 * rng.randn(W, 24).astype(np.float32)
    q[:, 2] -= 0.15
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    qd = (0.5 * rng.randn(W, 23)).astype(np.float32)
    sb = jax.vmap(lambda a, b_, s: j_eval_fk(jm, a, b_, s))(
        jnp.asarray(q), jnp.asarray(qd), j_batch_state(jm.state(), W))
    ctrl = rng.uniform(-0.4, 0.4, (W, 17)).astype(np.float32)
    control = jm.control()
    cb = jax.vmap(lambda cv: control.replace(
        custom={**control.custom, "mjc:ctrl": cv}))(jnp.asarray(ctrl))
    contacts = jax.jit(jax.vmap(JPipe(jm).collide))(sb)

    class NS:
        pass
    ns = NS()
    ns.jm, ns.tm, ns.sb, ns.cb, ns.contacts = jm, tm, sb, cb, contacts
    ns.s = bridge.state_from_numpy(_np(sb, bridge.STATE_FIELDS), "cpu")
    ns.c = bridge.control_from_numpy(_np(cb, bridge.CONTROL_FIELDS), "cpu")
    ns.ct = bridge.contacts_from_numpy(_np(contacts, bridge.CONTACT_FIELDS),
                                       "cpu")
    return ns


def test_humanoid_implicit_matches_jax(hum):
    """One substep of W = 4 humanoids at the floor (contacts and limit rows
    active, random ctrl and rates) under ``integrator="implicit"``: the
    port's ``step_batched`` (LU, B2's non-symmetric form) against the JAX
    package's (the vmapped per-env ``step``)."""
    import jax
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    assert np.asarray(hum.contacts.rigid_contact_mask).sum(1).min() > 0
    js = JSolver(hum.jm, iterations=8, integrator="implicit")
    ts = nt.SolverMuJoCo(hum.tm, iterations=8, integrator="implicit")
    ref = jax.jit(lambda s, c, ct: js.step_batched(s, None, c, ct, DT))(
        hum.sb, hum.cb, hum.contacts)
    rec = {}
    got = ts.step_batched(hum.s, None, hum.c, hum.ct, DT, record=rec)
    assert rec["pgs"][1]["symmetric"] is False and "chol" not in rec
    for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                       ("body_q", 2e-4)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=atol, err_msg=name)


def test_coriolis_derivative_matches_jacfwd(hum):
    """The port's d bias / d qd blocks (one forward pass, d tangents)
    against ``jax.jacfwd`` of the JAX package's velocity FK + RNEA over the
    humanoid's 23 dofs, per env."""
    import jax
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.solvers.generalized.dynamics import (dof_subspace,
                                                          group_bias_forces)
    jm = hum.jm
    ts = nt.SolverMuJoCo(hum.tm, integrator="implicit")
    grp = ts.groups[0]
    t = grp.tables
    s = hum.s
    v_o, w_o = t_batched._dof_subspace(t, s.body_q, s.joint_q)
    x_b, Iw = t_batched._spatial_inertia(grp.row_model, s.body_q)
    got = t_batched._bias_jacobian(t, grp.row_model, s.body_qd, v_o, w_o,
                                   x_b, Iw).numpy()
    def jac(st):
        vo, wo = dof_subspace(jm, st.body_q, st.joint_q)

        def bias_of(qd):
            s2 = j_eval_fk(jm, st.joint_q, qd, st)
            return group_bias_forces(jm, st.body_q, s2.body_qd, vo, wo)
        return jax.jacfwd(bias_of)(st.joint_qd)
    ref = np.asarray(jax.jit(jax.vmap(jac))(hum.sb))
    for e in range(W):
        assert np.abs(got[e] - ref[e]).max() < 1e-4 * np.abs(ref[e]).max()


@pytest.mark.parametrize("c,nl,d", [(4, 2, 6), (25, 8, 14)])
def test_pgs_twin_nonsymmetric_matches_reference(c, nl, d):
    """B2's twin with a non-symmetric Minv (``symmetric=False``) against
    the reference's math: the JAX package's ``pgs_core`` on ``MinvJt =
    Minv J^T`` (solver.py:1262-1263) with the limit columns Minv[:, ld],
    lam and dqd within 1e-5; the symmetric form (J Minv) differs."""
    import jax.numpy as jnp
    from newton_tpu.solvers.generalized.pgs_pallas import pgs_core
    rng = np.random.RandomState(c + nl)
    n = 3
    r = 3 * c + 2 * nl
    A = rng.randn(n, d, d)
    M = A @ A.transpose(0, 2, 1) + d * np.eye(d) + 0.3 * rng.randn(n, d, d)
    Minv = np.linalg.inv(M).astype(np.float32)          # not symmetric
    J = rng.randn(n, 3 * c, d).astype(np.float32)
    qd = rng.randn(n, d).astype(np.float32)
    b = np.abs(rng.randn(n, r)).astype(np.float32)
    act = (rng.rand(n, r) > 0.3).astype(np.float32)
    mu = rng.rand(n, c).astype(np.float32)
    ld = np.arange(d - nl, d)
    kw = dict(c=c, iters=8, omega=0.85, use_cone=False, diag_scale=1.1,
              reg=1e-6)
    T = [torch.as_tensor(x) for x in (J, Minv, qd, b, act, mu,
                                      np.zeros((n, r), np.float32))]
    lam, dqd = pgs.pgs_solve_fused_plain(
        *T, ld=torch.as_tensor(ld, dtype=torch.int32), symmetric=False, **kw)
    # the reference: MinvJt = Minv J^T, rows on the minor axis
    MinvJt = np.einsum("nde,nre->ndr", Minv, J)
    MJ = np.transpose(MinvJt, (2, 1, 0))                # (3c, d, n)
    Jm = np.transpose(J, (1, 2, 0))
    cols = np.transpose(Minv[:, :, ld], (1, 2, 0))      # (d, nl, n)
    diag = np.concatenate([
        np.einsum("nrd,ndr->nr", J, MinvJt) * 1.1 + 1e-6,
        np.tile(Minv[:, ld, ld] * 1.1 + 1e-6, 2)], 1).T
    v_free = np.concatenate([np.einsum("nrd,nd->nr", J, qd), qd[:, ld],
                             -qd[:, ld]], 1).T
    lam_r, dqd_r = pgs_core(
        jnp.asarray(Jm), jnp.asarray(MJ), jnp.asarray(cols),
        jnp.asarray(diag), jnp.asarray(v_free), jnp.asarray(b.T),
        jnp.asarray(act.T), jnp.asarray(mu.T), jnp.zeros((r, n)), c=c,
        nl=nl, ld=tuple(int(x) for x in ld), iters=8, omega=0.85,
        use_cone=False)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_r).T, atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(dqd.numpy(), np.asarray(dqd_r).T, atol=1e-5,
                               rtol=1e-4)
    lam_s, _ = pgs.pgs_solve_fused_plain(
        *T, ld=torch.as_tensor(ld, dtype=torch.int32), **kw)
    assert (lam_s - lam).abs().max() > 1e-4


@pytest.mark.gpu
@pytest.mark.skipif("not torch.cuda.is_available()", reason="needs CUDA")
@pytest.mark.parametrize("c,nl,d", [(25, 8, 14), (32, 17, 23), (40, 6, 20)])
def test_pgs_kernel_nonsymmetric_matches_twin(c, nl, d):
    """B2's kernel with a non-symmetric Minv (minv_t = 1) against its plain
    twin on the card, in the register (d = 14, 23) and shared-memory
    instances: lam and dqd within atol 1e-5, rtol 1e-4."""
    dev = torch.device("cuda")
    rng = np.random.RandomState(d)
    n = 256
    r = 3 * c + 2 * nl
    A = rng.randn(n, d, d)
    M = A @ A.transpose(0, 2, 1) + d * np.eye(d) + 0.3 * rng.randn(n, d, d)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                               device=dev)
    args = (t(rng.randn(n, 3 * c, d)), t(np.linalg.inv(M)),
            t(rng.randn(n, d)), t(np.abs(rng.randn(n, r))),
            t(rng.rand(n, r) > 0.3), t(rng.rand(n, c)), t(np.zeros((n, r))))
    kw = dict(c=c, ld=torch.arange(d - nl, d, dtype=torch.int32, device=dev),
              iters=8, omega=0.85, use_cone=False, diag_scale=1.1, reg=1e-6,
              symmetric=False, return_halvings=True)
    lam, dqd, h = pgs.pgs_solve_fused(*args, **kw)
    lam_p, dqd_p, h_p = pgs.pgs_solve_fused_plain(*args, **kw)
    same = h == h_p
    assert same.float().mean() > 0.95
    torch.testing.assert_close(lam[same], lam_p[same], atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(dqd[same], dqd_p[same], atol=1e-5, rtol=1e-4)
