"""Gradients through the port's collide + step_batched on gymnasium's ant
(the slice's main path at small size) against ``jax.grad`` of the JAX
package's, both on the CPU, where the JAX package's XLA branch stands in
for its Pallas kernels and the port's plain versions for its CUDA ones.

The scene: W = 4 ants, roots 0.08 into the ground (contact rows active
from the first substep), SolverMuJoCo(iterations=8, integrator="euler"),
static collide before each substep, dt = 1/240. Loss: -mean(root x after
the substeps) + 1e-3 mean(u^2), u the MJCF ctrl of each substep.

Tolerances (float32 on both sides): gradients normwise 1e-4 relative to
the JAX gradient (the port matches JAX's forward to ~1e-6 per substep,
and the sweeps' reassociation compounds through the backward); the Adam
runs' losses 1e-5 absolute.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newton_tpu as jt
from newton_tpu.parallel import batch_state as j_batch_state
from newton_tpu.sim.articulation import eval_fk as j_eval_fk
from newton_tpu.sim.collide import CollisionPipeline as JPipe
from newton_tpu.solvers import SolverMuJoCo as JSolver

import newton_tpu_torch as nt

torch.set_num_threads(1)

W = 4
DT = 1.0 / 240.0
SUBSTEPS = 2
U_COST = 1e-3
ANT = os.path.join(nt.ASSET_DIR, "ant.xml")


def _start():
    rng = np.random.RandomState(19)
    jb = jt.ModelBuilder()
    jb.add_mjcf(ANT)
    q = np.tile(np.asarray(jb.finalize().joint_q0), (W, 1)) \
        + 0.02 * rng.randn(W, 15)
    q[:, 2] -= 0.08
    qd = 0.1 * rng.randn(W, 14)
    u = rng.uniform(-1, 1, (W, SUBSTEPS, 8))
    return (q.astype(np.float32), qd.astype(np.float32),
            u.astype(np.float32))


@pytest.fixture(scope="module")
def ant():
    jb = jt.ModelBuilder()
    jb.add_mjcf(ANT)
    jm = jb.finalize()
    js = JSolver(jm, iterations=8, integrator="euler")
    jp = JPipe(jm)
    control = jm.control()
    q0, _, _ = _start()

    def jloss(u, qd):
        s = jax.vmap(lambda a, b, st: j_eval_fk(jm, a, b, st))(
            jnp.asarray(q0), qd, j_batch_state(jm.state(), W))
        for k in range(SUBSTEPS):
            cb = jax.vmap(lambda cv: control.replace(
                custom={**control.custom, "mjc:ctrl": cv}))(u[:, k])
            s = js.step_batched(s, None, cb, jax.vmap(jp.collide)(s), DT)
        return -jnp.mean(s.joint_q[:, 0]) + U_COST * jnp.mean(u * u)

    tb = nt.ModelBuilder()
    tb.add_mjcf(ANT)
    tm = tb.finalize("cpu")

    class NS:
        pass
    ns = NS()
    ns.jgrad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))
    ns.tm = tm
    ns.solver = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    ns.pipe = nt.CollisionPipeline(tm)
    return ns


def _torch_loss(ns, u, qd, q0, active=None):
    tm = ns.tm
    s = nt.eval_fk(tm, torch.as_tensor(q0), qd,
                   nt.batch_state(tm.state(), W))
    c = tm.control()
    for k in range(SUBSTEPS):
        ctl = nt.Control(
            joint_target_q=c.joint_target_q.expand(W, -1).clone(),
            joint_target_qd=torch.zeros(W, 14), joint_f=torch.zeros(W, 14),
            custom={"mjc:ctrl": u[:, k]})
        contacts = ns.pipe.collide(s)
        if active is not None:
            active.append(contacts.rigid_contact_mask.any(1))
        s = ns.solver.step_batched(s, None, ctl, contacts, DT)
    return -s.joint_q[:, 0].mean() + U_COST * (u * u).mean()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_ant_gradient_matches_jax(ant):
    """d loss / d (ctrl, initial joint_qd) through collide, the B1 and B2
    plain versions, RNEA, CRBA and MJCF actuation, against jax.grad."""
    q0, qd0, u0 = _start()
    lj, (gu_j, gqd_j) = ant.jgrad(jnp.asarray(u0), jnp.asarray(qd0))
    u = torch.tensor(u0, requires_grad=True)
    qd = torch.tensor(qd0, requires_grad=True)
    active = []
    loss = _torch_loss(ant, u, qd, q0, active)
    loss.backward()
    assert all(bool(a.all()) for a in active)       # every world touches
    assert abs(float(loss.detach()) - float(lj)) < 1e-5
    assert np.isfinite(u.grad.numpy()).all()
    assert _rel(u.grad.numpy(), gu_j) < 1e-4
    assert _rel(qd.grad.numpy(), gqd_j) < 1e-4


def test_ant_adam_matches_jax(ant):
    """Three Adam steps (lr 0.05) on u lower the loss in both packages
    alike: the port's torch.optim.Adam against the same update written
    out on the JAX gradients."""
    q0, qd0, u0 = _start()
    u0 = (0.5 * u0[:, ::-1]).copy()
    u = torch.tensor(u0, requires_grad=True)
    opt = torch.optim.Adam([u], lr=0.05)
    qd = torch.as_tensor(qd0)
    lt = []
    for _ in range(3):
        opt.zero_grad()
        loss = _torch_loss(ant, u, qd, q0)
        loss.backward()
        lt.append(float(loss.detach()))
        opt.step()
    uj, m, v, lj = u0.astype(np.float64), 0.0, 0.0, []
    for k in range(1, 4):
        val, (g, _) = ant.jgrad(jnp.asarray(uj, jnp.float32),
                                jnp.asarray(qd0))
        lj.append(float(val))
        g = np.asarray(g, np.float64)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        uj = uj - 0.05 * (m / (1 - 0.9 ** k)) / (
            np.sqrt(v / (1 - 0.999 ** k)) + 1e-8)
    assert lt[-1] < lt[0] and lj[-1] < lj[0]
    np.testing.assert_allclose(lt, lj, atol=1e-5)
    np.testing.assert_allclose(u.detach().numpy(), uj, atol=1e-4)
