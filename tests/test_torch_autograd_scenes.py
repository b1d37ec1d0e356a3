"""Gradients of the port against ``jax.grad`` of the JAX package on the
CPU, outside the ant: the three scenes of tests/test_differentiability.py
(a Featherstone pendulum driven by joint_f, a sphere pushed out of the
ground by XPBD through the static collide, two links coupled by a fixed
tendon) with each JAX test's own analytic or finite-difference assertion,
each scene built by the same function from either package's
ModelBuilder (tests/test_torch_autograd_diffsim.py holds the diffsim
examples).

Tolerances: the port's gradient against JAX's normwise 1e-3 relative
(float32; XPBD's sweeps and the contact projections run in another
association), the JAX tests' own 5% and 2% on the analytic and
finite-difference values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import newton_tpu as jt
from newton_tpu.sim.articulation import eval_fk as j_eval_fk
from newton_tpu.sim.collide import CollisionPipeline as JPipe
from newton_tpu.solvers import SolverFeatherstone as JFeather
from newton_tpu.solvers import SolverXPBD as JXPBD

import newton_tpu_torch as nt

torch.set_num_threads(1)

DT = 1.0 / 240.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _fin(lib, b):
    return b.finalize() if lib is jt else b.finalize("cpu")


# --- tests/test_differentiability.py -----------------------------------

def _pendulum(lib):
    b = lib.ModelBuilder()
    link = b.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1])
    b.add_shape_box(link, hx=0.5, hy=0.05, hz=0.05)
    b.add_joint_revolute(parent=-1, child=link, axis="Y",
                         xform_c=[-0.5, 0, 0, 0, 0, 0, 1], armature=0.0)
    return _fin(lib, b)


def test_grad_through_generalized_step():
    jm, tm = _pendulum(jt), _pendulum(nt)
    js, ts = JFeather(jm), nt.SolverFeatherstone(tm)
    s0j = j_eval_fk(jm, jnp.zeros(1), jnp.zeros(1), jm.state())
    s0t = nt.eval_fk(tm, torch.zeros(1), torch.zeros(1), tm.state())

    def jloss(tau):
        c, s = jm.control().replace(joint_f=tau), s0j
        for _ in range(3):
            s = js.step(s, None, c, None, DT)
        return s.joint_qd[0]
    gj = np.asarray(jax.jit(jax.grad(jloss))(jnp.zeros(1)))
    tau = torch.zeros(1, requires_grad=True)
    c, s = tm.control().replace(joint_f=tau), s0t
    for _ in range(3):
        s = ts.step(s, None, c, None, DT)
    s.joint_qd[0].backward()
    g = tau.grad.numpy()
    M = 0.84166664 + 10.0 * 0.25
    np.testing.assert_allclose(g, [3 * DT / M], rtol=0.05)
    assert _rel(g, gj) < 1e-3


def _sphere(lib):
    b = lib.ModelBuilder()
    body = b.add_body(xform=[0, 0, 0.45, 0, 0, 0, 1])
    b.add_shape_sphere(body, radius=0.5)
    b.add_joint_free(body)
    b.add_ground_plane()
    return _fin(lib, b)


def test_grad_through_contact_step():
    jm, tm = _sphere(jt), _sphere(nt)
    js, jp = JXPBD(jm, iterations=2), JPipe(jm)
    ts, tp = nt.SolverXPBD(tm, iterations=2), nt.CollisionPipeline(tm)

    def jloss(z0):
        s = jm.state()
        s = s.replace(body_q=s.body_q.at[0, 2].set(z0),
                      joint_q=s.joint_q.at[2].set(z0))
        for _ in range(2):
            s = js.step(s, None, jm.control(), jp.collide(s), DT)
        return s.body_q[0, 2]
    gj = float(jax.jit(jax.grad(jloss))(jnp.asarray(0.45, jnp.float32)))

    def tloss(z0):
        s = tm.state()
        bq, q = s.body_q.clone(), s.joint_q.clone()
        bq[0, 2] = z0
        q[2] = z0
        s = s.replace(body_q=bq, joint_q=q)
        for _ in range(2):
            s = ts.step(s, None, tm.control(), tp.collide(s), DT)
        return s.body_q[0, 2]
    z = torch.tensor(0.45, requires_grad=True)
    tloss(z).backward()
    g = float(z.grad)
    eps = 1e-3
    with torch.no_grad():
        fd = float(tloss(torch.tensor(0.45 + eps))
                   - tloss(torch.tensor(0.45 - eps))) / (2 * eps)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, atol=0.05)
    assert _rel(g, gj) < 1e-3


def _tendon_pair(lib):
    b = lib.ModelBuilder()
    l1 = b.add_body(xform=[0.5, 0, 1, 0, 0, 0, 1])
    b.add_shape_box(l1, hx=0.4, hy=0.05, hz=0.05)
    b.add_joint_revolute(-1, l1, axis="Y", xform_p=[0, 0, 1, 0, 0, 0, 1],
                         xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
    l2 = b.add_body(xform=[1.5, 0, 1, 0, 0, 0, 1])
    b.add_shape_box(l2, hx=0.4, hy=0.05, hz=0.05)
    b.add_joint_revolute(-1, l2, axis="Y", xform_p=[1, 0, 1, 0, 0, 0, 1],
                         xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
    b.add_tendon_fixed([0, 1], [1.0, -1.0], stiffness=50.0, damping=1.0)
    return _fin(lib, b)


def test_grad_through_tendon_actuation():
    jm, tm = _tendon_pair(jt), _tendon_pair(nt)
    js, ts = JFeather(jm), nt.SolverFeatherstone(tm)
    s0j = j_eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state())
    s0t = nt.eval_fk(tm, tm.joint_q0, tm.joint_qd0, tm.state())

    def jloss(tf):
        c = jm.control().replace(tendon_f=tf)
        s = jax.lax.scan(lambda s, _: (js.step(s, None, c, None, DT), None),
                         s0j, None, length=20)[0]
        return s.joint_q[0] - s.joint_q[1]
    gj = float(jax.jit(jax.grad(jloss))(jnp.zeros(1))[0])

    def tloss(tf):
        c, s = tm.control().replace(tendon_f=tf), s0t
        for _ in range(20):
            s = ts.step(s, None, c, None, DT)
        return s.joint_q[0] - s.joint_q[1]
    tf = torch.zeros(1, requires_grad=True)
    tloss(tf).backward()
    g = float(tf.grad[0])
    e = 1e-2
    with torch.no_grad():
        fd = float(tloss(torch.tensor([e])) - tloss(torch.tensor([-e]))) \
            / (2 * e)
    assert np.isfinite(g)
    assert abs(fd - g) / max(abs(fd), 1e-12) < 0.02
    assert _rel(g, gj) < 1e-3
