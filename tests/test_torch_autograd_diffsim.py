"""Gradients of the port against ``jax.grad`` of the JAX package on the
CPU for the five diffsim examples (ball, cloth, soft body and spring cage
on SolverXPBD, the drone on SolverSemiImplicit) at a horizon of two
frames of four substeps, each scene built by the same function from
either package's ModelBuilder, each with respect to the example's own
parameter.

Tolerance: the port's gradient against JAX's normwise 1e-3 relative
(float32; XPBD's sweeps and the contact projections run in another
association); the losses 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newton_tpu as jt
from newton_tpu.math.quat import quat_rotate as j_quat_rotate
from newton_tpu.sim.articulation import eval_fk as j_eval_fk
from newton_tpu.sim.collide import CollisionPipeline as JPipe
from newton_tpu.solvers import SolverSemiImplicit as JSemi
from newton_tpu.solvers import SolverXPBD as JXPBD

import newton_tpu_torch as nt
from newton_tpu_torch.math.quat import quat_rotate as t_quat_rotate
from test_torch_autograd_scenes import DT, _fin, _rel

torch.set_num_threads(1)

FRAMES, SUB = 2, 4


def _ball(lib):
    b = lib.ModelBuilder()
    body = b.add_body(xform=[0, 0, 0.6, 0, 0, 0, 1], key="ball")
    b.add_shape_sphere(body, radius=0.25,
                       cfg=lib.ShapeConfig(restitution=0.6))
    b.add_joint_free(body)
    b.add_ground_plane()
    return _fin(lib, b)


def _cloth(lib):
    b = lib.ModelBuilder(gravity=-9.81)
    b.add_cloth_grid(pos=[-0.2, -0.2, 0.6], dim_x=5, dim_y=5, cell_x=0.08,
                     cell_y=0.08, mass=0.2, radius=0.02, tri_ke=200.0,
                     tri_ka=200.0, tri_kd=5.0, edge_ke=0.2)
    b.add_ground_plane(cfg=lib.ShapeConfig(mu=0.4))
    return _fin(lib, b)


def _soft(lib):
    b = lib.ModelBuilder(gravity=-9.81)
    b.add_soft_grid(pos=[-0.15, -0.15, 0.0], rot=None, vel=[0, 0, 0],
                    dim_x=3, dim_y=3, dim_z=3, cell_x=0.1, cell_y=0.1,
                    cell_z=0.1, density=300.0, k_mu=2e3, k_lambda=2e4,
                    k_damp=2.0, radius=0.03)
    shelf = b.add_body(xform=[0.9, 0.0, 0.2, 0, 0, 0, 1], kinematic=True,
                       key="shelf")
    b.add_shape_box(shelf, hx=0.3, hy=0.4, hz=0.2)
    b.add_ground_plane()
    return _fin(lib, b)


def _cage(lib):
    b = lib.ModelBuilder(gravity=-2.0)
    corners = [b.add_particle((0.5 * sx, 0.5 * sy, 0.1 + 0.9 * sz),
                              mass=0.0)
               for sx in (-1, 1) for sy in (-1, 1) for sz in (0, 1)]
    center = b.add_particle((0.0, 0.0, 0.5), mass=1.0)
    for c in corners:
        b.add_spring(c, center, ke=30.0, kd=1.5)
    return _fin(lib, b), center


def _drone(lib):
    b = lib.ModelBuilder(gravity=-9.81)
    body = b.add_body(xform=[0, 0, 0.2, 0, 0, 0, 1], key="drone")
    b.add_shape_box(body, hx=0.1, hy=0.1, hz=0.02,
                    cfg=lib.ShapeConfig(density=500.0))
    b.add_joint_free(body)
    return _fin(lib, b)


def _jax_rollout(solver, pipe, m, s, n, model=None):
    def sub(s, _):
        c = pipe.collide(s) if pipe is not None else None
        kw = {} if model is None else dict(model=model)
        return solver.step(s, None, m.control(), c, DT, **kw), None
    return jax.lax.scan(sub, s, None, length=n)[0]


def _torch_rollout(solver, pipe, m, s, n, model=None):
    kw = {} if model is None else dict(model=model)
    for _ in range(n):
        c = pipe.collide(s) if pipe is not None else None
        s = solver.step(s, None, m.control(), c, DT, **kw)
    return s


def _xpbd(lib, m, **kw):
    return (JXPBD if lib is jt else nt.SolverXPBD)(m, **kw)


def _pipe(lib, m):
    return (JPipe if lib is jt else nt.CollisionPipeline)(m)


def _diff_scene(name):
    """(jax loss, torch loss, parameter) of one diffsim example."""
    n = FRAMES * SUB
    if name == "ball":
        target = np.array([1.5, 0.0, 0.25], np.float32)
        jm, tm = _ball(jt), _ball(nt)
        js, ts = (_xpbd(l, m, iterations=2, enable_restitution=True)
                  for l, m in ((jt, jm), (nt, tm)))
        jp, tp = _pipe(jt, jm), _pipe(nt, tm)

        def jl(v0):
            s = j_eval_fk(jm, jm.joint_q0, jm.joint_qd0.at[:3].set(v0),
                          jm.state())
            s = _jax_rollout(js, jp, jm, s, n)
            return jnp.sum((s.body_q[0, :3] - target) ** 2)

        def tl(v0):
            s = nt.eval_fk(tm, tm.joint_q0,
                           torch.cat([v0, tm.joint_qd0[3:]]), tm.state())
            s = _torch_rollout(ts, tp, tm, s, n)
            return ((s.body_q[0, :3] - torch.as_tensor(target)) ** 2).sum()
        return jl, tl, np.array([1.0, 0.0, 1.0], np.float32)
    if name in ("cloth", "soft_body"):
        build = _cloth if name == "cloth" else _soft
        target = (np.array([1.1, 0.0], np.float32) if name == "cloth"
                  else np.array([0.9, 0.0, 0.45], np.float32))
        k = len(target)
        jm, tm = build(jt), build(nt)
        js, ts = (_xpbd(l, m, iterations=4) for l, m in ((jt, jm), (nt, tm)))
        jp, tp = _pipe(jt, jm), _pipe(nt, tm)

        def jl(v0):
            s = jm.state()
            v = jnp.concatenate([v0, jnp.zeros(3 - k)])
            s = s.replace(particle_qd=jnp.broadcast_to(
                v, s.particle_qd.shape).astype(s.particle_qd.dtype))
            s = _jax_rollout(js, jp, jm, s, n)
            return jnp.sum((jnp.mean(s.particle_q[:, :k], axis=0)
                            - target) ** 2)

        def tl(v0):
            s = tm.state()
            v = torch.cat([v0, torch.zeros(3 - k)])
            s = s.replace(particle_qd=v.expand(s.particle_qd.shape))
            s = _torch_rollout(ts, tp, tm, s, n)
            return ((s.particle_q[:, :k].mean(0)
                     - torch.as_tensor(target)) ** 2).sum()
        v0 = (np.array([0.5, 0.3], np.float32) if name == "cloth"
              else np.array([1.5, 0.0, 2.0], np.float32))
        return jl, tl, v0
    if name == "spring_cage":
        target = np.array([0.15, 0.1, 0.55], np.float32)
        (jm, cj), (tm, ct) = _cage(jt), _cage(nt)
        js, ts = (_xpbd(l, m, iterations=4) for l, m in ((jt, jm), (nt, tm)))

        def jl(rest):
            m = jm.replace(spring_rest_length=rest)
            s = _jax_rollout(js, None, m, m.state(), n, model=m)
            return jnp.sum((s.particle_q[cj] - target) ** 2)

        def tl(rest):
            m = tm.replace(spring_rest_length=rest)
            s = _torch_rollout(ts, None, m, m.state(), n, model=m)
            return ((s.particle_q[ct] - torch.as_tensor(target)) ** 2).sum()
        return jl, tl, np.asarray(jm.spring_rest_length) * np.float32(0.8)
    # the drone: a piecewise thrust schedule through body_f
    arm = 0.12
    rotors = np.array([[arm, 0, 0.02], [-arm, 0, 0.02], [0, arm, 0.02],
                       [0, -arm, 0.02]], np.float32)
    way = np.array([0.6, 0.0, 0.8], np.float32)
    jm, tm = _drone(jt), _drone(nt)
    js, ts = JSemi(jm), nt.SolverSemiImplicit(tm)

    def jl(thrusts):
        s = jm.state()
        for i in range(n):
            t = thrusts[min(i * thrusts.shape[0] // n,
                            thrusts.shape[0] - 1)]
            q = s.body_q[0, 3:7]
            f = j_quat_rotate(q, jnp.array([0.0, 0.0, 1.0]))[None] \
                * t[:, None]
            r = jax.vmap(lambda p: j_quat_rotate(q, p))(jnp.asarray(rotors))
            tau = jnp.sum(jnp.cross(r, f), axis=0) - 0.02 * s.body_qd[0, 3:6]
            f_tot = jnp.sum(f, axis=0) - 0.08 * s.body_qd[0, 0:3]
            s = s.replace(body_f=jnp.concatenate([f_tot, tau])[None])
            s = js.step(s, None, jm.control(), None, DT)
        return jnp.sum((s.body_q[0, :3] - way) ** 2) \
            + 0.05 * jnp.sum(s.body_qd[0] ** 2)

    def tl(thrusts):
        s = tm.state()
        for i in range(n):
            t = thrusts[min(i * thrusts.shape[0] // n,
                            thrusts.shape[0] - 1)]
            q = s.body_q[0, 3:7]
            f = t_quat_rotate(q, torch.tensor([0.0, 0.0, 1.0]))[None] \
                * t[:, None]
            r = t_quat_rotate(q.expand(4, 4), torch.as_tensor(rotors))
            tau = torch.cross(r, f, dim=-1).sum(0) - 0.02 * s.body_qd[0, 3:6]
            f_tot = f.sum(0) - 0.08 * s.body_qd[0, 0:3]
            s = s.replace(body_f=torch.cat([f_tot, tau])[None])
            s = ts.step(s, None, tm.control(), None, DT)
        return ((s.body_q[0, :3] - torch.as_tensor(way)) ** 2).sum() \
            + 0.05 * (s.body_qd[0] ** 2).sum()
    mass = float(np.asarray(jm.body_mass)[0])
    rng = np.random.RandomState(5)
    thrusts = (mass * 9.81 / 4.0 * (1 + 0.1 * rng.randn(2, 4))).astype(
        np.float32)
    return jl, tl, thrusts


@pytest.mark.parametrize("name", ["ball", "cloth", "soft_body",
                                  "spring_cage", "drone"])
def test_diffsim_gradient_matches_jax(name):
    """The example's loss and its gradient with respect to the example's
    parameter (launch velocity, cloth and soft-body velocity, spring rest
    lengths through ``step(..., model=)``, the thrust schedule)."""
    jl, tl, p0 = _diff_scene(name)
    lj, gj = jax.jit(jax.value_and_grad(jl))(jnp.asarray(p0))
    p = torch.tensor(p0, requires_grad=True)
    loss = tl(p)
    loss.backward()
    g = p.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    lj = float(lj)
    assert abs(float(loss.detach()) - lj) <= 1e-5 * max(1.0, abs(lj))
    assert _rel(g, gj) < 1e-3, (g, np.asarray(gj))
