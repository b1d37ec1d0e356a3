"""The port's inverse kinematics (``newton_tpu_torch.ik``) against the JAX
package on the CPU: the forward-mode Jacobian against ``jax.jacfwd``;
one Levenberg-Marquardt step with each objective (position, rotation,
soft joint limits, a duck-typed custom objective) from the same seeds;
whole solves of bench_ik's chain reaching their targets in both packages;
ROBERTS seeds bit for bit; BFGS against ``jax.scipy.optimize.minimize``;
tests/test_utils.py:87, 123 and 224 on the port; example_ik_custom.py's
custom objective on the port.

Tolerances: IK q 1e-4 where both packages accept the same LM steps (one
step from seeds away from the chain's singular straight pose); the
Jacobian 1e-4 of its scale; BFGS q 1e-4. Over 16 steps lambda falls to
1e-8 along the redundant chain's null space, where last-bit differences
of J grow, so whole solves are held to the tip gate (0.02,
tests/test_utils.py:87), not to q.
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.ik import (IKObjectivePosition, IKObjectiveRotation,
                                 IKSampling, IKSolver)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (bench_ik's chain, phase 28)

torch.set_num_threads(1)

TABLE_Z = 0.9


def _arm(lib, n, axis="Z", z=0.0, gravity=-9.81):
    """n 1 m links on revolute joints about ``axis``, the first at (0, 0,
    z)."""
    b = lib.ModelBuilder(gravity=gravity)
    prev = -1
    for i in range(n):
        link = b.add_body(xform=[0.5 + i, 0, z, 0, 0, 0, 1])
        b.add_shape_capsule(link, radius=0.04, half_height=0.45)
        b.add_joint_revolute(parent=prev, child=link, axis=axis,
                             xform_p=([0, 0, z, 0, 0, 0, 1] if prev < 0
                                      else [0.5, 0, 0, 0, 0, 0, 1]),
                             xform_c=[-0.5, 0, 0, 0, 0, 0, 1],
                             limit_lower=-1.0, limit_upper=1.0)
        prev = link
    return b


class ElbowAbovePlane:
    """example_ik_custom.py's custom objective in the port's batched form:
    penalize link ``link`` dipping below z = TABLE_Z."""

    n_residuals = 1

    def __init__(self, link, weight=4.0, lib="port"):
        self.link, self.weight, self.lib = link, weight, lib

    def residual(self, model, body_q, target):
        if self.lib == "jax":
            import jax.numpy as jnp
            z = body_q[self.link][2]
            return self.weight * jnp.minimum(z - TABLE_Z, 0.0)[None] \
                + 0.0 * target[..., :1]
        z = body_q[..., self.link, 2]
        return self.weight * torch.clamp(z - TABLE_Z, max=0.0)[..., None] \
            + 0.0 * target[..., :1]


def _objectives(kind, lib, last=1):
    if lib == "jax":
        from newton_tpu.ik import (IKObjectivePosition as P,
                                   IKObjectiveRotation as R)
    else:
        P, R = IKObjectivePosition, IKObjectiveRotation
    if kind == "position":
        return [P(link=last, offset=(0.5, 0, 0))], ["pos"]
    if kind == "rotation":
        return [R(link=last)], ["quat"]
    if kind == "custom":
        return [P(link=last, offset=(0.5, 0, 0)),
                ElbowAbovePlane(0, lib=lib)], ["pos", "zero"]
    return [P(link=last, offset=(0.5, 0, 0), weight=0.5)], ["pos"]


def _targets(kind, n, rng):
    out = {}
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.6, 1.8, n)
    out["pos"] = np.stack([rad * np.cos(ang), 0 * ang,
                           1.0 + rad * np.sin(ang)], -1).astype(np.float32)
    th = rng.uniform(-1.0, 1.0, n)
    out["quat"] = np.stack([0 * th, np.sin(th / 2), 0 * th, np.cos(th / 2)],
                           -1).astype(np.float32)
    out["zero"] = np.zeros((n, 1), np.float32)
    return out


@pytest.mark.parametrize("kind", ["position", "rotation", "limits",
                                  "custom"])
def test_one_lm_step_matches_jax(kind):
    """One LM step of a 2-link arm about Y (z = 1; rotation: of its
    last link about Y, a 1-dof task on 2 dofs) from four seeds away from
    the straight pose, 32 problems: q within 1e-4 of the JAX package's
    (the JAX solver gets each seed as its q0)."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.ik import IKSolver as JIK
    rng = np.random.RandomState(0)
    jm, pm = _arm(jt, 2, "Y", 1.0).finalize(), _arm(nt, 2, "Y",
                                                     1.0).finalize("cpu")
    tg = _targets(kind, 32, rng)
    seeds = rng.uniform(0.3, 1.2, (4, 2)).astype(np.float32)
    seeds[:, 1] *= np.sign(rng.randn(4)).astype(np.float32)
    lim = 0.3 if kind == "limits" else 0.0
    jo, names = _objectives(kind, "jax")
    po, _ = _objectives(kind, "port")
    jt_ = [jnp.asarray(tg[n]) for n in names]
    pt_ = [torch.as_tensor(tg[n]) for n in names]
    pik = IKSolver(pm, po, iterations=1, joint_limit_weight=lim)
    jik = JIK(jm, jo, iterations=1, joint_limit_weight=lim)
    for s in seeds:
        got = pik.solve(torch.as_tensor(s), pt_).numpy()
        ref = np.asarray(jik.solve(jnp.asarray(s), jt_))
        np.testing.assert_allclose(got, ref, atol=1e-4)


def test_jacobian_matches_jax_jacfwd():
    """The forward-mode Jacobian of the position + custom residual at 16
    random coordinates against jax.jacfwd."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.ik import IKSolver as JIK
    rng = np.random.RandomState(1)
    jm, pm = _arm(jt, 3, "Y", 1.0).finalize(), _arm(nt, 3, "Y",
                                                     1.0).finalize("cpu")
    q = rng.uniform(-2, 2, (16, 3)).astype(np.float32)
    tg = _targets("custom", 16, rng)
    jo, names = _objectives("custom", "jax")
    po, _ = _objectives("custom", "port")
    jik = JIK(jm, jo, joint_limit_weight=0.2)
    pik = IKSolver(pm, po, joint_limit_weight=0.2)
    tj = [jnp.asarray(tg[n]) for n in names]
    Jj = np.asarray(jax.jit(jax.vmap(jax.jacfwd(jik._residual)))(
        jnp.asarray(q), tj))
    rj = np.asarray(jax.jit(jax.vmap(jik._residual))(jnp.asarray(q), tj))
    r, J = pik.residual_and_jacobian(torch.as_tensor(q),
                                     [torch.as_tensor(tg[n]) for n in names])
    np.testing.assert_allclose(r.numpy(), rj, atol=1e-5)
    np.testing.assert_allclose(J.numpy(), Jj,
                               atol=1e-4 * max(np.abs(Jj).max(), 1.0))


def test_bench_chain_solves_reach_their_targets():
    """bench_ik's chain and targets (64 problems, 4 GAUSS seeds, 16
    iterations) in both packages, the same seed matrix (the JAX
    package's draw): every tip within 0.02 of its target in both."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.ik import IKObjectivePosition as JP, IKSolver as JIK
    jm = cs.ik_chain_scene(jt).finalize()
    pm = cs.ik_chain_scene(nt).finalize("cpu")
    tg = cs.ik_targets(64, 0)
    jq = np.asarray(JIK(jm, [JP(link=2, offset=(0.5, 0, 0))], iterations=16,
                        n_seeds=4).solve(jnp.zeros(3), [jnp.asarray(tg)]))
    noise = 0.3 * jax.random.normal(jax.random.PRNGKey(0), (3, 3),
                                    dtype=jnp.float32)
    seeds = torch.as_tensor(np.concatenate([np.zeros((1, 3)),
                                            np.asarray(noise)]),
                            dtype=torch.float32)
    pik = IKSolver(pm, [IKObjectivePosition(link=2, offset=(0.5, 0, 0))],
                   iterations=16, n_seeds=4)
    pik.seeds = lambda q0: seeds
    pq = pik.solve(torch.zeros(3), [torch.as_tensor(tg)])
    for q in (torch.as_tensor(jq), pq):
        err = cs.ik_tip_error(pm, q, torch.as_tensor(tg))
        assert float(err.max()) < 0.02


def test_roberts_seeds_match_jax_bit_for_bit():
    import jax.numpy as jnp
    from newton_tpu_torch.ik.ik_solver import roberts_noise
    g = 1.6180339887498949
    for S, Q in ((4, 3), (8, 7), (16, 30)):
        alphas = (1.0 / g) ** jnp.arange(1, Q + 1, dtype=jnp.float32)
        idx = jnp.arange(1, S, dtype=jnp.float32)[:, None]
        ref = np.asarray(0.3 * (jnp.mod(idx * alphas, 1.0) - 0.5) * 2)
        got = roberts_noise(S, Q, 0.3, torch.float32, "cpu").numpy()
        assert got.dtype == ref.dtype and np.array_equal(got, ref)
    pm = cs.ik_chain_scene(nt).finalize("cpu")
    ik = IKSolver(pm, [IKObjectivePosition(link=2)], n_seeds=4,
                  sampling=IKSampling.ROBERTS)
    s = ik.seeds(torch.zeros(3))
    assert s.shape == (4, 3) and torch.equal(s[0], torch.zeros(3))


def test_gauss_and_uniform_seeds_follow_the_generator():
    pm = cs.ik_chain_scene(nt).finalize("cpu")
    for sampling in (IKSampling.GAUSS, IKSampling.UNIFORM):
        a = IKSolver(pm, [IKObjectivePosition(link=2)], n_seeds=5,
                     sampling=sampling,
                     generator=torch.Generator().manual_seed(3))
        b = IKSolver(pm, [IKObjectivePosition(link=2)], n_seeds=5,
                     sampling=sampling,
                     generator=torch.Generator().manual_seed(3))
        sa, sb = a.seeds(torch.zeros(3)), b.seeds(torch.zeros(3))
        assert torch.equal(sa, sb) and sa.shape == (5, 3)
        if sampling == IKSampling.UNIFORM:
            assert float(sa.abs().max()) <= 0.3


def test_bfgs_matches_jax():
    """method="bfgs" on a 2-link arm about Z, 16 reachable targets, 20
    iterations from a bent start, against
    jax.scipy.optimize.minimize(method="BFGS") through the JAX package's
    solver: q within 1e-4."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.ik import IKObjectivePosition as JP, IKSolver as JIK
    jm, pm = _arm(jt, 2).finalize(), _arm(nt, 2).finalize("cpu")
    tg = (cs.ik_targets(16, 3) * (1.8 / 2.4)).astype(np.float32)
    q0 = np.array([0.2, 0.8], np.float32)
    jq = np.asarray(JIK(jm, [JP(link=1, offset=(0.5, 0, 0))], iterations=20,
                        method="bfgs").solve(jnp.asarray(q0),
                                             [jnp.asarray(tg)]))
    pq = IKSolver(pm, [IKObjectivePosition(link=1, offset=(0.5, 0, 0))],
                  iterations=20, method="bfgs").solve(
        torch.as_tensor(q0), [torch.as_tensor(tg)]).numpy()
    np.testing.assert_allclose(pq, jq, atol=1e-4)


def test_ik_reaches_target():
    """tests/test_utils.py:87 on the port."""
    m = _arm(nt, 2).finalize("cpu")
    ik = IKSolver(m, [IKObjectivePosition(link=1, offset=(0.5, 0, 0))],
                  iterations=24, n_seeds=4)
    target = torch.tensor([1.2, 0.8, 0.0])
    q = ik.solve(torch.zeros(2), [target])
    s = nt.eval_fk(m, q, torch.zeros(2), m.state())
    from newton_tpu_torch.math import transform_point
    tip = transform_point(s.body_q[1], torch.tensor([0.5, 0.0, 0.0]))
    assert float((tip - target).norm()) < 0.02


def test_ik_bfgs_method():
    """tests/test_utils.py:123 on the port."""
    m = _arm(nt, 1).finalize("cpu")
    ik = IKSolver(m, [IKObjectivePosition(link=0, offset=(0.5, 0, 0))],
                  iterations=40, method="bfgs")
    q = ik.solve(torch.zeros(1), [torch.tensor([0.0, 1.0, 0.0])])
    np.testing.assert_allclose(float(q[0]) % (2 * np.pi), np.pi / 2,
                               atol=0.05)


def test_ik_rotation_objective():
    """tests/test_utils.py:224 on the port."""
    from newton_tpu_torch.math import quat_from_axis_angle
    b = nt.ModelBuilder(gravity=0.0)
    parent = -1
    for i in range(2):
        link = b.add_body(xform=[0.5 + i, 0, 1, 0, 0, 0, 1])
        b.add_shape_capsule(link, radius=0.04, half_height=0.45)
        b.add_joint_revolute(parent, link, axis="Y",
                             xform_p=([0, 0, 1, 0, 0, 0, 1] if i == 0
                                      else [0.5, 0, 0, 0, 0, 0, 1]),
                             xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
        parent = link
    m = b.finalize("cpu")
    ik = IKSolver(m, [IKObjectiveRotation(link=1)], iterations=24,
                  n_seeds=4)
    qt = quat_from_axis_angle(torch.tensor([0.0, 1.0, 0.0]),
                              torch.tensor(0.7))
    q = ik.solve(m.joint_q0, [qt[None]])
    s = nt.eval_fk(m, q[0], m.joint_qd0, m.state())
    dot = abs(float((s.body_q[1, 3:7] * qt).sum()))
    assert dot > 0.999


def test_custom_objective_example_on_the_port():
    """example_ik_custom.py on the port: a 3-link arm about Y follows a
    moving target for 4 frames while the custom objective holds the
    elbow above the table; the example's test_final (tip error < 0.08,
    elbow z > TABLE_Z - 0.05)."""
    from newton_tpu_torch.math import transform_point
    m = _arm(nt, 3, "Y", 1.0, gravity=0.0).finalize("cpu")
    # the example's joints have no limits
    m.joint_limit_lower[:] = -1e6
    m.joint_limit_upper[:] = 1e6
    ik = IKSolver(m, [IKObjectivePosition(link=2, offset=(0.5, 0, 0)),
                      ElbowAbovePlane(link=1)], iterations=24, n_seeds=4)
    q = m.joint_q0.clone()
    for frame in range(4):
        ang = 2.0 * np.pi * 0.15 * frame / 30.0
        target = torch.tensor([[1.5 + 0.5 * np.cos(ang), 0.0,
                                1.2 + 0.3 * np.sin(ang)]],
                              dtype=torch.float32)
        q = ik.solve(q, [target, torch.zeros((1, 1))])[0]
    s = nt.eval_fk(m, q, torch.zeros(3), m.state())
    tip = transform_point(s.body_q[2], torch.tensor([0.5, 0.0, 0.0]))
    assert float((tip - target[0]).norm()) < 0.08
    assert float(s.body_q[1, 2]) > TABLE_Z - 0.05
