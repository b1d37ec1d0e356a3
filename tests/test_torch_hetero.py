"""Heterogeneous worlds in the port against the JAX package on the CPU:
several articulation groups per world (the joint showcase; an ant with a
free ball), per-world constants (randomized masses, inertias and
friction), ragged contact plans (a pedestal in every other world),
two-sided contacts between articulations, ``notify_model_changed``, and
``finalize``'s default device. On a CUDA card: B2 with its ``w_other``
operand against its plain version in every instance.

Tolerances: ``step`` joint_q/body_q atol = rtol = 2e-4 and joint_qd 5e-3
(tests/test_batched_step.py:69-75) per substep; a world against a
one-world model with its constants, and a rebuilt solver against a fresh
one, 1e-6 (the same operations); the examples' z gates +-0.05. On the
card: B2 lam 1e-4, dqd 1e-3 (tests/test_torch_kernels.py), and bit for
bit where ``w_other`` is zero.

JAX is imported inside the fixtures and tests, so the GPU cases collect
where JAX is absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_hetero.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.solvers.generalized import pgs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 18-20)

torch.set_num_threads(1)

DT = 1.0 / 240.0
ANT = os.path.join(nt.ASSET_DIR, "ant.xml")

gpu = pytest.mark.gpu
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


def _assert_states(got, ref, q_atol=2e-4, qd_atol=5e-3):
    for name, atol in (("joint_q", q_atol), ("joint_qd", qd_atol),
                       ("body_q", q_atol)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=atol, err_msg=name)


def _jax_states(jm, tm, q, qd):
    import jax.numpy as jnp
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    return (j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state()),
            nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd),
                       tm.state()))


def _tiled_actuation(robot, n):
    from test_torch_worlds import _tiled_actuation as tiled
    return tiled(robot, n)


# ----------------------------------------------------------------------
# several articulation groups: the joint showcase
# ----------------------------------------------------------------------
def test_showcase_matches_jax():
    """example_basic_joints.py's world (revolute, prismatic, ball, fixed,
    free and D6 articulations) x 4 with the example's kicks: six groups,
    8 substeps against the JAX package's ``step``, then 0.5 s of both
    with the example's gates on the port (the revolute link stays in its
    plane and moves, the prismatic one keeps y and z, the fixed one does
    not move, the free one falls, the ball joint keeps its pivot)."""
    import jax
    import newton_tpu as jt
    from newton_tpu.solvers.generalized.solver import \
        SolverFeatherstone as JS
    n = 4
    jm = cs.showcase_scene(jt, n).finalize()
    tm = cs.showcase_scene(nt, n).finalize("cpu")
    ts_ = nt.SolverFeatherstone(tm)
    assert sorted(g.g.d for g in ts_.groups) == [0, 1, 1, 1, 3, 6]
    assert all(g.g.n == n for g in ts_.groups)
    idx, val = cs.showcase_kicks(tm.structure)
    qd = tm.joint_qd0.numpy().copy()
    qd[idx] = val
    js, ts = _jax_states(jm, tm, tm.joint_q0.numpy(), qd)
    p0 = ts.body_q[:, :3].clone()
    js_ = JS(jm)
    jc, tc = jm.control(), tm.control()
    jstep = jax.jit(lambda s: js_.step(s, None, jc, None, DT))
    for k in range(120):
        ts = ts_.step(ts, None, tc, None, DT)
        js = jstep(js)
        if k < 8 or k == 119:
            _assert_states(ts, js)
    p = ts.body_q[:, :3].reshape(n, 6, 3)
    p0 = p0.reshape(n, 6, 3)
    rev, pris, ball, fix, free, _ = range(6)
    assert (p[:, rev, 1] - p0[:, rev, 1]).abs().max() < 1e-3
    assert ((p[:, rev, 2] - p0[:, rev, 2]).abs() > 1e-3).all()
    assert (p[:, pris, 1:] - p0[:, pris, 1:]).abs().max() < 1e-3
    assert (p[:, fix] - p0[:, fix]).norm(dim=-1).max() < 1e-4
    assert (p[:, free, 2] < p0[:, free, 2] - 0.05).all()
    bq = ts.body_q.reshape(n, 6, 7)[:, ball]
    from newton_tpu_torch.math import quat_rotate
    tip = bq[:, :3] + quat_rotate(bq[:, 3:], torch.tensor([0.0, 0.0, 0.3]))
    anchor = torch.tensor([2.0, 0.0, 1.3])
    assert ((tip - anchor).norm(dim=-1) < 2e-3).all()


# ----------------------------------------------------------------------
# ragged contact plans: the sphere pedestal in every other world
# ----------------------------------------------------------------------
def test_ragged_pedestal_matches_jax():
    """example_hetero_worlds.py with a static sphere pedestal (radius 0.2
    at z = 0.2) in the odd worlds x 4: the plan is ragged (one slot more
    in the odd rows, pad entries masked), 8 substeps against the JAX
    package's ``step``, then 1.25 s of both: a sphere rests at z = 0.3 on
    the ground and at z = 0.7 on the pedestal (+-0.05), and meets only its
    own world's pedestal."""
    import jax
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers.generalized.solver import \
        SolverFeatherstone as JS
    n = 4
    jm = cs.ragged_scene(jt, n).finalize()
    tm = cs.ragged_scene(nt, n).finalize("cpu")
    ts_ = nt.SolverFeatherstone(tm, contact_iterations=8)
    plan = ts_.contact_plans[0]
    assert not plan.uniform and plan.valid.sum(1).tolist() == [1, 2, 1, 2]
    js_ = JS(jm, contact_iterations=8)
    jp, tp = JPipe(jm), nt.CollisionPipeline(tm)
    js, ts = _jax_states(jm, tm, tm.joint_q0.numpy(), tm.joint_qd0.numpy())
    jc, tc = jm.control(), tm.control()
    jstep = jax.jit(lambda s: js_.step(s, None, jc, jp.collide(s), DT))
    for k in range(300):
        ts = ts_.step(ts, None, tc, tp.collide(ts), DT)
        js = jstep(js)
        if k < 8:
            _assert_states(ts, js)
    z = ts.body_q[:, 2]
    np.testing.assert_allclose(z.numpy(), [0.3, 0.7, 0.3, 0.7], atol=0.05)
    np.testing.assert_allclose(z.numpy(), np.asarray(js.body_q)[:, 2],
                               atol=2e-3)


# ----------------------------------------------------------------------
# two-sided contacts: the ant and its ball
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ant_ball():
    """ant with a ball x 4 on both sides (the JAX builder given its worlds'
    actuator tables), uncompacted so that each contact entry's impulse is
    comparable, from joint_q0 (the front-left foot touches the ball)."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    n = 4
    jb, jr = cs.ant_ball_scene(jt, n, ANT)
    jb.mjc_actuation = _tiled_actuation(jr, n)
    jm = jb.finalize()
    tm = cs.ant_ball_scene(nt, n, ANT)[0].finalize("cpu")
    kw = dict(iterations=8, integrator="euler", contact_cap=0)
    js_ = JSolver(jm, **kw)
    return dict(n=n, jm=jm, tm=tm, js_=js_, ts_=nt.SolverMuJoCo(tm, **kw),
                jp=JPipe(jm), tp=nt.CollisionPipeline(tm))


def test_ant_ball_matches_jax(ant_ball):
    """4 substeps of the ant with a ball x 4 (two groups: the ant, d = 14,
    and the ball, d = 6) under uniform ctrl against the JAX package's
    ``step``; every ant-ball contact is an entry of both groups' plans
    (two-sided, weight 0.5 each). Each half's normal impulse equals the
    JAX package's, both halves push the two bodies apart (the same
    contact normal, opposite Jacobian signs), and every substep's B2 call
    of both groups carries the other body's point inverse mass."""
    import jax
    import jax.numpy as jnp
    a = ant_ball
    n, tm, jm, ts_, js_ = a["n"], a["tm"], a["jm"], a["ts_"], a["js_"]
    ga, gb = ts_.groups
    assert (ga.g.d, gb.g.d) == (14, 6)
    ob_a, ob_b = ga.plan.ob, gb.plan.ob
    assert (ob_a >= 0).sum() == (ob_b >= 0).sum() == 13 * n
    assert set(ga.plan.w.tolist()) == set(gb.plan.w.tolist()) == {0.5, 1.0}
    js, ts = _jax_states(jm, tm, tm.joint_q0.numpy(), tm.joint_qd0.numpy())

    def step_lam(s, c):
        out = js_.step(s, None, c, a["jp"].collide(s), DT)
        return out, [lam for _, lam, _ in js_._last_contact_impulses]
    jstep = jax.jit(step_lam)
    rng = np.random.RandomState(2)
    touched = 0
    for _ in range(4):
        ctrl = rng.uniform(-1, 1, n * 8).astype(np.float32)
        jc = jm.control()
        jc = jc.replace(custom={**jc.custom, "mjc:ctrl": jnp.asarray(ctrl)})
        tc = tm.control()
        tc.custom["mjc:ctrl"] = torch.as_tensor(ctrl)
        contacts = a["tp"].collide(ts)
        rec = {}
        ts = ts_.step(ts, None, tc, contacts, DT, record=rec)
        js, (lam_ja, lam_jb) = jstep(js, jc)
        _assert_states(ts, js)
        halves = []
        for grp, lam_j in ((ga, lam_ja), (gb, lam_jb)):
            r = rec["groups"][grp.index]
            assert "w_other" in r["pgs"][1]
            c = grp.plan.c
            lam_n = r["lam"][:, :c].numpy()
            np.testing.assert_allclose(
                lam_n, np.asarray(lam_j).reshape(n, c, 3)[..., 0],
                atol=1e-5, rtol=1e-3)
            halves.append(lam_n)
        # the ant-ball slots: the ball group's two-sided entries, found in
        # the ant group's plan; body0 (the foot) is in the ant's cell
        for e in range(n):
            for j_b in np.nonzero(ob_b[e] >= 0)[0]:
                slot = gb.plan.slots[e, j_b]
                j_a = int(np.nonzero(ga.plan.slots[e] == slot)[0][0])
                assert ga.plan.lb1[j_a] < 0 <= ga.plan.lb0[j_a]
                assert gb.plan.lb1[j_b] >= 0 > gb.plan.lb0[j_b]
                ha, hb = halves[0][e, j_a], halves[1][e, j_b]
                assert ha >= 0 and hb >= 0
                touched += bool(contacts.rigid_contact_mask[slot]) and \
                    (ha > 0 or hb > 0)
    assert touched > 0


# ----------------------------------------------------------------------
# per-world constants
# ----------------------------------------------------------------------
def _ant8(lib):
    r = lib.ModelBuilder()
    r.add_mjcf(ANT)
    b = lib.ModelBuilder()
    b.replicate(r, 8)
    return b, r


def _randomize(tm, seed):
    """Per-world masses and inertias (x U(0.8, 1.2)) and per-shape mu
    (U(0.5, 1.25)), inverse mass and inertia kept consistent: the port's
    model edited in place; returns the new leaves for the JAX model."""
    cs.randomize_ant_ball(tm, seed)
    return {k: np.asarray(getattr(tm, k).numpy()) for k in (
        "body_mass", "body_inertia", "body_inv_mass", "body_inv_inertia",
        "shape_material_mu")}


@pytest.fixture(scope="module")
def ant8():
    import jax.numpy as jnp
    import newton_tpu as jt
    jb, jr = _ant8(jt)
    jb.mjc_actuation = _tiled_actuation(jr, 8)
    jm = jb.finalize()
    tm = _ant8(nt)[0].finalize("cpu")
    leaves = _randomize(tm, seed=4)
    jm = jm.replace(**{k: jnp.asarray(v) for k, v in leaves.items()})
    return jm, tm


def test_ant_per_world_constants_match_jax(ant8):
    """ant x 8 whose worlds differ in every body's mass and inertia and
    every shape's friction: the solver's tables carry a row axis for
    them (and stay one row for what the worlds share); 4 substeps against
    the JAX package's ``step`` on the same model."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    jm, tm = ant8
    ts_ = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    t = ts_.tables
    assert ts_.row_model.body_mass.shape == (8, 13)
    assert t.mu.shape == (8, 25) and t.dof_X_p.dim() == 2
    js_ = JSolver(jm, iterations=8, integrator="euler")
    jp, tp = JPipe(jm), nt.CollisionPipeline(tm)
    js, ts = _jax_states(jm, tm, tm.joint_q0.numpy(), tm.joint_qd0.numpy())
    rng = np.random.RandomState(8)
    jstep = jax.jit(lambda s, c: js_.step(s, None, c, jp.collide(s), DT))
    for _ in range(4):
        ctrl = rng.uniform(-1, 1, 8 * 8).astype(np.float32)
        jc = jm.control()
        jc = jc.replace(custom={**jc.custom, "mjc:ctrl": jnp.asarray(ctrl)})
        tc = tm.control()
        tc.custom["mjc:ctrl"] = torch.as_tensor(ctrl)
        ts = ts_.step(ts, None, tc, tp.collide(ts), DT)
        js = jstep(js, jc)
        _assert_states(ts, js)


def test_world_equals_one_world_model(ant8):
    """World k of the randomized ant x 8, stepped among the others, equals
    a one-world ant model given world k's constants, stepped alone (1e-6
    over 4 substeps)."""
    _, tm = ant8
    ts_ = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    tp = nt.CollisionPipeline(tm)
    k = 5
    one = nt.ModelBuilder()
    one.add_mjcf(ANT)
    om = one.finalize("cpu")
    nb, ns = om.structure.body_count, om.structure.shape_count
    for name, n_ent in (("body_mass", nb), ("body_inertia", nb),
                        ("body_inv_mass", nb), ("body_inv_inertia", nb),
                        ("shape_material_mu", ns)):
        getattr(om, name).copy_(getattr(tm, name)[k * n_ent:(k + 1) * n_ent])
    os_ = nt.SolverMuJoCo(om, iterations=8, integrator="euler")
    op = nt.CollisionPipeline(om)
    ts = nt.eval_fk(tm, tm.joint_q0, tm.joint_qd0, tm.state())
    so = nt.eval_fk(om, om.joint_q0, om.joint_qd0, om.state())
    rng = np.random.RandomState(9)
    for _ in range(4):
        ctrl = torch.as_tensor(rng.uniform(-1, 1, 64).astype(np.float32))
        tc, oc = tm.control(), om.control()
        tc.custom["mjc:ctrl"] = ctrl
        oc.custom["mjc:ctrl"] = ctrl[8 * k:8 * (k + 1)]
        ts = ts_.step(ts, None, tc, tp.collide(ts), DT)
        so = os_.step(so, None, oc, op.collide(so), DT)
        for name, width in (("joint_q", 15), ("joint_qd", 14),
                            ("body_q", 13)):
            got = getattr(ts, name).reshape(8, width, -1)[k]
            torch.testing.assert_close(got, getattr(so, name).reshape(
                width, -1), atol=1e-6, rtol=0)


def test_notify_model_changed_equals_fresh_solver():
    """A solver built before the randomization, then told with
    ``notify_model_changed``, steps exactly as a solver built after it;
    without the call it keeps the old constants."""
    tm = cs.ant_ball_scene(nt, 3, ANT)[0].finalize("cpu")
    old = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    stale = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    s0 = nt.eval_fk(tm, tm.joint_q0, tm.joint_qd0, tm.state())
    tp = nt.CollisionPipeline(tm)
    cs.randomize_ant_ball(tm, 6)
    old.notify_model_changed()
    fresh = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    tc = tm.control()
    tc.custom["mjc:ctrl"] = torch.linspace(-1, 1, 24)
    outs = []
    for solver in (old, fresh, stale):
        s = s0
        for _ in range(3):
            s = solver.step(s, None, tc, tp.collide(s), DT)
        outs.append(s)
    for name in ("joint_q", "joint_qd", "body_q", "body_qd"):
        assert torch.equal(getattr(outs[0], name), getattr(outs[1], name))
    assert not torch.equal(outs[2].joint_qd, outs[1].joint_qd)


def test_finalize_defaults_to_the_card():
    """``finalize()`` builds on the card by default; without CUDA it
    raises instead of falling back to the CPU, and ``"cpu"`` builds."""
    b = nt.ModelBuilder()
    body = b.add_body()
    b.add_shape_sphere(body, radius=0.1)
    b.add_joint_free(body)
    if torch.cuda.is_available():
        assert b.finalize().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            b.finalize()
    assert b.finalize("cpu").device.type == "cpu"


# ----------------------------------------------------------------------
# B2's w_other operand
# ----------------------------------------------------------------------
def _pgs_inputs(seed, c, nl, d, W, dev):
    rng = np.random.RandomState(seed)
    r = 3 * c + 2 * nl
    Minv = rng.randn(d, d)
    Minv = (Minv @ Minv.T + np.eye(d)).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                               device=dev)
    w = np.abs(rng.randn(W, 3 * c)) * (rng.rand(W, 3 * c) > 0.4)
    return [t(rng.randn(W, 3 * c, d)), t(np.broadcast_to(Minv, (W, d, d))),
            t(rng.randn(W, d)), t(np.abs(rng.randn(W, r))),
            t(rng.rand(W, r) > 0.3), t(np.abs(rng.rand(W, c))),
            t(np.zeros((W, r)))], t(w)


def test_pgs_w_other_plain_is_the_diagonal_term():
    """The plain version with ``w_other`` equals ``pgs_core`` on a
    Delassus operator whose diagonal gains ``w_other`` explicitly (a dense
    A + diag(w) on the contact rows), and ``w_other = 0`` equals no
    operand."""
    args, w = _pgs_inputs(1, 5, 0, 6, 8, "cpu")
    kw = dict(c=5, ld=torch.zeros(0, dtype=torch.int32), iters=8, omega=0.8,
              use_cone=False, diag_scale=1.1, reg=1e-3)
    lam_w, dqd_w = pgs.pgs_solve_fused_plain(*args, w_other=w, **kw)
    lam_0, dqd_0 = pgs.pgs_solve_fused_plain(*args, w_other=w * 0, **kw)
    lam_n, dqd_n = pgs.pgs_solve_fused_plain(*args, **kw)
    assert torch.equal(lam_0, lam_n) and torch.equal(dqd_0, dqd_n)
    J, Minv, qd, b, act, mu, lam0 = args
    MJ = torch.bmm(J, Minv)
    A = torch.bmm(MJ, J.transpose(1, 2)) + torch.diag_embed(w)
    diag = torch.diagonal(A, dim1=1, dim2=2) * 1.1 + 1e-3
    v_free = (J * qd[:, None]).sum(-1)
    x = torch.randn(8, 15)
    avec = torch.bmm(A, x[..., None])[..., 0]
    lam_d, _, _ = pgs.pgs_core(J, MJ, None, diag, v_free, b, act, mu, lam0,
                               c=5, ld=kw["ld"], iters=8, omega=0.8,
                               use_cone=False, w_other=w)
    torch.testing.assert_close(lam_w, lam_d, atol=1e-6, rtol=1e-5)
    y = torch.bmm(J, torch.bmm(MJ.transpose(1, 2), x[..., None]))[..., 0]
    torch.testing.assert_close(y + w * x, avec, atol=1e-4, rtol=1e-4)
    assert not torch.allclose(lam_w, lam_n)


@gpu
@needs_cuda
@pytest.mark.parametrize("c, nl, d, W", [
    (32, 8, 14, 512), (32, 17, 23, 512), (14, 0, 6, 512), (16, 6, 9, 256),
    (192, 17, 23, 64), (192, 40, 48, 64)])
@pytest.mark.parametrize("use_cone", [False, True])
def test_pgs_w_other_kernel_matches_plain(c, nl, d, W, use_cone):
    """B2 with a nonzero ``w_other`` in every instance (reg16, reg24,
    smem128 at the ant's and ball's shapes, smem256, global256) against
    its plain version; envs whose guard halvings differ are counted and
    left out."""
    args, w = _pgs_inputs(c + nl + d, c, nl, d, W, "cuda")
    kw = dict(c=c, ld=torch.arange(d - nl, d, dtype=torch.int32,
                                   device="cuda"),
              iters=8, omega=0.8, use_cone=use_cone, diag_scale=1.1,
              reg=1e-3, w_other=w, return_halvings=True)
    before = pgs.pgs_solve_fused.launches
    lam_k, dqd_k, h_k = pgs.pgs_solve_fused(*args, **kw)
    torch.cuda.synchronize()
    assert pgs.pgs_solve_fused.launches == before + 1
    lam_p, dqd_p, h_p = pgs.pgs_solve_fused_plain(*args, **kw)
    same = h_k == h_p
    assert int((~same).sum()) <= max(W // 100, 1)
    torch.testing.assert_close(lam_k[same], lam_p[same], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(dqd_k[same], dqd_p[same], atol=1e-3,
                               rtol=1e-3)


@gpu
@needs_cuda
@pytest.mark.parametrize("c, nl, d", [(32, 8, 14), (32, 17, 23), (14, 0, 6),
                                      (192, 40, 48)])
def test_pgs_w_other_zero_is_bit_exact(c, nl, d):
    """A zero ``w_other`` gives B2's result without the operand bit for
    bit, in the register, shared-memory and global-scratch instances."""
    args, w = _pgs_inputs(7, c, nl, d, 256, "cuda")
    kw = dict(c=c, ld=torch.arange(d - nl, d, dtype=torch.int32,
                                   device="cuda"),
              iters=8, omega=0.8, use_cone=False, diag_scale=1.1, reg=1e-3,
              return_halvings=True)
    ref = pgs.pgs_solve_fused(*args, **kw)
    got = pgs.pgs_solve_fused(*args, w_other=torch.zeros_like(w), **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
