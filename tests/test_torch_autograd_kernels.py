"""Gradients through the two kernel modules on the CPU: the VJPs of the
plain versions (what the card's backward kernels K3 and K4 compute) against
``jax.vjp`` of the JAX package's XLA branch at the kernels' call sites.

B1: ``batched._chol_t`` + ``_cho_solve_t`` (the factor, x = Mi^-1 rhs and
Minv), with cotangents on both outputs; ``chol_solve`` against the same
for x alone. B2: the XLA assembly of ``batched.py`` (MJ = J Minv, diag,
v_free, the limit columns) followed by ``pgs_pallas.pgs_core``; a
non-symmetric Minv takes MJ = J Minv^T there as the port's
``symmetric=False`` does, and ``w_other`` enters the JAX side as 3c extra
columns diag(sqrt(w)) of J and MJ (which add w to the Delassus diagonal and
w x to every matvec, the port's operator).

Tolerances, float32 on both sides: B1 normwise 2e-5 per input (the
plain factor's backward and JAX's run the same unrolled steps in another
association); B2 normwise 2e-4 per input (eight Jacobi sweeps and the
power iterations compound the reassociation). float64 gradchecks at the
default tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newton_tpu.solvers.generalized import batched as jbatched
from newton_tpu.solvers.generalized.pgs_pallas import pgs_core as j_pgs_core

from newton_tpu_torch.solvers.generalized import linalg, pgs

torch.set_num_threads(1)


def _spd(rng, W, d):
    A = rng.randn(W, d, d)
    return (A @ np.transpose(A, (0, 2, 1)) + 2.0 * np.eye(d)).astype(
        np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _torch_vjp(fn, ins, diff, cots, **kw):
    ts = [torch.tensor(np.asarray(a), requires_grad=i in diff)
          for i, a in enumerate(ins)]
    outs = fn(*ts, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    gs = torch.autograd.grad(outs[:len(cots)], [ts[i] for i in diff],
                             [torch.as_tensor(c) for c in cots])
    return [g.numpy() for g in gs], outs


@pytest.mark.parametrize("d", [6, 14, 23])
def test_chol_inv_solve_vjp_matches_jax(d):
    W = 4
    rng = np.random.RandomState(d)
    A = _spd(rng, W, d)
    rhs = rng.randn(W, d).astype(np.float32)
    gM = rng.randn(W, d, d).astype(np.float32)
    gx = rng.randn(W, d).astype(np.float32)
    eye = jnp.eye(d, dtype=jnp.float32)[:, :, None]

    def jf(At, bt):
        L = jbatched._chol_t(At)
        x = jbatched._cho_solve_t(L, bt)
        Minv = jbatched._cho_solve_t(L, jnp.broadcast_to(eye, (d, d, W)))
        return Minv, x
    gA_j, gb_j = jax.jit(lambda A, b, gM, gx: jax.vjp(jf, A, b)[1](
        (gM, gx)))(jnp.asarray(A.transpose(1, 2, 0)), jnp.asarray(rhs.T),
                   jnp.asarray(gM.transpose(1, 2, 0)), jnp.asarray(gx.T))
    (gA, gb), outs = _torch_vjp(linalg.chol_inv_solve, (A, rhs), (0, 1),
                                (gM, gx))
    assert all(o.grad_fn is not None for o in outs)
    assert _rel(gA, np.asarray(gA_j).transpose(2, 0, 1)) < 2e-5
    assert _rel(gb, np.asarray(gb_j).T) < 2e-5
    # the factor reads the lower triangle only: no gradient above it, and
    # the kernel's folded form equals autograd of the plain version
    assert np.all(np.triu(gA, 1) == 0)
    At = torch.as_tensor(A).double()
    Minv = torch.linalg.inv(At)
    x = Minv @ torch.as_tensor(rhs).double()[:, :, None]
    G = -(Minv @ torch.as_tensor(gx).double()[:, :, None] @ x.transpose(1, 2)
          + Minv @ torch.as_tensor(gM).double() @ Minv)
    assert _rel(gA, linalg.fold_lower(G).numpy()) < 2e-5


@pytest.mark.parametrize("d", [6, 14, 23])
def test_chol_solve_vjp_matches_jax(d):
    W = 4
    rng = np.random.RandomState(100 + d)
    A = _spd(rng, W, d)
    rhs = rng.randn(W, d).astype(np.float32)
    gx = rng.randn(W, d).astype(np.float32)
    _, vjp = jax.vjp(lambda At, bt: jbatched._cho_solve_t(
        jbatched._chol_t(At), bt), jnp.asarray(A.transpose(1, 2, 0)),
        jnp.asarray(rhs.T))
    gA_j, gb_j = vjp(jnp.asarray(gx.T))
    (gA, gb), outs = _torch_vjp(linalg.chol_solve, (A, rhs), (0, 1), (gx,))
    assert outs[0].grad_fn is not None
    assert _rel(gA, np.asarray(gA_j).transpose(2, 0, 1)) < 2e-5
    assert _rel(gb, np.asarray(gb_j).T) < 2e-5


def test_chol_gradcheck_float64():
    rng = np.random.RandomState(7)
    A = torch.as_tensor(_spd(rng, 2, 5)).double().requires_grad_(True)
    b = torch.as_tensor(rng.randn(2, 5)).double().requires_grad_(True)
    assert torch.autograd.gradcheck(linalg.chol_inv_solve_plain, (A, b))
    assert torch.autograd.gradcheck(linalg.chol_solve_plain, (A, b))


# --- B2 -----------------------------------------------------------------

def _pgs_case(seed, c, nl, d, W, *, cone=False, two=False, sym=True,
              tie=False):
    rng = np.random.RandomState(seed)
    r = 3 * c + 2 * nl
    J = rng.randn(W, 3 * c, d).astype(np.float32)
    M = rng.randn(W, d, d)
    Minv = M @ np.transpose(M, (0, 2, 1)) / d + np.eye(d)
    if not sym:
        Minv = Minv + 0.1 * rng.randn(W, d, d)
    Minv = Minv.astype(np.float32)
    qd = rng.randn(W, d).astype(np.float32)
    b = np.abs(rng.randn(W, r)).astype(np.float32)
    if tie:
        b[:, :c] = -5.0          # normals pulled apart: ln = 0, cap = 0
    act = (rng.rand(W, r) > 0.3).astype(np.float32)
    mu = rng.rand(W, c).astype(np.float32)
    lam0 = (0.1 * np.abs(rng.randn(W, r))).astype(np.float32)
    w = (0.5 * rng.rand(W, 3 * c) + 0.1).astype(np.float32) if two \
        else None
    ld = np.sort(rng.choice(d, nl, replace=False)).astype(np.int32)
    cots = (rng.randn(W, r).astype(np.float32),
            rng.randn(W, d).astype(np.float32))
    return (J, Minv, qd, b, act, mu, lam0, w), ld, cots


def _jax_pgs_vjp(ops, ld, cots, *, c, iters, omega, cone, ds, reg, sym,
                 jit=False):
    """jax.vjp of the XLA assembly + pgs_core, env-last inside (eagerly,
    whose per-shape operation caches the ant-shaped cases share, or under
    jit for a shape of its own)."""
    J, Minv, qd, b, act, mu, lam0, w = ops
    W, _, d = J.shape
    nl = len(ld)
    act_t = jnp.asarray(act.T)

    def f(J, Minv, qd, b, mu, lam0, *wv):
        Jt = jnp.transpose(J, (1, 2, 0))
        Mt = jnp.transpose(Minv, (1, 2, 0))
        Mm = Mt if sym else jnp.transpose(Mt, (1, 0, 2))
        MJ = sum(Jt[:, e, None, :] * Mm[e][None, :, :] for e in range(d))
        if wv:
            # w as 3c extra columns diag(sqrt(w)) of J and of MJ
            sw = jnp.sqrt(wv[0].T)                          # (3c, W)
            ext = jnp.eye(3 * c, dtype=J.dtype)[:, :, None] * sw[:, None]
            Jt = jnp.concatenate([Jt, ext], axis=1)
            MJ = jnp.concatenate([MJ, ext], axis=1)
        diag = (Jt * MJ).sum(axis=1) * ds + reg
        qdt = qd.T
        if wv:
            qdt = jnp.concatenate([qdt, jnp.zeros((3 * c, W), qd.dtype)])
        v_free = (Jt * qdt[None]).sum(axis=1)
        cols = None
        if nl:
            cols = Mt[:, ld]
            if wv:
                cols = jnp.concatenate(
                    [cols, jnp.zeros((3 * c, nl, W), J.dtype)])
            dlim = Mt[ld, ld] * ds + reg
            diag = jnp.concatenate([diag, dlim, dlim])
            vlim = qd.T[ld]
            v_free = jnp.concatenate([v_free, vlim, -vlim])
        lam, dqd = j_pgs_core(Jt, MJ, cols, diag, v_free, b.T, act_t, mu.T,
                              lam0.T, c=c, nl=nl, ld=tuple(int(i) for i in ld),
                              iters=iters, omega=omega, use_cone=cone)
        return lam.T, dqd[:d].T
    ins = [J, Minv, qd, b, mu, lam0] + ([w] if w is not None else [])
    run = lambda cots, *ins: jax.vjp(f, *ins)[1](cots)      # noqa: E731
    gs = (jax.jit(run) if jit else run)(
        tuple(jnp.asarray(x) for x in cots), *[jnp.asarray(a) for a in ins])
    return [np.asarray(g) for g in gs]


_PGS_CASES = {
    "box": dict(c=25, nl=8, d=14),
    "cone": dict(c=25, nl=8, d=14, cone=True),
    "nl0": dict(c=25, nl=0, d=14),
    "w_other": dict(c=25, nl=8, d=14, two=True),
    "nonsymmetric": dict(c=25, nl=8, d=14, sym=False),
    "cap0_ties": dict(c=25, nl=8, d=14, tie=True),
    "halvings": dict(c=6, nl=2, d=5, seed=0),
}


@pytest.mark.parametrize("case", list(_PGS_CASES))
def test_pgs_vjp_matches_jax(case):
    """The ant's shape (25, 8, 14) at W = 4 with contacts active, the box
    and the cone, nl = 0, w_other, symmetric=False, a case whose divergence
    guard halves the step, and one whose normals all separate (cap = 0,
    so the box's clips tie)."""
    spec = dict(_PGS_CASES[case])
    seed = spec.pop("seed", 3)
    c, nl, d = spec.pop("c"), spec.pop("nl"), spec.pop("d")
    ops, ld, cots = _pgs_case(seed, c, nl, d, 4, **spec)
    cone, sym = spec.get("cone", False), spec.get("sym", True)
    kw = dict(c=c, ld=torch.as_tensor(ld), iters=8, omega=0.8,
              use_cone=cone, diag_scale=1.0, reg=1e-3, symmetric=sym)
    diff = (0, 1, 2, 3, 5, 6) + ((7,) if ops[7] is not None else ())

    def fn(J, Minv, qd, b, act, mu, lam0, w=None, **k):
        return pgs.pgs_solve_fused(J, Minv, qd, b, act, mu, lam0,
                                   w_other=w, return_halvings=True, **k)
    ins = ops if ops[7] is not None else ops[:7]
    got, outs = _torch_vjp(fn, ins, diff, cots, **kw)
    assert outs[0].grad_fn is not None and outs[1].grad_fn is not None
    if case == "halvings":
        assert int(outs[2].sum()) > 0
    ref = _jax_pgs_vjp(ops, ld, cots, c=c, iters=8, omega=0.8, cone=cone,
                       ds=1.0, reg=1e-3, sym=sym, jit=c != 25)
    for name, g, r in zip(("J", "Minv", "qd", "b", "mu", "lam0", "w"),
                          got, ref):
        assert np.isfinite(g).all() and np.isfinite(r).all(), name
        assert _rel(g, r) < 2e-4, (name, _rel(g, r))


def test_pgs_ties_split_like_jax():
    """At a tie, torch.maximum/minimum give each side half the gradient as
    jnp.maximum and jnp.clip do (torch.clamp would give one side all of
    it): the normal clamp at ln = 0 and the box at cap = 0."""
    x = torch.zeros(3, requires_grad=True)
    cap = torch.zeros(3, requires_grad=True)
    zero = torch.zeros(())
    y = torch.maximum(x, zero).sum() + torch.minimum(
        torch.maximum(x, -cap), cap).sum()
    y.backward()
    gx_j, gc_j = jax.grad(
        lambda x, c: jnp.maximum(x, 0.0).sum() + jnp.clip(x, -c, c).sum(),
        argnums=(0, 1))(jnp.zeros(3), jnp.zeros(3))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx_j))
    np.testing.assert_allclose(cap.grad.numpy(), np.asarray(gc_j))


def test_inactive_env_gradient_is_finite():
    """An env with no active row: the port's step bound takes a zero norm's
    gradient as 0 (torch.linalg.vector_norm), so its gradient is finite
    (the JAX package's sqrt of a zero sum gives NaN there: ROADMAP C)."""
    ops, ld, cots = _pgs_case(5, 25, 8, 14, 4)
    ops = list(ops)
    ops[4] = ops[4].copy()
    ops[4][1] = 0.0
    kw = dict(c=25, ld=torch.as_tensor(ld), iters=8, omega=0.8,
              use_cone=False, diag_scale=1.0, reg=1e-3)
    got, _ = _torch_vjp(lambda *a, **k: pgs.pgs_solve_fused(*a, **k),
                        ops[:7], (0, 1, 2, 3, 5, 6), cots, **kw)
    assert all(np.isfinite(g).all() for g in got)
    ref = _jax_pgs_vjp(ops, ld, cots, c=25, iters=8, omega=0.8, cone=False,
                       ds=1.0, reg=1e-3, sym=True)
    assert np.isnan(ref[0][1]).any() and np.isfinite(ref[0][0]).all()
    for w in (0, 2, 3):
        assert _rel(got[0][w], ref[0][w]) < 2e-4


def test_pgs_gradcheck_float64():
    ops, ld, _ = _pgs_case(9, 3, 1, 4, 2)
    ts = [torch.as_tensor(a).double() for a in ops[:7]]
    kw = dict(c=3, ld=torch.as_tensor(ld), iters=4, omega=0.8,
              use_cone=False, diag_scale=1.0, reg=1e-3)

    def f(J, Minv, qd, b, mu, lam0):
        return pgs.pgs_solve_fused_plain(J, Minv, qd, b, ts[4], mu, lam0,
                                         **kw)
    ins = [t.requires_grad_(True) for i, t in enumerate(ts) if i != 4]
    assert torch.autograd.gradcheck(f, ins)
