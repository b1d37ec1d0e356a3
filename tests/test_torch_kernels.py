"""The two kernel modules of the port: plain PyTorch versions against the
JAX package's Pallas kernels (run as the JAX tests run them on the CPU, in
interpret mode), and, on a CUDA card only, the hand-written kernels against
their plain versions.

Tolerances: Cholesky/solve/inverse atol = rtol = 1e-5 (float32, same
unrolled order); PGS lam 1e-5 and dqd 1e-4, as tests/test_batched_step.py
holds the Pallas kernel to its jnp core. On the card: the chip_smoke
tolerances (chol rtol 1e-4 atol 1e-5; PGS lam 1e-4, dqd 1e-3), looser
because the sums run in another order.

JAX and the kernel library are imported inside the tests, so this file
also collects where JAX is absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from newton_tpu_torch.solvers.generalized import linalg, pgs

torch.set_num_threads(1)


def _spd(rng, W, d):
    A = rng.randn(W, d, d).astype(np.float32)
    return (A @ np.transpose(A, (0, 2, 1))
            + 2.0 * np.eye(d, dtype=np.float32)).astype(np.float32)


def _pgs_inputs(seed, c, nl, d, W):
    """Operands shaped like tests/test_batched_step.py:148-171 (env-major)."""
    rng = np.random.RandomState(seed)
    r = 3 * c + 2 * nl
    J = rng.randn(W, 3 * c, d).astype(np.float32)
    Minv = rng.randn(d, d)
    Minv = (Minv @ Minv.T + np.eye(d)).astype(np.float32)
    qd = rng.randn(W, d).astype(np.float32)
    b = np.abs(rng.randn(W, r)).astype(np.float32)
    act = (rng.rand(W, r) > 0.3).astype(np.float32)
    mu = np.abs(rng.rand(W, c)).astype(np.float32)
    return J, np.broadcast_to(Minv, (W, d, d)).copy(), qd, b, act, mu, \
        np.zeros((W, r), np.float32)


@pytest.mark.parametrize("d", [4, 7, 14, 23])
def test_chol_plain_matches_pallas(d):
    import jax.numpy as jnp
    from newton_tpu.solvers.generalized.linalg_pallas import \
        chol_inv_solve_pallas
    W = 128
    rng = np.random.RandomState(d)
    spd = _spd(rng, W, d)
    rhs = rng.randn(W, d).astype(np.float32)
    minv_j, x_j = chol_inv_solve_pallas(
        jnp.asarray(np.transpose(spd, (1, 2, 0))), jnp.asarray(rhs.T),
        interpret=True)
    minv_t, x_t = linalg.chol_inv_solve(torch.as_tensor(spd),
                                        torch.as_tensor(rhs))
    np.testing.assert_allclose(minv_t.numpy(),
                               np.transpose(np.asarray(minv_j), (2, 0, 1)),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j).T, atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("d", [1, 3, 6])
def test_chol_solve_plain_matches_solve_psd(d):
    """B1 without the inverse on the equality systems' sizes (r = 1, 3,
    6) against the JAX package's solve_psd, and bit for bit the x of the
    full plain version."""
    import jax.numpy as jnp
    from newton_tpu.solvers.generalized.linalg import solve_psd
    W = 64
    rng = np.random.RandomState(100 + d)
    spd = _spd(rng, W, d)
    rhs = rng.randn(W, d).astype(np.float32)
    x = linalg.chol_solve(torch.as_tensor(spd), torch.as_tensor(rhs))
    ref = np.asarray(solve_psd(jnp.asarray(spd), jnp.asarray(rhs)))
    np.testing.assert_allclose(x.numpy(), ref, atol=1e-5, rtol=1e-5)
    _, x_full = linalg.chol_inv_solve_plain(torch.as_tensor(spd),
                                            torch.as_tensor(rhs))
    assert torch.equal(x, x_full)


@pytest.mark.parametrize("nl", [0, 3])
@pytest.mark.parametrize("use_cone", [False, True])
def test_pgs_plain_matches_pallas(nl, use_cone):
    import jax.numpy as jnp
    from newton_tpu.solvers.generalized.pgs_pallas import \
        pgs_solve_pallas_fused
    c, d, W = 5, 7, 128
    ld = (1, 4, 6)[:nl]
    args = _pgs_inputs(0, c, nl, d, W)
    kw = dict(c=c, iters=8, omega=0.8, use_cone=use_cone, diag_scale=1.0,
              reg=1e-3)
    lam_j, dqd_j = pgs_solve_pallas_fused(
        *[jnp.asarray(np.moveaxis(a, 0, -1)) for a in args], nl=nl, ld=ld,
        interpret=True, **kw)
    lam_t, dqd_t = pgs.pgs_solve_fused(
        *map(torch.as_tensor, args),
        ld=torch.as_tensor(ld, dtype=torch.int32), **kw)
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j).T,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(dqd_t.numpy(), np.asarray(dqd_j).T,
                               atol=1e-4, rtol=1e-4)


def test_spectral_bound_margin():
    """The power-iteration estimate against dense eigvalsh on random
    rank-deficient Delassus matrices at ant scale (r = 91, d = 14).

    It is a lower bound on lambda_max, as the reference says. Its 1.1
    margin does NOT cover these spectra: the median undershoot is ~1.2x and
    the worst seen ~1.7x, so the per-env divergence guard is what keeps the
    sweep contracting there (test_pgs_divergence_guard_converges). Gated:
    lower bound everywhere, undershoot below 2x."""
    rng = np.random.RandomState(4)
    W, r, d = 64, 91, 14
    J = torch.as_tensor(rng.randn(W, r, d).astype(np.float32))
    A = J @ J.transpose(1, 2)
    diag = torch.diagonal(A, dim1=1, dim2=2) + 1e-3
    act = torch.ones(W, r)
    est = pgs.spectral_lam_max(lambda x: (A @ x[..., None])[..., 0], diag,
                               act, iters=pgs.spectral_iters(r))
    Ds = torch.rsqrt(diag)
    true = torch.linalg.eigvalsh(Ds[:, :, None] * A * Ds[:, None, :])[:, -1]
    ratio = true / est
    assert bool((ratio >= 1 - 1e-4).all())
    assert float(ratio.max()) < 2.0


def test_pgs_divergence_guard_converges():
    """Rank-deficient Delassus (the pile-up shape, as
    test_batched_step.py:185): the plain core settles within 120 sweeps."""
    rng = np.random.RandomState(7)
    W, r, d = 16, 24, 9
    J = torch.as_tensor(rng.randn(W, r, d).astype(np.float32))
    act = torch.as_tensor((rng.rand(W, r) > 0.3).astype(np.float32))
    act[:, 0] = 1.0
    diag = (J * J).sum(2) + 1e-3
    v_free = torch.as_tensor(rng.randn(W, r).astype(np.float32))
    b = torch.as_tensor(np.abs(rng.randn(W, r)).astype(np.float32))
    mu = torch.as_tensor((0.5 + 0.5 * rng.rand(W, r // 3)).astype(
        np.float32))

    def run(iters):
        lam, _, _ = pgs.pgs_core(J, J, None, diag, v_free, b, act, mu,
                                 torch.zeros(W, r), c=r // 3,
                                 ld=torch.zeros(0, dtype=torch.int32),
                                 iters=iters, omega=1.0, use_cone=False)
        return lam
    lam_a, lam_b = run(120), run(121)
    assert bool(torch.isfinite(lam_a).all())
    dn = torch.linalg.vector_norm(lam_b - lam_a, dim=1)
    assert bool((dn <= 1e-2 * (1 + torch.linalg.vector_norm(lam_a, dim=1)))
                .all())


def test_wrappers_check_inputs():
    M = torch.eye(4).expand(2, 4, 4).contiguous()
    # float64 runs the plain version on the CPU; mixed or other types raise
    with pytest.raises(TypeError):
        linalg.chol_inv_solve(M.double(), torch.zeros(2, 4))
    with pytest.raises(TypeError):
        linalg.chol_solve(M.half(), torch.zeros(2, 4).half())
    with pytest.raises(ValueError):
        linalg.chol_inv_solve(M, torch.zeros(2, 5))
    with pytest.raises(ValueError):
        linalg.chol_solve(M, torch.zeros(2, 5))
    args = [torch.as_tensor(a) for a in _pgs_inputs(0, 2, 0, 4, 3)]
    with pytest.raises(ValueError):
        pgs.pgs_solve_fused(*args, c=3, ld=torch.zeros(0, dtype=torch.int32),
                            iters=2, omega=1.0, use_cone=False,
                            diag_scale=1.0, reg=1e-3)


gpu = pytest.mark.gpu
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


@gpu
@needs_cuda
@pytest.mark.parametrize("d", [1, 7, 14, 23, 32])
def test_chol_kernel_matches_plain(d):
    """Every padded instance of the register kernel (d = 1 and 7 run in
    the 8-row one, 32 takes a second pass for its 33rd column), W = 4097:
    a ragged last block of one env."""
    rng = np.random.RandomState(d)
    W = 4097
    Mi = torch.as_tensor(_spd(rng, W, d), device="cuda")
    rhs = torch.as_tensor(rng.randn(W, d).astype(np.float32), device="cuda")
    before = linalg.chol_inv_solve.launches
    minv_k, x_k = linalg.chol_inv_solve(Mi, rhs)
    torch.cuda.synchronize()
    assert linalg.chol_inv_solve.launches == before + 1
    minv_p, x_p = linalg.chol_inv_solve_plain(Mi, rhs)
    torch.testing.assert_close(minv_k, minv_p, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(x_k, x_p, atol=1e-5, rtol=1e-4)


@gpu
@needs_cuda
@pytest.mark.parametrize("d", [1, 3, 6, 45])
def test_chol_solve_kernel_matches_plain(d):
    """The kernel without the inverse (the equality rows' sizes, and the
    generic instance at 45): x bit for bit the plain version's and the
    full kernel's, one count on chol_solve and none on chol_inv_solve."""
    rng = np.random.RandomState(200 + d)
    W = 4097
    Mi = torch.as_tensor(_spd(rng, W, d), device="cuda")
    rhs = torch.as_tensor(rng.randn(W, d).astype(np.float32), device="cuda")
    before = (linalg.chol_solve.launches, linalg.chol_inv_solve.launches)
    x = linalg.chol_solve(Mi, rhs)
    torch.cuda.synchronize()
    assert (linalg.chol_solve.launches,
            linalg.chol_inv_solve.launches) == (before[0] + 1, before[1])
    assert torch.equal(x, linalg.chol_solve_plain(Mi, rhs))
    assert torch.equal(x, linalg.chol_inv_solve(Mi, rhs)[1])


@gpu
@needs_cuda
@pytest.mark.parametrize("c, nl, d, use_cone, W", [
    (25, 8, 14, False, 4096), (25, 8, 14, True, 4096),
    (25, 0, 14, False, 4096), (25, 0, 14, True, 4096),
    (32, 17, 23, False, 4096),       # humanoid compacted to the top 32
    (192, 17, 23, False, 512),       # humanoid uncompacted: > 48 KB smem
    (32, 17, 23, False, 1), (192, 17, 23, True, 1)])
def test_pgs_kernel_matches_plain(c, nl, d, use_cone, W):
    """Ant shapes, and the humanoid's compacted and uncompacted systems
    (the latter needs the large-shared-memory launch and 256 threads),
    also as a single env; envs whose divergence-guard halvings differ are
    counted (at most 0.1%) and left out of the tolerance."""
    args = [torch.as_tensor(a, device="cuda")
            for a in _pgs_inputs(nl, c, nl, d, W)]
    kw = dict(c=c, ld=torch.arange(d - nl, d, dtype=torch.int32,
                                   device="cuda"),
              iters=8, omega=0.8, use_cone=use_cone, diag_scale=1.0,
              reg=1e-3, return_halvings=True)
    lam_k, dqd_k, h_k = pgs.pgs_solve_fused(*args, **kw)
    lam_p, dqd_p, h_p = pgs.pgs_solve_fused_plain(*args, **kw)
    same = h_k == h_p
    assert int((~same).sum()) <= max(W // 1000, 1)
    torch.testing.assert_close(lam_k[same], lam_p[same], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(dqd_k[same], dqd_p[same], atol=1e-3,
                               rtol=1e-3)
    with pytest.raises(TypeError):
        pgs.pgs_solve_fused(*args, **dict(kw, ld=kw["ld"].long()))


@gpu
@needs_cuda
def test_pgs_kernel_tiny_system():
    """(c, nl, d) = (1, 0, 3), W = 4096: three rows reach their fixed point
    within a few sweeps, after which ||dlambda||^2 is rounding noise and
    the 2% guard halves on noise. The plain version in float32 itself
    differs from its float64 run in the halvings of ~0.15% of these envs,
    more than the 0.1% the other shapes allow, so the kernel is held to
    float64 no worse than the plain float32 version plus 0.1%; lam and dqd
    as in test_pgs_kernel_matches_plain where kernel and plain agree."""
    W = 4096
    args = [torch.as_tensor(a, device="cuda")
            for a in _pgs_inputs(0, 1, 0, 3, W)]
    kw = dict(c=1, ld=torch.zeros(0, dtype=torch.int32, device="cuda"),
              iters=8, omega=0.8, use_cone=False, diag_scale=1.0, reg=1e-3,
              return_halvings=True)
    lam_k, dqd_k, h_k = pgs.pgs_solve_fused(*args, **kw)
    lam_p, dqd_p, h_p = pgs.pgs_solve_fused_plain(*args, **kw)
    h_64 = pgs.pgs_solve_fused_plain(*[a.double() for a in args], **kw)[2]
    noise = int((h_p != h_64).sum())
    assert int((h_k != h_64).sum()) <= noise + W // 1000
    same = h_k == h_p
    torch.testing.assert_close(lam_k[same], lam_p[same], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(dqd_k[same], dqd_p[same], atol=1e-3,
                               rtol=1e-3)


@gpu
@needs_cuda
@pytest.mark.parametrize("cap", [None, 8, 0])
def test_humanoid_substep_kernels_match_plain(cap):
    """One humanoid substep through the kernels and one through their plain
    versions from a lying pose (8-15 active contacts per env), at the
    default cap of 32 slots, at 8 (compaction drops active contacts) and
    uncompacted (all 192 slots, the large-shared-memory PGS launch); the
    joint_q/body_q 2e-4 and joint_qd 5e-3 of the CPU parity tests. Envs
    whose divergence-guard halvings differ are counted and left out."""
    import newton_tpu_torch as nt
    dev = torch.device("cuda")
    b = nt.ModelBuilder()
    b.add_mjcf(nt.ASSET_DIR + "/humanoid.xml")
    m = b.finalize(dev)
    solver = nt.SolverMuJoCo(m, iterations=8, integrator="euler",
                             contact_cap=cap)
    W = 512
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    q = m.joint_q0.expand(W, -1) + 0.02 * torch.randn(
        W, 24, generator=gen, device=dev)
    q[:, 2] = 0.1
    q[:, 3:7] = torch.tensor([0.5 ** 0.5, 0.0, 0.0, 0.5 ** 0.5], device=dev)
    qd = 0.1 * torch.randn(W, 23, generator=gen, device=dev)
    s = nt.eval_fk(m, q, qd, nt.batch_state(m.state(), W))
    c = m.control()
    ctl = nt.Control(
        joint_target_q=c.joint_target_q.expand(W, -1).clone(),
        joint_target_qd=torch.zeros(W, 23, device=dev),
        joint_f=torch.zeros(W, 23, device=dev),
        custom={"mjc:ctrl": 0.8 * torch.rand(W, 17, generator=gen,
                                             device=dev) - 0.4})
    contacts = nt.CollisionPipeline(m).collide(s)
    rec = {}
    k = solver.step_batched(s, None, ctl, contacts, 1 / 240, record=rec)
    p = solver.step_batched(s, None, ctl, contacts, 1 / 240, kernels=False)
    args, kw = rec["pgs"]
    h_k = pgs.pgs_solve_fused(*args, **kw, return_halvings=True)[2]
    h_p = pgs.pgs_solve_fused_plain(*args, **kw, return_halvings=True)[2]
    same = h_k == h_p
    assert int((~same).sum()) <= max(W // 1000, 1)
    for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3),
                       ("body_q", 2e-4)):
        torch.testing.assert_close(getattr(k, name)[same],
                                   getattr(p, name)[same], atol=atol,
                                   rtol=atol)


# --- the backward kernels K3 (B1's) and K4 (B2's) and the guards of the
# kernels without one. Tolerances: K3 elementwise atol 1e-5, rtol 1e-4
# against autograd of the plain version (chip_smoke phase 58 (a)); K4
# normwise 1e-3 over each input's gradient on the envs whose halvings
# equal the plain version's (at most 0.1% differ), and NaN exactly where
# the plain version's gradient is NaN.

def _vjp(fn, ins, diff, cots, **kw):
    ins = [t.detach().clone().requires_grad_(i in diff)
           for i, t in enumerate(ins)]
    outs = fn(*ins, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    n = len(cots)
    return torch.autograd.grad(outs[:n], [ins[i] for i in diff], cots), outs


@gpu
@needs_cuda
@pytest.mark.parametrize("which, d, W", [("inv", 14, 4096), ("inv", 23, 4096),
                                         ("solve", 6, 8192),
                                         ("inv", 45, 64), ("inv", 8, 4097),
                                         ("inv", 16, 4097), ("inv", 32, 4097),
                                         ("inv", 6, 37), ("solve", 23, 37)])
def test_k3_matches_plain_autograd(which, d, W):
    """chol_inv_solve's and chol_solve's backward on the card (K3; for
    chol_solve one more B1 solve first) against autograd of the plain
    versions on the same inputs, with cotangents on both outputs."""
    rng = np.random.RandomState(300 + d)
    Mi = torch.as_tensor(_spd(rng, W, d), device="cuda")
    rhs = torch.as_tensor(rng.randn(W, d).astype(np.float32), device="cuda")
    gx = torch.as_tensor(rng.randn(W, d).astype(np.float32), device="cuda")
    gM = torch.as_tensor(rng.randn(W, d, d).astype(np.float32),
                         device="cuda")
    inv = which == "inv"
    kfn = linalg.chol_inv_solve if inv else linalg.chol_solve
    pfn = linalg.chol_inv_solve_plain if inv else linalg.chol_solve_plain
    cots = (gM, gx) if inv else (gx,)
    before = (linalg.chol_backward.launches, linalg.chol_solve.launches)
    gk, outs = _vjp(kfn, (Mi, rhs), (0, 1), cots)
    torch.cuda.synchronize()
    assert all(o.grad_fn is not None for o in outs)
    assert linalg.chol_backward.launches == before[0] + 1
    if not inv:        # the forward's launch and the backward's solve
        assert linalg.chol_solve.launches == before[1] + 2
    gp, _ = _vjp(pfn, (Mi, rhs), (0, 1), cots)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    assert torch.equal(torch.triu(gk[0], 1), torch.zeros_like(gk[0]))


@gpu
@needs_cuda
@pytest.mark.parametrize("absent, d", [("gx", 14), ("gMinv", 14),
                                       ("gx", 45), ("gMinv", 23)])
def test_k3_with_one_cotangent(absent, d):
    """chol_inv_solve's backward with one output's cotangent absent (K3
    with gx or gMinv null) against autograd of the plain version."""
    rng = np.random.RandomState(310 + d)
    W = 4096 if d <= 32 else 64
    Mi = torch.as_tensor(_spd(rng, W, d), device="cuda")
    rhs = torch.as_tensor(rng.randn(W, d).astype(np.float32), device="cuda")
    cot = torch.as_tensor(rng.randn(W, d).astype(np.float32) if absent ==
                          "gMinv" else rng.randn(W, d, d).astype(np.float32),
                          device="cuda")

    def vjp(fn):
        M_ = Mi.clone().requires_grad_(True)
        r_ = rhs.clone().requires_grad_(True)
        Minv, x = fn(M_, r_)
        out = x if absent == "gMinv" else Minv
        return torch.autograd.grad(out, (M_, r_), cot, allow_unused=True)
    before = linalg.chol_backward.launches
    gk = vjp(linalg.chol_inv_solve)
    torch.cuda.synchronize()
    assert linalg.chol_backward.launches == before + 1
    gp = vjp(linalg.chol_inv_solve_plain)
    torch.testing.assert_close(gk[0], gp[0], atol=1e-5, rtol=1e-4)
    if absent == "gx":
        assert gk[1] is None and not gp[1].any()
    else:
        torch.testing.assert_close(gk[1], gp[1], atol=1e-5, rtol=1e-4)


@gpu
@needs_cuda
def test_k3_repeats_bit_equal_without_host_syncs():
    """Two backward passes give the same bits, and K3 (with its wrapper)
    reads nothing back to the host."""
    rng = np.random.RandomState(320)
    W, d = 4096, 14
    Mi = torch.as_tensor(_spd(rng, W, d), device="cuda")
    rhs, gx = (torch.as_tensor(rng.randn(W, d).astype(np.float32),
                               device="cuda") for _ in range(2))
    gM = torch.as_tensor(rng.randn(W, d, d).astype(np.float32),
                         device="cuda")
    Minv, x = linalg.chol_inv_solve(Mi, rhs)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = linalg.chol_backward(Minv, x, gx, gM)
        b = linalg.chol_backward(Minv, x, gx, gM)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for u, v in zip(a, b):
        assert torch.equal(u.view(torch.int32), v.view(torch.int32))


@gpu
@needs_cuda
def test_k3_instances():
    """Every K3 instance reports its registers and resident blocks, and
    the sizes d = 1-50 that linalg.backward_instance gives one name report
    the same kernel's, seven kernels in all."""
    import ctypes
    from newton_tpu_torch import _kernels
    lib = _kernels.lib()
    seen = {}
    for d in range(1, 51):
        regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
        _kernels.check(lib.chol_backward_kernel_info(
            d, ctypes.addressof(regs), ctypes.addressof(blocks)), "K3")
        assert regs.value > 0 and blocks.value > 0, d
        info = seen.setdefault(linalg.backward_instance(d),
                               (regs.value, blocks.value))
        assert info == (regs.value, blocks.value), d
    assert len(seen) == 7


_K4_CASES = {
    "box": (25, 8, 14, False, False, True),
    "cone": (25, 8, 14, True, False, True),
    "nl0": (25, 0, 14, False, False, True),
    "w_other": (25, 8, 14, False, True, True),
    "nonsymmetric": (25, 8, 14, False, False, False),
    "humanoid": (32, 17, 23, False, False, True),
    "uncompacted": (192, 17, 23, False, False, True),
    "humanoid_w_other": (32, 17, 23, True, True, True),
    "humanoid_nonsymmetric": (32, 17, 23, False, False, False),
    "nonsymmetric_w_other": (25, 8, 14, True, True, False),
}


@gpu
@needs_cuda
@pytest.mark.parametrize("case", list(_K4_CASES))
def test_k4_matches_plain_autograd(case):
    """pgs_solve_fused's backward on the card (K4, from the forward that B2
    saved) against autograd of the plain version: the ant's shape with
    the box and the cone, nl = 0, w_other, a non-symmetric Minv, the
    humanoid's compacted system (one- and two-sided, symmetric and not)
    and its uncompacted one (K4's global-scratch instance); envs whose B2
    halvings differ from the plain version's are left out (K4 follows
    B2's); a second backward pass gives the same bits."""
    c, nl, d, cone, two, sym = _K4_CASES[case]
    W = 4096 if c < 100 else 256
    rng = np.random.RandomState(400 + c + nl)
    ops = [torch.as_tensor(a, device="cuda")
           for a in _pgs_inputs(500 + nl, c, nl, d, W)]
    if not sym:
        ops[1] = ops[1] + 0.1 * torch.as_tensor(
            rng.randn(W, d, d).astype(np.float32), device="cuda")
    ld = torch.arange(d - nl, d, dtype=torch.int32, device="cuda")
    kw = dict(c=c, ld=ld, iters=8, omega=0.8, use_cone=cone,
              diag_scale=1.0, reg=1e-3, return_halvings=True,
              symmetric=sym)
    diff = (0, 1, 2, 3, 5, 6)
    if two:
        ops.append(torch.as_tensor(np.abs(rng.rand(W, 3 * c)), device="cuda",
                                   dtype=torch.float32))
        diff = diff + (7,)
    r = 3 * c + 2 * nl
    cots = (torch.as_tensor(rng.randn(W, r).astype(np.float32),
                            device="cuda"),
            torch.as_tensor(rng.randn(W, d).astype(np.float32),
                            device="cuda"))

    def call(fn):
        def f(J, Minv, qd, b, act, mu, lam0, w=None, **k):
            return fn(J, Minv, qd, b, act, mu, lam0, w_other=w, **k)
        return f
    before = pgs.pgs_backward.launches
    gk, ok = _vjp(call(pgs.pgs_solve_fused), ops, diff, cots, **kw)
    torch.cuda.synchronize()
    assert pgs.pgs_backward.launches == before + 1
    assert ok[0].grad_fn is not None and ok[2].grad_fn is None
    gp, op = _vjp(call(pgs.pgs_solve_fused_plain), ops, diff, cots, **kw)
    same = ok[2] == op[2]
    assert int((~same).sum()) <= max(W // 1000, 1)
    for a, b in zip(gk, gp):
        assert torch.equal(torch.isnan(a[same]), torch.isnan(b[same]))
        fin = torch.isfinite(b[same])
        err = (a[same][fin] - b[same][fin]).norm() / b[same][fin].norm()
        assert float(err) <= 1e-3
    gk2, _ = _vjp(call(pgs.pgs_solve_fused), ops, diff, cots, **kw)
    for a, b in zip(gk, gk2):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@gpu
@needs_cuda
def test_kernels_without_backward_refuse_grad():
    """B3, B4, the MPM binning, K1 and K2 have no backward yet: on the card
    each raises on an input that requires grad (never a silent zero), and
    runs under torch.no_grad()."""
    from newton_tpu_torch.geometry import bvh, raycast
    from newton_tpu_torch.solvers import mpm_transfer as mt
    dev = torch.device("cuda")
    n, res = 64, 8
    base = torch.randint(0, res - 2, (n, 3), dtype=torch.int32, device=dev)
    w = torch.full((n, 3, 3), 1.0 / 3.0, device=dev, requires_grad=True)
    vals = torch.ones(n, 4, device=dev)
    with pytest.raises(RuntimeError, match="p2g_apply"):
        mt.p2g_apply(base, w, vals, res)
    grid = torch.ones(res, res, res, 4, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="g2p_apply"):
        mt.g2p_apply(base, w.detach(), grid)
    with torch.no_grad():
        assert mt.p2g_apply(base, w, vals, res).shape == (res, res, res, 4)
    o = torch.zeros(4, 3, device=dev, requires_grad=True)
    dirs = torch.tensor([[0.0, 0.0, -1.0]], device=dev).expand(4, 3)
    X = torch.tensor([[0.0, 0, -1, 0, 0, 0, 1]], device=dev)
    sc = torch.tensor([[0.5, 0.5, 0.5]], device=dev)
    cls = torch.tensor([1], dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="K1"):
        raycast.closest_analytic(o, dirs, X, sc, cls)
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)
    pool = bvh.BVHPool([bvh.MeshBVH(v, f)], [v], dev)
    with pytest.raises(RuntimeError, match="K2"):
        bvh.mesh_closest(pool, o + 0.2, dirs.contiguous(),
                         torch.zeros(1, dtype=torch.int32, device=dev))


@gpu
@needs_cuda
@pytest.mark.parametrize("c, nl, d, iters", [
    (25, 8, 14, 8), (32, 17, 23, 8), (192, 17, 23, 8), (288, 0, 36, 16),
    (1, 0, 3, 8), (0, 2, 4, 30)])
def test_k4_instance_mirror(c, nl, d, iters):
    """pgs.backward_instance / backward_scratch_floats equal the kernel's
    own choice and workspace (pgs_backward_instance,
    pgs_backward_scratch_floats)."""
    from newton_tpu_torch import _kernels
    lib = _kernels.lib()
    code = lib.pgs_backward_instance(c, nl, d, iters)
    assert ("smem", "global")[code] == pgs.backward_instance(c, nl, d, iters)
    assert lib.pgs_backward_scratch_floats(c, nl, d, iters) == \
        pgs.backward_scratch_floats(c, nl, d, iters)
    assert lib.pgs_save_floats(c, nl, d, iters) == \
        pgs.save_floats(c, nl, d, iters)


# --- B2 without grad runs as before its save instances existed: its
# outputs on fixed seeded inputs, as the sha256 of the bytes of lam, dqd
# and the halvings, equal what the kernels gave before (taken on an H100
# with the earlier sources); with an input that requires grad (the save
# instance) the same bits.

_B2_GOLDEN_CASES = {
    "ant": (25, 8, 14, False, False, True, 4096),
    "ant_cone_w_other": (25, 8, 14, True, True, True, 4096),
    "ant_nonsymmetric": (25, 8, 14, False, False, False, 4096),
    "humanoid": (32, 17, 23, False, False, True, 4096),
    "humanoid_w_other": (32, 17, 23, True, True, True, 4096),
    "smem128": (16, 6, 9, False, False, True, 1024),
    "smem256": (192, 17, 23, False, False, True, 256),
}
_B2_GOLDEN = {       # NVIDIA H100 80GB HBM3, B2 before its save instances
    "ant": "be390b47ecb7f97a66a9882650f0841e",
    "ant_cone_w_other": "fe906be59f3df589a10e65bd38c49d32",
    "ant_nonsymmetric": "2e196798b03bc9967809e89dac20e992",
    "humanoid": "8cc107c0580ec4e8224dad433dda7298",
    "humanoid_w_other": "90a868729d877539890d925d0afd8df2",
    "smem128": "a0a51b1c212e90f64d137f54b321a24f",
    "smem256": "ad9ebc21b72dcbf3dec968f35f4eecab",
}


def _b2_golden_inputs(case, device="cuda"):
    """(operands, keywords) of one golden case, from numpy seed 700 +
    its index."""
    c, nl, d, cone, two, sym, W = _B2_GOLDEN_CASES[case]
    rng = np.random.RandomState(700 + list(_B2_GOLDEN_CASES).index(case))
    ops = [torch.as_tensor(a, device=device)
           for a in _pgs_inputs(int(rng.randint(1 << 30)), c, nl, d, W)]
    if not sym:
        ops[1] = ops[1] + 0.1 * torch.as_tensor(
            rng.randn(W, d, d).astype(np.float32), device=device)
    ops[6] = 0.1 * torch.as_tensor(
        np.abs(rng.randn(W, 3 * c + 2 * nl)).astype(np.float32),
        device=device)
    kw = dict(c=c, ld=torch.arange(d - nl, d, dtype=torch.int32,
                                   device=device),
              iters=8, omega=0.8, use_cone=cone, diag_scale=1.0, reg=1e-3,
              return_halvings=True, symmetric=sym)
    if two:
        kw["w_other"] = torch.as_tensor(
            np.abs(rng.rand(W, 3 * c)).astype(np.float32), device=device)
    return ops, kw


def _b2_digest(outs):
    import hashlib
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:32]


@gpu
@needs_cuda
@pytest.mark.parametrize("case", list(_B2_GOLDEN_CASES))
def test_b2_without_grad_unchanged(case):
    """B2 without grad gives the bits it gave before it had save
    instances (register, shared-memory paths; one- and two-sided;
    symmetric and not); with an input that requires grad, the launch that
    also saves the forward gives the same bits."""
    ops, kw = _b2_golden_inputs(case)
    with torch.no_grad():
        outs = pgs.pgs_solve_fused(*ops, **kw)
    assert _b2_digest(outs) == _B2_GOLDEN[case]
    ops[0] = ops[0].clone().requires_grad_(True)
    saved = pgs.pgs_solve_fused(*ops, **kw)
    assert saved[0].grad_fn is not None
    for a, b in zip(outs, saved):
        assert torch.equal(a, b.detach())


# --- K1 on the camera ant x 1024's grid: rows of 64 cameras spread over
# the worlds, and the shadow rays from their hits, bit for bit.

@gpu
@needs_cuda
def test_k1_culling_matches_plain_across_the_grid():
    """K1 (culled) against closest_analytic_plain bit for bit (t, shape,
    normal) on the ant x 1024 scene: whole image rows of 64 track cameras
    across the 32 x 32 grid, their shadow rays toward the light (misses'
    origins 1e10 away, as the camera makes them); K1's counting instance
    gives the same bits, its counters report fewer pairs than rays x
    shapes, and each ray's own passes no more than its warp's work."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke as cs
    import newton_tpu_torch as nt
    from newton_tpu_torch.geometry import raycast
    from newton_tpu_torch.sensors import SensorTiledCamera
    m = cs.camera_ant_scene(nt, cs.CAM_W).finalize("cuda")
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    X = raycast.shape_world_transforms(m, s)
    cls = torch.as_tensor(raycast.shape_classes(m), device="cuda")
    cam = SensorTiledCamera(m, width=cs.CAM_RES, height=cs.CAM_RES,
                            fov_y=cs.CAM_FOV, shadows=True)
    torso = np.nonzero(np.asarray(m.structure.body_key) == "torso")[0]
    poses = torch.cat([s.body_q[torso, :3] + torch.tensor(
        cs.CAM_OFFSET, device="cuda"), torch.tensor(
        cs.CAM_QUAT, device="cuda").expand(cs.CAM_W, 4)], 1)
    sub = cs.camera_rows(cs.CAM_W, cs.CAM_RES, 4096, "cuda")
    o, d = (x[sub].contiguous() for x in cam.rays(poses))
    md = cam.max_dist
    work = {}
    k = raycast.closest_analytic(o, d, X, m.shape_scale, cls, md,
                                 stats=work)
    p = raycast.closest_analytic_plain(o, d, X, m.shape_scale, cls, md)
    assert int((p[1] >= 0).sum()) > 1000
    for a, b in zip(k, p):
        assert torch.equal(a, b) and torch.equal(
            a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(k, raycast.closest_analytic(o, d, X, m.shape_scale,
                                                cls, md)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert work["planes_kept"] == 1
    assert sum(work["pairs"]) < o.shape[0] * X.shape[0] // 50
    assert 0 < work["ray_box_tests"] <= work["box_tests"]
    assert 0 < work["ray_boxes_passed"] <= work["boxes_opened"]
    assert all(0 <= a <= b for a, b in zip(work["ray_pairs"], work["pairs"]))
    assert work["ray_pairs"][0] == o.shape[0]     # the one plane kept
    so = o + d * k[0][:, None] + k[2] * 1e-3
    sd = (-cam._light).expand_as(so).contiguous()
    k = raycast.closest_analytic(so, sd, X, m.shape_scale, cls, md)
    p = raycast.closest_analytic_plain(so, sd, X, m.shape_scale, cls, md)
    for a, b in zip(k, p):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
