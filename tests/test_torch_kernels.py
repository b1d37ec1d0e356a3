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
