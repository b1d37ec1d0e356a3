"""The least-time accounting of ``chip_smoke.kernel_cost``/``bound_ms``: the
bytes per env that kernels B1 and B2 must move at their main-path shapes
(each input read once, each output written once), and the bound as the
larger of the bytes term and the float32 FLOPs term on an H100 SXM."""

import pytest

import chip_smoke


@pytest.mark.parametrize("name, shape, nbytes", [
    ("pgs_solve_fused", dict(c=32, nl=17, d=23), 13344),   # humanoid, top 32
    ("pgs_solve_fused", dict(c=25, nl=8, d=14), 6656),     # ant
    ("chol_inv_solve", dict(d=23), 4416),                  # humanoid
    ("chol_inv_solve", dict(d=14), 1680),                  # ant
    ("pgs_solve_fused", dict(c=192, nl=17, d=23), 65824),  # uncompacted
])
def test_bytes_per_env(name, shape, nbytes):
    got, flops = chip_smoke.kernel_cost(name, **shape)
    assert got == nbytes
    assert flops > 0
    assert chip_smoke.kernel_cost(name, W=4096, **shape) == (4096 * got,
                                                             4096 * flops)


def test_pgs_flops_count():
    """The MJ assembly (3c d^2 FMAs) plus 3 spectral + 8 sweep matvecs of
    2 x 3c d + nl d, diag/v_free and dqd, 2 FLOPs per FMA."""
    c, nl, d = 32, 17, 23
    r3 = 3 * c
    fma = (r3 * d * d + 11 * (2 * r3 * d + nl * d) + 2 * r3 * d
           + r3 * d + nl * d)
    assert chip_smoke.kernel_cost("pgs_solve_fused", c=c, nl=nl, d=d)[1] \
        == 2 * fma
    # 192 contacts: 8 spectral iterations instead of 3
    big = chip_smoke.kernel_cost("pgs_solve_fused", c=192, nl=17, d=23)[1]
    assert big == 2 * (576 * 529 + 16 * (2 * 576 * 23 + 17 * 23)
                       + 2 * 576 * 23 + 576 * 23 + 17 * 23)


@pytest.mark.parametrize("name, shape, by", [
    ("pgs_solve_fused", dict(c=32, nl=17, d=23, W=4096), "bytes"),
    ("pgs_solve_fused", dict(c=192, nl=17, d=23, W=4096), "operations"),
    ("chol_inv_solve", dict(d=23, W=4096), "bytes"),
    ("mpm_p2g", dict(N=32768, C=13, res=64), "bytes"),
    ("mpm_g2p", dict(N=32768, C=12, res=64), "bytes"),
])
def test_bound_is_the_larger_term(name, shape, by):
    nbytes, flops = chip_smoke.kernel_cost(name, **shape)
    ms, got_by = chip_smoke.bound_ms(nbytes, flops)
    t_bytes = nbytes / chip_smoke.PEAK_BYTES_PER_S * 1e3
    t_flops = flops / chip_smoke.PEAK_F32_FLOPS * 1e3
    assert ms == pytest.approx(max(t_bytes, t_flops), rel=1e-12)
    assert got_by == by
    assert ms >= min(t_bytes, t_flops)


def test_mpm_transfer_bytes():
    """P2G reads base, weights and 13 channels of 32768 particles and
    writes the 64^3 x 13 grid: ~16.9 MB a call; G2P the reverse, ~15.7 MB."""
    p2g = chip_smoke.kernel_cost("mpm_p2g", N=32768, C=13, res=64)[0]
    g2p = chip_smoke.kernel_cost("mpm_g2p", N=32768, C=12, res=64)[0]
    assert p2g == 32768 * (12 + 36 + 52) + 64 ** 3 * 52
    assert g2p == 32768 * (12 + 36 + 48) + 64 ** 3 * 48


def test_unknown_kernel_raises():
    with pytest.raises(KeyError):
        chip_smoke.kernel_cost("svd3", N=1)
