"""The least-time accounting of ``chip_smoke.kernel_cost``/``bound_ms``: the
bytes per env that kernels B1 and B2 must move at their main-path shapes
(each input read once, each output written once), the bytes of one MPM
transfer call (G2P counted on the grid nodes it reads,
``chip_smoke.active_nodes``), and the bound as the larger of the bytes
term and the float32 FLOPs term on an H100 SXM."""

import pytest

import chip_smoke


@pytest.mark.parametrize("name, shape, nbytes", [
    ("pgs_solve_fused", dict(c=32, nl=17, d=23), 13344),   # humanoid, top 32
    ("pgs_solve_fused", dict(c=25, nl=8, d=14), 6656),     # ant
    ("chol_inv_solve", dict(d=23), 4416),                  # humanoid
    ("chol_inv_solve", dict(d=14), 1680),                  # ant
    ("chol_solve", dict(d=6), 192),                        # WELD rows
    ("chol_solve", dict(d=1), 12),                         # mimic row
    ("pgs_solve_fused", dict(c=192, nl=17, d=23), 65824),  # uncompacted
    ("pgs_solve_fused", dict(c=72, nl=0, d=6, iters=30), 9124),  # the peg
    ("chol_inv_solve", dict(d=6), 336),                    # the peg
    ("chol_inv_solve", dict(d=12), 1248),                  # two free boxes
    ("chol_backward", dict(d=14), 2520),                   # K3, the ant
    ("chol_backward", dict(d=6, inverse=False), 192),      # K3, AVBD
    ("pgs_backward", dict(c=25, nl=8, d=14), 12520),       # K4, the ant
])
def test_bytes_per_env(name, shape, nbytes):
    got, flops = chip_smoke.kernel_cost(name, **shape)
    assert got == nbytes
    assert flops > 0
    assert chip_smoke.kernel_cost(name, W=4096, **shape) == (4096 * got,
                                                             4096 * flops)


def test_pgs_w_other_cost():
    """Two-sided contacts: B2 also reads the 3c addends of w_other, adds
    them to the diagonal and does one more FMA per contact row in each of
    the 3 + 8 matvecs."""
    c, nl, d = 32, 8, 14
    base_b, base_f = chip_smoke.kernel_cost("pgs_solve_fused", c=c, nl=nl,
                                            d=d)
    got_b, got_f = chip_smoke.kernel_cost("pgs_solve_fused", c=c, nl=nl,
                                          d=d, w_other=True)
    assert got_b == base_b + 4 * 3 * c
    assert got_f == base_f + 3 * c + 2 * 11 * 3 * c


def test_chol_solve_counts_one_column():
    """The solve alone: the factor's FMAs and the two substitutions of one
    column (d (d - 1) FMAs, 2 d divisions), no inverse written."""
    d = 3
    nbytes, flops = chip_smoke.kernel_cost("chol_solve", d=d)
    assert nbytes == 4 * (d * d + 2 * d)
    assert flops == 2 * ((d - 1) * d * (d + 1) // 6 + d * (d - 1)) + 3 * d
    full = chip_smoke.kernel_cost("chol_inv_solve", d=d)
    assert nbytes < full[0] and flops < full[1]


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


def test_pgs_flops_peg():
    """The peg's B2 (72, 0, 6) at 30 iterations: 216 contact rows, no
    limit rows, 8 spectral iterations (216 rows >= 192) and 30 sweeps."""
    r3, d = 216, 6
    fma = r3 * d * d + 2 * r3 * d + 38 * (2 * r3 * d) + r3 * d
    assert chip_smoke.kernel_cost("pgs_solve_fused", c=72, nl=0, d=6,
                                  iters=30)[1] == 2 * fma == 220320


@pytest.mark.parametrize("name, shape, by", [
    ("pgs_solve_fused", dict(c=32, nl=17, d=23, W=4096), "bytes"),
    ("pgs_solve_fused", dict(c=192, nl=17, d=23, W=4096), "operations"),
    ("chol_inv_solve", dict(d=23, W=4096), "bytes"),
    ("pgs_solve_fused", dict(c=72, nl=0, d=6, iters=30, W=4096),
     "operations"),
    ("mpm_p2g", dict(N=32768, C=13, res=64), "bytes"),
    ("mpm_g2p", dict(N=32768, C=12, active_nodes=14283), "bytes"),
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
    writes the dense 64^3 x 13 grid: ~16.9 MB a call. G2P reads the
    particles and only the nodes their stencils touch (~14.3k for the sand
    column, 5.5% of the grid), and writes 12 channels: ~3.8 MB."""
    p2g = chip_smoke.kernel_cost("mpm_p2g", N=32768, C=13, res=64)[0]
    g2p = chip_smoke.kernel_cost("mpm_g2p", N=32768, C=12,
                                 active_nodes=14283)[0]
    assert p2g == 32768 * (12 + 36 + 52) + 64 ** 3 * 52
    assert g2p == 32768 * (12 + 36 + 48) + 14283 * 48
    # the bound moves with the touched nodes only
    more = chip_smoke.kernel_cost("mpm_g2p", N=32768, C=12,
                                  active_nodes=14284)[0]
    assert more - g2p == 48


def test_mpm_bin_bytes():
    """The binning reads the (N, 3) int32 bases and writes the (N, 4)
    int32 sorted particles, the offsets and slots of its K tiles and a
    record of 3 ints per non-empty tile; bound by bytes (no float work)."""
    nbytes, flops = chip_smoke.kernel_cost("mpm_bin", N=32768, tiles=4096,
                                           active_tiles=252)
    assert nbytes == 32768 * 28 + (2 * 4096 + 2 + 3 * 252) * 4
    assert flops == 0
    assert chip_smoke.bound_ms(nbytes, flops)[1] == "bytes"


def test_active_nodes_by_hand():
    """Distinct clipped stencil nodes at res 4: a base past the lower
    border clips to node 0 on that axis (one node), a base at res - 1 to
    node 3; overlapping stencils count their shared nodes once."""
    import torch
    cases = [
        ([[0, 0, 0]], 27),
        ([[-2, -2, -2]], 1),                  # (0, 0, 0) 27 times
        ([[3, 3, 3]], 1),                     # (3, 3, 3) 27 times
        ([[-1, 3, 0]], 2 * 1 * 3),            # x {0, 1}, y {3}, z {0, 1, 2}
        ([[2, 0, -1]], 2 * 3 * 2),            # x {2, 3}, y {0..2}, z {0, 1}
        ([[0, 0, 0], [1, 0, 0]], 4 * 3 * 3),  # x {0..3} shared
        ([[0, 0, 0], [0, 0, 0]], 27),         # duplicates count once
        ([[-2, -2, -2], [-5, 0, -3]], 3),     # (0, 0, 0), (0, {0, 1, 2}, 0)
    ]
    for base, want in cases:
        got = chip_smoke.active_nodes(torch.tensor(base, dtype=torch.int32),
                                      4)
        assert got == want, (base, got, want)


def test_unknown_kernel_raises():
    with pytest.raises(KeyError):
        chip_smoke.kernel_cost("svd3", N=1)


def test_backward_flops_count():
    """K3: grhs = Minv gx, T = gMinv Minv and Minv T (2 d^3 FMAs), the
    outer product and sum, the fold (d^2 / 2); without the inverse only
    the outer product and the fold. K4: B2's forward again, then per
    matvec the adjoint's 4 x 3c d + 2 nl d FMAs, dqd's adjoint and the
    assembly's (2 x 3c d^2 + 3 x 3c d)."""
    d = 14
    assert chip_smoke.kernel_cost("chol_backward", d=d)[1] == \
        4 * d ** 3 + 4 * d * d + d * d // 2
    assert chip_smoke.kernel_cost("chol_backward", d=d, inverse=False)[1] \
        == d * d + d * d // 2
    c, nl, r3 = 25, 8, 75
    fwd = chip_smoke.kernel_cost("pgs_solve_fused", c=c, nl=nl, d=d)[1]
    bwd = 11 * (4 * r3 * d + 2 * nl * d) + r3 * d + nl * d \
        + 2 * r3 * d * d + 3 * r3 * d
    assert chip_smoke.kernel_cost("pgs_backward", c=c, nl=nl, d=d)[1] == \
        fwd + 2 * bwd
    two = chip_smoke.kernel_cost("pgs_backward", c=c, nl=nl, d=d,
                                 w_other=True)
    base = chip_smoke.kernel_cost("pgs_backward", c=c, nl=nl, d=d)
    assert two[0] == base[0] + 2 * 4 * r3
