"""The tile binning of the MPM transfers (``mpm_transfer.bin_particles``),
on the CPU through its plain version.

The CUDA transfer kernels work on particles grouped by the 4^3-cell tile of
their clipped lower stencil node; these cases hold the plain binning to
what the kernels rely on: a permutation grouped by tile with monotone
offsets that cover N, the non-empty tile list, every clipped stencil node
inside its tile's 6^3 node block, for bases past both borders, all
particles in one cell, and no particles. The kernels' own binning is held
against this one on the card (``tests/test_torch_mpm.py``, ``gpu``)."""

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.solvers import mpm_transfer as mt

RES = (1, 3, 16, 64)


def _bases(case, res, n=600, seed=0):
    rng = np.random.RandomState(seed)
    if case == "random":
        base = rng.randint(-2, res + 1, (n, 3))
    elif case == "one cell":
        base = np.tile([[res // 2, max(res - 2, 0), 0]], (n, 1))
    else:                                   # "empty"
        base = np.zeros((0, 3))
    return torch.as_tensor(base, dtype=torch.int32)


CASES = [(c, r) for c in ("random", "one cell", "empty") for r in RES]


@pytest.mark.parametrize("case, res", CASES)
def test_bins_group_particles_by_tile(case, res):
    base = _bases(case, res)
    N = base.shape[0]
    bins = mt.bin_particles(base, res)
    nt_, K = mt.tiles(res)
    assert nt_ == -(-res // 4) and bins.meta.shape == (mt.meta_size(res),)
    assert bins.meta.dtype == bins.sorted.dtype == torch.int32
    perm = bins.perm.long()
    assert torch.equal(torch.sort(perm).values, torch.arange(N))
    assert torch.equal(bins.sorted[:, :3], base[perm])
    off = bins.offsets.long()
    assert off[0] == 0 and off[-1] == N and bool((off[1:] >= off[:-1]).all())
    key = mt.tile_of(base, res)
    counts = off[1:] - off[:-1]
    assert torch.equal(counts, torch.bincount(key, minlength=K))
    assert torch.equal(key[perm], torch.repeat_interleave(torch.arange(K),
                                                          counts))
    full = torch.nonzero(counts).reshape(-1)
    assert bins.nactive == full.numel() and torch.equal(bins.active.long(),
                                                        full)
    slot = bins.slot_of.long()
    assert torch.equal(slot[full], torch.arange(full.numel()))
    assert torch.equal(bins.records.long(),
                       torch.stack([full, off[full], off[full + 1]], 1))
    assert bool((slot[counts == 0] == -1).all())
    # stable: inside a tile the plain version keeps the particle order
    for t in full[:8].tolist():
        assert bool((perm[off[t]:off[t + 1]].diff() > 0).all())


@pytest.mark.parametrize("res", RES)
def test_stencil_nodes_lie_in_the_tile_node_block(res):
    """Each clipped stencil node of a particle in tile t lies in [4 t,
    4 t + 6) per axis: the node block the kernels hold in shared memory."""
    base = _bases("random", res, n=2000, seed=res)
    nt_, _ = mt.tiles(res)
    key = mt.tile_of(base, res)
    t = torch.stack([key // (nt_ * nt_), (key // nt_) % nt_, key % nt_], 1)
    nodes = torch.clamp(base.long()[:, :, None] + torch.arange(3), 0,
                        res - 1)                     # (N, axis, offset)
    local = nodes - 4 * t[:, :, None]
    assert bool((local >= 0).all()) and bool((local < 6).all())
    if res > 4:
        assert int(local.max()) == 5             # the halo is used


def test_bins_of_border_bases_by_hand():
    """Bases outside the grid bin by their clipped node: at res 16, (-2, 17,
    5) clips to (0, 15, 5): tile (0, 3, 1) of 4 per axis."""
    base = torch.tensor([[-2, 17, 5], [0, 15, 7], [3, 12, 4], [4, 0, 0]],
                        dtype=torch.int32)
    assert mt.tile_of(base, 16).tolist() == [13, 13, 13, 16]
    bins = mt.bin_particles(base, 16)
    assert bins.nactive == 2 and bins.active.tolist() == [13, 16]
    assert bins.perm.tolist() == [0, 1, 2, 3]
    assert bins.offsets[13:18].tolist() == [0, 3, 3, 3, 4]


@pytest.mark.parametrize("res", (3, 16))
def test_transfers_with_bins_equal_without(res):
    rng = np.random.RandomState(res)
    n = 700
    base = torch.as_tensor(rng.randint(-2, res + 1, (n, 3)),
                           dtype=torch.int32)
    w = torch.as_tensor(rng.rand(n, 3, 3), dtype=torch.float32)
    vals = torch.as_tensor(rng.randn(n, 13), dtype=torch.float32)
    grid = torch.as_tensor(rng.randn(res, res, res, 12), dtype=torch.float32)
    bins = mt.bin_particles(base, res)
    assert torch.equal(mt.p2g_apply(base, w, vals, res, bins=bins),
                       mt.p2g_apply(base, w, vals, res))
    assert torch.equal(mt.g2p_apply(base, w, grid, bins=bins),
                       mt.g2p_apply(base, w, grid))


def test_transfers_reject_foreign_bins():
    rng = np.random.RandomState(1)
    base = torch.as_tensor(rng.randint(0, 8, (50, 3)), dtype=torch.int32)
    w = torch.as_tensor(rng.rand(50, 3, 3), dtype=torch.float32)
    vals = torch.zeros((50, 4))
    with pytest.raises(ValueError):             # another res
        mt.p2g_apply(base, w, vals, 8, bins=mt.bin_particles(base, 16))
    with pytest.raises(ValueError):             # other particles
        mt.g2p_apply(base, w, torch.zeros((8, 8, 8, 4)),
                     bins=mt.bin_particles(base[:40], 8))
    with pytest.raises(TypeError):
        mt.bin_particles(base.long(), 8)
    with pytest.raises(ValueError):
        mt.bin_particles(base, 0)


def test_step_bins_once_and_matches_the_plain_path():
    """``SolverImplicitMPM.step`` bins once per step (``stencil(x,
    binned=True)``) and passes the bins to every transfer: on the CPU the
    binned step equals the plain step, with and without the CG solve."""
    rng = np.random.RandomState(3)
    pts = rng.uniform(-0.2, 0.2, (400, 3))
    pts[:, 2] = rng.uniform(0.05, 0.5, 400)
    b = nt.ModelBuilder()
    b.add_particles(pts, mass=0.002)
    m = b.finalize("cpu")
    for iters in (0, 2):
        solver = nt.SolverImplicitMPM(m, resolution=16, friction_angle=0.6,
                                      young=5e4, implicit_iterations=iters)
        s = solver.init_state(m.state())
        xp, base, w_ax, bins = solver.stencil(s.particle_q, binned=True)
        assert solver.stencil(s.particle_q)[3] is None
        ref = mt.bin_particles_plain(base, 16)
        assert torch.equal(bins.meta, ref.meta)
        assert torch.equal(bins.sorted, ref.sorted)
        k = solver.step(s, None, None, None, 4e-4)
        p = solver.step(s, None, None, None, 4e-4, kernels=False)
        for name in ("particle_q", "particle_qd"):
            assert torch.equal(getattr(k, name), getattr(p, name))
        for name in ("mpm:F", "mpm:C"):
            assert torch.equal(k.custom[name], p.custom[name])
