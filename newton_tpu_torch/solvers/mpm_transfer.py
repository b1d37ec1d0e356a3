"""MPM particle<->grid transfers (port of the TPU kernels in
``newton_tpu/solvers/mpm_pallas.py``).

Both transfers use the separable quadratic B-spline stencil of MLS-MPM:
particle n touches the 27 nodes ``base[n] + (i, j, k)``, i, j, k in
{0, 1, 2}, with weight ``w_ax[n, i, 0] * w_ax[n, j, 1] * w_ax[n, k, 2]``.
Node indices are clipped to ``[0, res - 1]`` per axis, so at the border a
particle's duplicate nodes sum (as ``mpm_pallas._axis_weights`` clips).

- ``p2g_apply(base, w_ax, vals, res)``: scatter ``vals (N, C)`` onto the
  grid, ``G[i, j, k, c] = sum_n W_n(i, j, k) vals[n, c]`` -> (res, res, res,
  C);
- ``g2p_apply(base, w_ax, grid)``: gather ``grid (res, res, res, C)`` back,
  ``P[n, c] = sum_nodes W_n(node) grid[node, c]`` -> (N, C);
- ``bin_particles(base, res)``: the particles grouped by grid tile (4^3
  cells), which both kernels work on. A caller that transfers several times
  with one ``base`` (an MPM step) bins once and passes ``bins=`` to every
  call; without it each call bins for itself.

``base`` is (N, 3) int32 (the lower stencil node), ``w_ax`` (N, 3 offsets,
3 axes) float32. On CUDA tensors the wrappers launch the hand-written
kernels in ``csrc/mpm_transfer.cu`` (or raise); on CPU tensors they run the
plain PyTorch versions beside them (``index_add_`` for the scatter,
indexing for the gather, a stable sort for the binning). Each wrapper
counts its launches in ``.launches``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Bins", "bin_particles", "bin_particles_plain", "p2g_apply",
           "g2p_apply", "p2g_apply_plain", "g2p_apply_plain"]

_OFFS = [(i, j, k) for i in range(3) for j in range(3) for k in range(3)]
TILE = 4                              # cells per tile edge (csrc: kTile)
_BIN_BLOCKS = 8                       # blocks of the binning (kBinCluster)
_SPAN_NODES = (TILE + 2) ** 3         # nodes of a tile's stencils


def _stencil(base: torch.Tensor, w_ax: torch.Tensor, res: int):
    """Flat node index (N, 27) int64 and weight (N, 27) of every particle's
    27-node stencil, node indices clipped per axis to ``[0, res - 1]``."""
    offs = torch.tensor(_OFFS, dtype=torch.int64, device=base.device)
    cell = torch.clamp(base.long()[:, None, :] + offs[None], 0, res - 1)
    flat = (cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]
    w = (w_ax[:, offs[:, 0], 0] * w_ax[:, offs[:, 1], 1]
         * w_ax[:, offs[:, 2], 2])
    return flat, w


def p2g_apply_plain(base: torch.Tensor, w_ax: torch.Tensor,
                    vals: torch.Tensor, res: int) -> torch.Tensor:
    """Plain PyTorch scatter: (res, res, res, C) in the dtype of ``vals``."""
    N, C = vals.shape
    flat, w = _stencil(base, w_ax.to(vals.dtype), res)
    out = torch.zeros((res ** 3, C), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, flat.reshape(-1),
                   (w[..., None] * vals[:, None, :]).reshape(-1, C))
    return out.reshape(res, res, res, C)


def g2p_apply_plain(base: torch.Tensor, w_ax: torch.Tensor,
                    grid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch gather: (N, C) in the dtype of ``grid``."""
    res, C = grid.shape[0], grid.shape[-1]
    flat, w = _stencil(base, w_ax.to(grid.dtype), res)
    return (w[..., None] * grid.reshape(-1, C)[flat]).sum(dim=1)


def tiles(res: int) -> tuple[int, int]:
    """(tiles per axis, tiles) of a res^3 grid: ceil(res / 4) and its
    cube."""
    nt = -(-res // TILE)
    return nt, nt ** 3


def meta_size(res: int) -> int:
    """int32 entries of :class:`Bins`' ``meta`` at ``res``."""
    return (_BIN_BLOCKS + 5) * tiles(res)[1] + 2


def tile_of(base: torch.Tensor, res: int) -> torch.Tensor:
    """(N,) int64 tile of each particle: the tile holding its clipped lower
    stencil node ``clamp(base, 0, res - 1)``, whose node block [4 t, 4 t +
    6)^3 then holds all of its clipped nodes."""
    nt, _ = tiles(res)
    t = torch.clamp(base.long(), 0, res - 1) // TILE
    return (t[:, 0] * nt + t[:, 1]) * nt + t[:, 2]


@dataclass(frozen=True)
class Bins:
    """Particles grouped by tile, from :func:`bin_particles`.

    ``meta`` (13 K + 2,) int32, K tiles, holds in order: the binning's
    workspace (8 K, unspecified), ``offsets`` (K + 1; tile t's particles
    are ``sorted[offsets[t]:offsets[t + 1]]``), ``slot_of`` (K; the tile's
    rank among the non-empty tiles, or -1), ``nactive`` and ``records`` (K
    x 3: tile, begin and end of each non-empty tile in ascending order; the
    rows past nactive unspecified). ``sorted`` (N, 4) int32 is each
    particle's base and index, grouped by tile; the order inside a tile is
    unspecified (the kernel places with atomics)."""
    res: int
    meta: torch.Tensor
    sorted: torch.Tensor

    def _part(self, start: int, n: int) -> torch.Tensor:
        return self.meta[start:start + n]

    @property
    def offsets(self) -> torch.Tensor:
        K = tiles(self.res)[1]
        return self._part(_BIN_BLOCKS * K, K + 1)

    @property
    def slot_of(self) -> torch.Tensor:
        K = tiles(self.res)[1]
        return self._part((_BIN_BLOCKS + 1) * K + 1, K)

    @property
    def nactive(self) -> int:
        K = tiles(self.res)[1]
        return int(self._part((_BIN_BLOCKS + 2) * K + 1, 1)[0])

    @property
    def records(self) -> torch.Tensor:
        """(nactive, 3): tile, begin, end of each non-empty tile."""
        K = tiles(self.res)[1]
        rec = self._part((_BIN_BLOCKS + 2) * K + 2, 3 * K).reshape(K, 3)
        return rec[:self.nactive]

    @property
    def active(self) -> torch.Tensor:
        return self.records[:, 0]

    @property
    def perm(self) -> torch.Tensor:
        return self.sorted[:, 3]


def bin_particles_plain(base: torch.Tensor, res: int) -> Bins:
    """Plain PyTorch binning: a stable sort by tile (inside a tile the
    particles keep their order)."""
    K = tiles(res)[1]
    key = tile_of(base, res)
    perm = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=K)
    full = counts > 0
    nactive = int(full.sum())
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    tile = torch.nonzero(full).reshape(-1)
    rec = torch.full((K, 3), -1, dtype=torch.int64, device=base.device)
    rec[:nactive] = torch.stack([tile, offsets[tile], offsets[tile + 1]], 1)
    zero = counts.new_zeros(1)
    meta = torch.cat([torch.zeros(_BIN_BLOCKS * K, dtype=counts.dtype,
                                  device=base.device), offsets,
                      torch.where(full, torch.cumsum(full, 0) - 1, -1),
                      zero + nactive, rec.reshape(-1)]).to(torch.int32)
    sorted_ = torch.cat([base[perm], perm[:, None].to(torch.int32)], dim=1)
    return Bins(res, meta, sorted_.contiguous())


def _check_base(name: str, base: torch.Tensor):
    if base.dtype != torch.int32:
        raise TypeError(f"{name} takes base as int32, got {base.dtype}")
    if base.dim() != 2 or base.shape[1] != 3:
        raise ValueError(f"{name}: base must be (N, 3), got "
                         f"{tuple(base.shape)}")
    if base.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {base.device}")


def bin_particles(base: torch.Tensor, res: int) -> Bins:
    """Group particles by the tile of their clipped lower stencil node.

    base (N, 3) int32 (any values: bases outside the grid are binned by
    their clipped node). CUDA tensors go to the kernels (a counting sort,
    or raise); CPU tensors to the plain version."""
    _check_base("bin_particles", base)
    if res < 1:
        raise ValueError(f"bin_particles: res must be positive, got {res}")
    if base.device.type == "cpu":
        return bin_particles_plain(base, res)
    if not base.is_contiguous():
        raise ValueError("bin_particles kernel takes a contiguous base")
    from .. import _kernels
    _kernels.refuse_grad("bin_particles", base)
    N = base.shape[0]
    K = tiles(res)[1]
    meta = torch.empty((_kernels.lib().mpm_meta_ints(res),),
                       dtype=torch.int32, device=base.device)
    sorted_ = torch.empty((N, 4), dtype=torch.int32, device=base.device)
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().mpm_bin_particles(
            base.data_ptr(), meta.data_ptr(), sorted_.data_ptr(), N, res,
            stream)
    bin_particles.launches += 1
    _kernels.check(err, "bin_particles")
    return Bins(res, meta, sorted_)


def _check(name: str, base: torch.Tensor, w_ax: torch.Tensor,
           data: torch.Tensor, data_name: str, res: int, bins):
    _check_base(name, base)
    if w_ax.dtype != torch.float32 or data.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 w_ax and {data_name}")
    N = base.shape[0]
    if w_ax.shape != (N, 3, 3):
        raise ValueError(f"{name}: base must be (N, 3) and w_ax (N, 3, 3), "
                         f"got {tuple(base.shape)} and {tuple(w_ax.shape)}")
    if not (base.device == w_ax.device == data.device):
        raise ValueError(f"{name}: tensors must be on one device")
    if bins is not None and (bins.res != res
                             or bins.sorted.shape != (N, 4)
                             or bins.meta.device != base.device):
        raise ValueError(f"{name}: bins are not bin_particles(base, {res}) "
                         f"of these {N} particles on {base.device}")
    if data.device.type == "cuda" and not all(
            t.is_contiguous() for t in (base, w_ax, data)):
        raise ValueError(f"{name} kernel takes contiguous tensors")


def p2g_apply(base: torch.Tensor, w_ax: torch.Tensor, vals: torch.Tensor,
              res: int, bins: Bins | None = None) -> torch.Tensor:
    """Scatter per-particle channel values onto the dense grid.

    base (N, 3) int32; w_ax (N, 3, 3) float32; vals (N, C) float32; bins,
    when given, ``bin_particles(base, res)`` (the kernel reads the bases
    from it). Returns (res, res, res, C) float32. CUDA tensors go to the
    kernels (or raise); CPU tensors to the plain version."""
    _check("p2g_apply", base, w_ax, vals, "vals", res, bins)
    if vals.dim() != 2 or vals.shape[0] != base.shape[0]:
        raise ValueError(f"p2g_apply: vals must be (N, C) with N = "
                         f"{base.shape[0]}, got {tuple(vals.shape)}")
    if res < 1:
        raise ValueError(f"p2g_apply: res must be positive, got {res}")
    if vals.device.type == "cpu":
        return p2g_apply_plain(base, w_ax, vals, res)
    from .. import _kernels
    _kernels.refuse_grad("p2g_apply (B3)", w_ax, vals)
    if bins is None:
        bins = bin_particles(base, res)
    N, C = vals.shape
    slots = min(tiles(res)[1], N)
    grid = torch.empty((res, res, res, C), dtype=torch.float32,
                       device=vals.device)
    scratch = torch.empty((slots * _SPAN_NODES * C,), dtype=torch.float32,
                          device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().mpm_p2g_binned_f32(
            w_ax.data_ptr(), vals.data_ptr(), bins.meta.data_ptr(),
            bins.sorted.data_ptr(), scratch.data_ptr(), grid.data_ptr(), N,
            C, res, stream)
    p2g_apply.launches += 1
    _kernels.check(err, "p2g_apply")
    return grid


def g2p_apply(base: torch.Tensor, w_ax: torch.Tensor, grid: torch.Tensor,
              bins: Bins | None = None) -> torch.Tensor:
    """Gather grid channels back to particles.

    grid (res, res, res, C) float32 -> (N, C) float32, per-particle sums
    weighted by the stencil; bins as for :func:`p2g_apply`. CUDA tensors go
    to the kernel (or raise); CPU tensors to the plain version."""
    res = grid.shape[0]
    if grid.dim() != 4 or grid.shape[:3] != (res, res, res):
        raise ValueError(f"g2p_apply: grid must be (res, res, res, C), got "
                         f"{tuple(grid.shape)}")
    _check("g2p_apply", base, w_ax, grid, "grid", res, bins)
    if grid.device.type == "cpu":
        return g2p_apply_plain(base, w_ax, grid)
    from .. import _kernels
    _kernels.refuse_grad("g2p_apply (B4)", w_ax, grid)
    if bins is None:
        bins = bin_particles(base, res)
    N, C = base.shape[0], grid.shape[-1]
    out = torch.empty((N, C), dtype=torch.float32, device=grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().mpm_g2p_binned_f32(
            w_ax.data_ptr(), grid.data_ptr(), bins.meta.data_ptr(),
            bins.sorted.data_ptr(), out.data_ptr(), N, C, res, stream)
    g2p_apply.launches += 1
    _kernels.check(err, "g2p_apply")
    return out


bin_particles.launches = 0
p2g_apply.launches = 0
g2p_apply.launches = 0
