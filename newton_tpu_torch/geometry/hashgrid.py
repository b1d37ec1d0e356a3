"""Fixed-radius particle neighbourhoods by sorted spatial hashing (port
of ``newton_tpu/geometry/hashgrid.py``).

Static shapes, no atomics: hash every particle's cell, sort the particles
by hash (a stable sort), then gather a fixed budget of candidates from
each of the 27 neighbouring cells with ``searchsorted``. The hash equals
the JAX package's bit for bit: the products wrap as int32 products do,
``abs`` keeps int32's most negative value negative, and ``%`` takes the
sign of the divisor, so the candidates, their order and the budget's cut
are the JAX package's.
"""

from __future__ import annotations

import torch

__all__ = ["HashGrid", "neighbor_pairs"]

_P1, _P2, _P3 = 73856093, 19349663, 83492791
_OFFSETS = [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
            for k in (-1, 0, 1)]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32's two's-complement range."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


class HashGrid:
    """Stateless neighbour finder with a fixed candidate budget.

    Args:
        cell_size: grid spacing (at least the query radius).
        table_size: hash modulus (a collision only adds candidates that
            the distance test then drops).
        max_per_cell: candidates gathered from each neighbouring cell.
    """

    def __init__(self, cell_size: float, table_size: int = 1 << 16,
                 max_per_cell: int = 4):
        self.cell_size = float(cell_size)
        self.table_size = int(table_size)
        self.max_per_cell = int(max_per_cell)
        self._offsets = {}          # the 27 cell offsets, per device

    def _cell(self, x: torch.Tensor) -> torch.Tensor:
        return torch.floor(x / self.cell_size).to(torch.int32).long()

    def _hash(self, cell: torch.Tensor) -> torch.Tensor:
        """int32 hash of int cells (..., 3) (computed in int64)."""
        h = (_wrap32(cell[..., 0] * _P1) ^ _wrap32(cell[..., 1] * _P2)
             ^ _wrap32(cell[..., 2] * _P3))
        h = torch.where(h == -(1 << 31), h, h.abs())
        return torch.remainder(h, self.table_size)

    def build(self, x: torch.Tensor):
        """Particles sorted by cell hash: (sorted hash, permutation)."""
        h = self._hash(self._cell(x))
        order = torch.argsort(h, stable=True)
        return h[order], order

    def query(self, x: torch.Tensor, radius: float,
              count_overflow: bool = False):
        """Neighbours within ``radius`` of each particle: (idx (N, 27 K)
        int64, mask of the same shape); self pairs and candidates beyond
        the radius are masked off. With ``count_overflow`` also each
        particle's count (N,) int32 of the candidates that its 27 cells
        held beyond the budget of K each (particles whose hash matches the
        cell's, before the distance test), which the query drops."""
        N = x.shape[0]
        K = self.max_per_cell
        h_sorted, perm = self.build(x)
        offs = self._offsets.get(x.device)
        if offs is None:
            offs = self._offsets[x.device] = torch.as_tensor(
                _OFFSETS, dtype=torch.int64, device=x.device)
        nh = self._hash(self._cell(x)[:, None, :] + offs)       # (N, 27)
        start = torch.searchsorted(h_sorted, nh)
        k = torch.arange(K, device=x.device)
        slots = torch.clamp(start[..., None] + k, max=N - 1)    # (N, 27, K)
        cand = perm[slots].reshape(N, 27 * K)
        valid = (h_sorted[slots] == nh[..., None]).reshape(N, 27 * K)
        d = x[cand] - x[:, None, :]
        dist2 = (d * d).sum(-1)
        mask = (valid & (dist2 < radius * radius)
                & (cand != torch.arange(N, device=x.device)[:, None]))
        if not count_overflow:
            return cand, mask
        held = torch.searchsorted(h_sorted, nh, right=True) - start
        over = torch.clamp(held - K, min=0).sum(1).to(torch.int32)
        return cand, mask, over


def neighbor_pairs(x: torch.Tensor, radius: float, cell_size: float = None,
                   max_per_cell: int = 4):
    """One fixed-radius neighbourhood query (see ``HashGrid.query``)."""
    return HashGrid(cell_size or radius,
                    max_per_cell=max_per_cell).query(x, radius)
