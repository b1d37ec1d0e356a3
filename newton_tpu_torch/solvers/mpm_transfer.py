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
  ``P[n, c] = sum_nodes W_n(node) grid[node, c]`` -> (N, C).

``base`` is (N, 3) int32 (the lower stencil node), ``w_ax`` (N, 3 offsets,
3 axes) float32. On CUDA tensors the wrappers launch the hand-written
kernels in ``csrc/mpm_transfer.cu`` (or raise); on CPU tensors they run the
plain PyTorch versions beside them (``index_add_`` for the scatter,
indexing for the gather). Each wrapper counts its kernel launches in
``.launches``.
"""

from __future__ import annotations

import torch

__all__ = ["p2g_apply", "g2p_apply", "p2g_apply_plain", "g2p_apply_plain"]

_OFFS = [(i, j, k) for i in range(3) for j in range(3) for k in range(3)]


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


def _check(name: str, base: torch.Tensor, w_ax: torch.Tensor,
           data: torch.Tensor, data_name: str):
    if base.dtype != torch.int32:
        raise TypeError(f"{name} takes base as int32, got {base.dtype}")
    if w_ax.dtype != torch.float32 or data.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 w_ax and {data_name}")
    N = base.shape[0]
    if base.shape != (N, 3) or w_ax.shape != (N, 3, 3):
        raise ValueError(f"{name}: base must be (N, 3) and w_ax (N, 3, 3), "
                         f"got {tuple(base.shape)} and {tuple(w_ax.shape)}")
    if not (base.device == w_ax.device == data.device):
        raise ValueError(f"{name}: tensors must be on one device")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {data.device}")
    if data.device.type == "cuda" and not all(
            t.is_contiguous() for t in (base, w_ax, data)):
        raise ValueError(f"{name} kernel takes contiguous tensors")


def p2g_apply(base: torch.Tensor, w_ax: torch.Tensor, vals: torch.Tensor,
              res: int) -> torch.Tensor:
    """Scatter per-particle channel values onto the dense grid.

    base (N, 3) int32; w_ax (N, 3, 3) float32; vals (N, C) float32.
    Returns (res, res, res, C) float32. CUDA tensors go to the kernel (or
    raise); CPU tensors to the plain version."""
    _check("p2g_apply", base, w_ax, vals, "vals")
    if vals.dim() != 2 or vals.shape[0] != base.shape[0]:
        raise ValueError(f"p2g_apply: vals must be (N, C) with N = "
                         f"{base.shape[0]}, got {tuple(vals.shape)}")
    if res < 1:
        raise ValueError(f"p2g_apply: res must be positive, got {res}")
    if vals.device.type == "cpu":
        return p2g_apply_plain(base, w_ax, vals, res)
    from .. import _kernels
    N, C = vals.shape
    grid = torch.zeros((res, res, res, C), dtype=torch.float32,
                       device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().mpm_p2g_f32(
            base.data_ptr(), w_ax.data_ptr(), vals.data_ptr(),
            grid.data_ptr(), N, C, res, stream)
    p2g_apply.launches += 1
    _kernels.check(err, "p2g_apply")
    return grid


def g2p_apply(base: torch.Tensor, w_ax: torch.Tensor,
              grid: torch.Tensor) -> torch.Tensor:
    """Gather grid channels back to particles.

    grid (res, res, res, C) float32 -> (N, C) float32, per-particle sums
    weighted by the stencil. CUDA tensors go to the kernel (or raise); CPU
    tensors to the plain version."""
    _check("g2p_apply", base, w_ax, grid, "grid")
    res = grid.shape[0]
    if grid.dim() != 4 or grid.shape[:3] != (res, res, res):
        raise ValueError(f"g2p_apply: grid must be (res, res, res, C), got "
                         f"{tuple(grid.shape)}")
    if grid.device.type == "cpu":
        return g2p_apply_plain(base, w_ax, grid)
    from .. import _kernels
    N, C = base.shape[0], grid.shape[-1]
    out = torch.empty((N, C), dtype=torch.float32, device=grid.device)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().mpm_g2p_f32(
            base.data_ptr(), w_ax.data_ptr(), grid.data_ptr(),
            out.data_ptr(), N, C, res, stream)
    g2p_apply.launches += 1
    _kernels.check(err, "g2p_apply")
    return out


p2g_apply.launches = 0
g2p_apply.launches = 0
