"""Sparse quantized SDF textures (port of
``newton_tpu/geometry/sdf_texture.py``).

High-resolution signed distance that spends memory only near the surface:
the fine grid (R = 8 B cells per edge) is split into 8^3-cell blocks;
blocks within a narrow band of the surface keep their 9^3 corner samples
quantized to uint8 (d = offset + scale u8), every other point reads a
coarse (B+1)^3 float grid. The bake is host numpy over one dense corner
grid (``geometry/sdf.bake_dense``: the C++ bake, or its numpy twin);
sampling runs on the model's device, a pooled texture's block slot and
the 8 corners gathered by flat index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = ["TextureSDF", "bake_texture_sdf", "sample_texture_sdf",
           "texture_to_dense", "BLOCK"]

BLOCK = 8          # fine cells per block edge
CORNERS = BLOCK + 1


@dataclass
class TextureSDF:
    """Sparse quantized SDF texture (host container, numpy).

    Attributes:
        block_index: (B, B, B) int32; slot into ``blocks`` or -1 (coarse).
        blocks: (n_blocks, 9, 9, 9) uint8 quantized corner samples.
        block_scale: (n_blocks,) f32; d = offset + scale * u8.
        block_offset: (n_blocks,) f32.
        coarse: (B+1, B+1, B+1) f32 far-field SDF at block corners.
        lower, upper: world AABB of the fine grid.
    """

    block_index: np.ndarray
    blocks: np.ndarray
    block_scale: np.ndarray
    block_offset: np.ndarray
    coarse: np.ndarray
    lower: np.ndarray
    upper: np.ndarray

    @property
    def fine_resolution(self) -> int:
        return self.block_index.shape[0] * BLOCK

    @property
    def nbytes(self) -> int:
        return (self.blocks.nbytes + self.block_index.nbytes
                + self.coarse.nbytes + self.block_scale.nbytes
                + self.block_offset.nbytes)


def bake_texture_sdf(mesh, resolution: int = 96, margin: float = 0.1,
                     band_cells: float = 3.0,
                     native: bool = True) -> TextureSDF:
    """Bake a sparse quantized SDF texture for a triangle mesh.

    ``resolution`` is rounded up to a multiple of 8 (the block size).
    Blocks whose center is within ``band_cells`` fine cells (+ block
    radius) of the surface get fine quantized storage; the rest fall back
    to the coarse grid. Host numpy, once at finalize, over the C++ bake
    (``native=False``: its numpy twin).
    """
    v = np.asarray(mesh.vertices, dtype=np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    pad = margin * max(float((hi - lo).max()), 1e-6)
    lo, hi = lo - pad, hi + pad

    B = max(2, int(np.ceil(resolution / BLOCK)))
    R = B * BLOCK                     # fine cells per edge; R+1 corners

    # one dense fine corner grid (R+1)^3, then the sparse texture from it:
    # the exact coarse downsample, each block's activity from its corner
    # distances, the quantized blocks
    from .sdf import bake_dense
    dense = bake_dense(mesh.vertices, mesh.indices, R + 1, lo, hi,
                       native=native)

    coarse = dense[::BLOCK, ::BLOCK, ::BLOCK].copy()        # (B+1)^3 exact

    win = np.lib.stride_tricks.sliding_window_view(
        dense, (CORNERS, CORNERS, CORNERS))[::BLOCK, ::BLOCK, ::BLOCK]
    # win: (B, B, B, 9, 9, 9) overlapping corner windows per block
    cell = (hi - lo) / R
    band = band_cells * float(cell.max())
    min_abs = np.abs(win).min(axis=(3, 4, 5))
    active = (min_abs <= band).reshape(-1)
    slots = np.full(B * B * B, -1, dtype=np.int32)
    slots[active] = np.arange(int(active.sum()), dtype=np.int32)
    block_index = slots.reshape(B, B, B)

    n_blocks = int(active.sum())
    if n_blocks:
        d = win.reshape(B * B * B, -1)[active].astype(np.float64)
        dmin = d.min(axis=1)
        dmax = d.max(axis=1)
        rng = np.maximum(dmax - dmin, 1e-12)
        q = np.rint((d - dmin[:, None]) / rng[:, None] * 255.0)
        blocks = q.astype(np.uint8).reshape(n_blocks, CORNERS, CORNERS,
                                            CORNERS)
        scale = (rng / 255.0).astype(np.float32)
        offset = dmin.astype(np.float32)
    else:
        blocks = np.zeros((1, CORNERS, CORNERS, CORNERS), dtype=np.uint8)
        scale = np.zeros(1, dtype=np.float32)
        offset = np.zeros(1, dtype=np.float32)

    return TextureSDF(block_index=block_index, blocks=blocks,
                      block_scale=scale, block_offset=offset,
                      coarse=np.ascontiguousarray(coarse, dtype=np.float32),
                      lower=lo, upper=hi)


def sample_texture_sdf(block_index, blocks, block_scale, block_offset,
                       coarse, lower, upper, points, tid=None):
    """Trilinear distance of a sparse texture at ``points`` (..., 3): one
    texture (``block_index`` (B, B, B), ``coarse`` (B+1)^3), or with
    ``tid`` (...,) a pool (leading texture axis on both) and each point's
    texture; ``blocks``/``block_scale``/``block_offset`` are the shared
    block pool (global slots). ``lower``/``upper`` broadcast against the
    points. A point in a fine block reads its quantized corners, any
    other the coarse grid."""
    B = block_index.shape[-1]
    R = B * BLOCK
    u = (points - lower) / (upper - lower) * R
    u = torch.clamp(u, min=0.0, max=R - 1e-3)
    bc = torch.clamp(torch.floor(u / BLOCK).to(torch.int64), max=B - 1)
    t = 0 if tid is None else tid.to(torch.int64)
    bi = block_index.reshape(-1)
    slot = bi[((t * B + bc[..., 0]) * B + bc[..., 1]) * B + bc[..., 2]]
    local = u - bc.to(u.dtype) * BLOCK
    i0 = torch.clamp(torch.floor(local).to(torch.int64), 0, BLOCK - 1)
    frac = local - i0.to(u.dtype)
    i1 = i0 + 1
    sl = torch.clamp(slot, min=0).to(torch.int64)
    fb = blocks.reshape(-1)
    C3 = CORNERS * CORNERS * CORNERS

    def gf(ix, iy, iz):
        return fb[sl * C3 + (ix * CORNERS + iy) * CORNERS + iz].to(u.dtype)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    c00 = gf(x0, y0, z0) * (1 - fx) + gf(x1, y0, z0) * fx
    c10 = gf(x0, y1, z0) * (1 - fx) + gf(x1, y1, z0) * fx
    c01 = gf(x0, y0, z1) * (1 - fx) + gf(x1, y0, z1) * fx
    c11 = gf(x0, y1, z1) * (1 - fx) + gf(x1, y1, z1) * fx
    fine_q = ((c00 * (1 - fy) + c10 * fy) * (1 - fz)
              + (c01 * (1 - fy) + c11 * fy) * fz)
    fine = block_offset[sl] + block_scale[sl] * fine_q

    uc = u / BLOCK
    j0 = torch.clamp(torch.floor(uc).to(torch.int64), 0, B - 1)
    fracc = uc - j0.to(u.dtype)
    j1 = j0 + 1
    Bc = B + 1
    cf = coarse.reshape(-1)

    def gc(ix, iy, iz):
        return cf[((t * Bc + ix) * Bc + iy) * Bc + iz]
    X0, Y0, Z0 = j0[..., 0], j0[..., 1], j0[..., 2]
    X1, Y1, Z1 = j1[..., 0], j1[..., 1], j1[..., 2]
    Fx, Fy, Fz = fracc[..., 0], fracc[..., 1], fracc[..., 2]
    d00 = gc(X0, Y0, Z0) * (1 - Fx) + gc(X1, Y0, Z0) * Fx
    d10 = gc(X0, Y1, Z0) * (1 - Fx) + gc(X1, Y1, Z0) * Fx
    d01 = gc(X0, Y0, Z1) * (1 - Fx) + gc(X1, Y0, Z1) * Fx
    d11 = gc(X0, Y1, Z1) * (1 - Fx) + gc(X1, Y1, Z1) * Fx
    coarse_d = ((d00 * (1 - Fy) + d10 * Fy) * (1 - Fz)
                + (d01 * (1 - Fy) + d11 * Fy) * Fz)
    return torch.where(slot >= 0, fine, coarse_d)


def texture_to_dense(tex: TextureSDF) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Reconstruct a dense (R+1)^3 corner grid (testing / viewer use)."""
    B = tex.block_index.shape[0]
    R = B * BLOCK
    out = np.zeros((R + 1, R + 1, R + 1), dtype=np.float32)
    # coarse everywhere (trilinear upsample of block-corner grid)
    t = np.linspace(0, B, R + 1)
    j0 = np.clip(t.astype(int), 0, B - 1)
    fr = t - j0
    j1 = j0 + 1

    def lerp_axis(a, axis, i0, i1, f):
        sh = [1, 1, 1]
        sh[axis] = -1
        f = f.reshape(sh)
        return (np.take(a, i0, axis=axis) * (1 - f)
                + np.take(a, i1, axis=axis) * f)

    c = lerp_axis(tex.coarse, 0, j0, j1, fr)
    c = lerp_axis(c, 1, j0, j1, fr)
    out = lerp_axis(c, 2, j0, j1, fr).astype(np.float32)
    # overwrite fine blocks
    for bx in range(B):
        for by in range(B):
            for bz in range(B):
                s = tex.block_index[bx, by, bz]
                if s < 0:
                    continue
                d = (tex.block_offset[s]
                     + tex.block_scale[s] * tex.blocks[s].astype(np.float32))
                out[bx * BLOCK:bx * BLOCK + CORNERS,
                    by * BLOCK:by * BLOCK + CORNERS,
                    bz * BLOCK:bz * BLOCK + CORNERS] = d
    return out, tex.lower, tex.upper
