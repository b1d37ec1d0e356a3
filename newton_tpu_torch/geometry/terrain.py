"""Procedural terrain (port of ``newton_tpu/geometry/terrain.py``; host
numpy, the same arrays): fractal value-noise heightfields and stairs,
returned as a :class:`Heightfield`, and a heightfield's triangulation as a
collision :class:`Mesh`."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .types import Heightfield, Mesh

__all__ = ["generate_fractal_terrain", "generate_stairs",
           "heightfield_to_mesh"]


def _value_noise(shape, cell, rng):
    """Bilinear value noise on a coarse lattice."""
    gx = shape[0] // cell + 2
    gy = shape[1] // cell + 2
    lattice = rng.uniform(-1.0, 1.0, (gx, gy))
    xs = np.arange(shape[0]) / cell
    ys = np.arange(shape[1]) / cell
    ix = xs.astype(int)
    iy = ys.astype(int)
    fx = (xs - ix)[:, None]
    fy = (ys - iy)[None, :]
    # smoothstep
    fx = fx * fx * (3 - 2 * fx)
    fy = fy * fy * (3 - 2 * fy)
    c00 = lattice[np.ix_(ix, iy)]
    c10 = lattice[np.ix_(ix + 1, iy)]
    c01 = lattice[np.ix_(ix, iy + 1)]
    c11 = lattice[np.ix_(ix + 1, iy + 1)]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def generate_fractal_terrain(nx: int = 128, ny: int = 128,
                             size_x: float = 10.0, size_y: float = 10.0,
                             amplitude: float = 0.5, octaves: int = 4,
                             roughness: float = 0.5, base: float = 0.0,
                             seed: int = 0) -> Heightfield:
    """Multi-octave value-noise heightfield
    (reference: terrain_generator.py)."""
    rng = np.random.default_rng(seed)
    h = np.zeros((nx, ny))
    amp = 1.0
    cell = max(nx // 4, 2)
    for _ in range(octaves):
        h += amp * _value_noise((nx, ny), cell, rng)
        amp *= roughness
        cell = max(cell // 2, 1)
    h *= amplitude / max(np.abs(h).max(), 1e-9)
    return Heightfield(h.astype(np.float32), size_x, size_y, base=base)


def generate_stairs(n_steps: int = 8, step_height: float = 0.15,
                    step_depth: float = 0.3, width: float = 2.0,
                    nx: int = 64, ny: int = 64) -> Heightfield:
    """Staircase heightfield (reference terrain obstacle family)."""
    size_x = n_steps * step_depth
    xs = np.linspace(0, size_x, nx)
    h = (np.minimum(np.floor(xs / step_depth), n_steps - 1)
         * step_height)[:, None]
    h = np.broadcast_to(h, (nx, ny)).copy()
    return Heightfield(h.astype(np.float32), size_x, width)


def heightfield_to_mesh(hf: Heightfield) -> Mesh:
    """Triangulate a heightfield into a collision Mesh (centered at origin,
    +Z up). Lets terrain ride the mesh SDF contact pipeline."""
    nx, ny = hf.nx, hf.ny
    xs = np.linspace(-hf.size_x / 2, hf.size_x / 2, nx)
    ys = np.linspace(-hf.size_y / 2, hf.size_y / 2, ny)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([gx, gy, hf.heights + hf.base], axis=-1).reshape(-1, 3)
    idx = np.arange(nx * ny).reshape(nx, ny)
    f = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            v0, v1 = idx[i, j], idx[i + 1, j]
            v2, v3 = idx[i + 1, j + 1], idx[i, j + 1]
            f.append([v0, v1, v2])
            f.append([v0, v2, v3])
    return Mesh(verts, np.asarray(f, dtype=np.int32).reshape(-1),
                compute_inertia=False, is_solid=False)
