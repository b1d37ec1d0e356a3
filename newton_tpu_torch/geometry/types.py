"""Shape geometry types and flags, and the host-side geometry sources
(port of ``newton_tpu/geometry/types.py`` and ``geometry/flags.py``; same
values). ``Mesh``, ``SDF`` and ``Heightfield`` hold numpy data; at
``ModelBuilder.finalize`` they become the model's pooled tensors (sample
points, hull vertex clouds, SDF grids and textures)."""

from __future__ import annotations

from enum import IntEnum, IntFlag
from typing import Optional

import numpy as np

__all__ = ["GeoType", "ShapeFlags", "Mesh", "SDF", "Heightfield"]


class GeoType(IntEnum):
    PLANE = 0
    SPHERE = 1
    BOX = 2
    CAPSULE = 3
    CYLINDER = 4
    CONE = 5
    MESH = 6
    SDF = 7
    CONVEX = 8
    HFIELD = 9
    ELLIPSOID = 10
    GAUSSIAN = 11
    NONE = 12


class ShapeFlags(IntFlag):
    VISIBLE = 1 << 0
    COLLIDE_SHAPES = 1 << 1
    COLLIDE_PARTICLES = 1 << 2
    SITE = 1 << 3


class Mesh:
    """Triangle mesh source: float64 vertices (V, 3), int32 flat indices
    (3T,). Its mass properties at unit density come from the divergence
    theorem (``geometry/inertia.compute_mesh_inertia``); a mesh whose
    computation fails carries none (``has_inertia`` False)."""

    def __init__(self, vertices: np.ndarray, indices: np.ndarray,
                 compute_inertia: bool = True, is_solid: bool = True,
                 maxhullvert: int = 64):
        self.vertices = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        self.indices = np.asarray(indices, dtype=np.int32).reshape(-1)
        self.is_solid = bool(is_solid)
        self.maxhullvert = int(maxhullvert)
        self.mass: float = 1.0
        self.com: np.ndarray = np.zeros(3)
        self.inertia: np.ndarray = np.eye(3)
        self.has_inertia = False
        if compute_inertia and len(self.indices) >= 3:
            from .inertia import compute_mesh_inertia
            try:
                m, com, I = compute_mesh_inertia(
                    1.0, self.vertices, self.indices, is_solid=self.is_solid)
                self.mass, self.com, self.inertia = m, com, I
                self.has_inertia = True
            except Exception:
                pass

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_triangles(self) -> int:
        return len(self.indices) // 3

    def copy(self) -> "Mesh":
        m = Mesh(self.vertices.copy(), self.indices.copy(),
                 compute_inertia=False, is_solid=self.is_solid,
                 maxhullvert=self.maxhullvert)
        m.mass, m.com, m.inertia = self.mass, self.com.copy(), \
            self.inertia.copy()
        m.has_inertia = self.has_inertia
        return m

    def compute_aabb(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)


class SDF:
    """Signed distance samples on a regular grid: ``data`` (R, R, R)
    float32 over the box [lower, upper] (grid corners at both ends)."""

    def __init__(self, data: Optional[np.ndarray] = None,
                 lower: Optional[np.ndarray] = None,
                 upper: Optional[np.ndarray] = None):
        self.data = None if data is None else np.asarray(data,
                                                         dtype=np.float32)
        self.lower = np.zeros(3) if lower is None else \
            np.asarray(lower, dtype=np.float64)
        self.upper = np.ones(3) if upper is None else \
            np.asarray(upper, dtype=np.float64)

    @staticmethod
    def from_mesh(mesh: "Mesh", resolution: int = 64,
                  margin: float = 0.05) -> "SDF":
        from .sdf import bake_mesh_sdf
        return bake_mesh_sdf(mesh, resolution=resolution, margin=margin)


class Heightfield:
    """Regular-grid heightfield: ``heights`` (nx, ny) over a size_x by
    size_y rectangle centred at the shape origin, +Z up, plus ``base``."""

    def __init__(self, heights: np.ndarray, size_x: float, size_y: float,
                 base: float = 0.0):
        self.heights = np.asarray(heights, dtype=np.float32)
        if self.heights.ndim != 2:
            raise ValueError("heights must be 2D (nx, ny)")
        self.size_x = float(size_x)
        self.size_y = float(size_y)
        self.base = float(base)

    @property
    def nx(self) -> int:
        return self.heights.shape[0]

    @property
    def ny(self) -> int:
        return self.heights.shape[1]
