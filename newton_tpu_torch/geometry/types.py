"""Shape geometry types and flags (port of ``newton_tpu/geometry/types.py``
and ``geometry/flags.py``; same values)."""

from __future__ import annotations

from enum import IntEnum, IntFlag

__all__ = ["GeoType", "ShapeFlags"]


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
