"""Simulation enums (port of ``newton_tpu/sim/enums.py``; same values)."""

from __future__ import annotations

from enum import IntEnum, IntFlag

__all__ = ["BodyFlags", "EqType", "JointType", "ParticleFlags"]


class BodyFlags(IntFlag):
    NONE = 0
    KINEMATIC = 1 << 0


class ParticleFlags(IntFlag):
    """Per-particle flags (``newton_tpu/geometry/flags.py``; same values)."""

    ACTIVE = 1 << 0


class JointType(IntEnum):
    PRISMATIC = 0
    REVOLUTE = 1
    BALL = 2
    FIXED = 3
    FREE = 4
    DISTANCE = 5
    D6 = 6
    CABLE = 7

    def dof_count(self, num_axes: int) -> tuple:
        """(dof_count, coord_count) for this joint type."""
        dof, coord = num_axes, num_axes
        if self == JointType.BALL:
            dof, coord = 3, 4
        elif self in (JointType.FREE, JointType.DISTANCE):
            dof, coord = 6, 7
        elif self == JointType.FIXED:
            dof, coord = 0, 0
        elif self == JointType.CABLE:
            dof, coord = num_axes, 0
        return dof, coord


class EqType(IntEnum):
    """Equality constraint types (same values as the JAX package's)."""

    CONNECT = 0
    WELD = 1
    JOINT = 2
