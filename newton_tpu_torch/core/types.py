"""Core scalar types, axis helpers and sentinels (port of
``newton_tpu/core/types.py``).

Tensor conventions match the JAX package:

- vec3:       ``(..., 3)`` float
- quat:       ``(..., 4)`` float, **xyzw** storage
- transform:  ``(..., 7)`` float, ``[px, py, pz, qx, qy, qz, qw]``
- spatial:    ``(..., 6)`` float, linear-first ``[v, w]`` / ``[f, tau]``
"""

from __future__ import annotations

import math
from enum import IntEnum
from typing import Sequence, Union

import numpy as np

__all__ = ["MAXVAL", "Axis", "AxisType", "axis_to_vec3"]

# "Effectively infinite" limit sentinel; finite so (limit - q) stays finite
# in float32.
MAXVAL = 1.0e10


class Axis(IntEnum):
    X = 0
    Y = 1
    Z = 2

    @classmethod
    def from_any(cls, value: "AxisType") -> "Axis":
        if isinstance(value, Axis):
            return value
        if isinstance(value, str):
            try:
                return cls[value.upper()]
            except KeyError as e:
                raise ValueError(f"Invalid axis name: {value!r}") from e
        if isinstance(value, (int, np.integer)):
            return cls(int(value))
        raise TypeError(f"Cannot convert {value!r} to Axis")

    def to_vec3(self) -> np.ndarray:
        v = np.zeros(3, dtype=np.float64)
        v[int(self)] = 1.0
        return v


AxisType = Union[Axis, str, int, Sequence[float], np.ndarray]


def axis_to_vec3(axis: AxisType) -> np.ndarray:
    """Convert an axis designator (enum/str/int/3-vector) to a unit vec3."""
    if isinstance(axis, (Axis, str)) or isinstance(axis, (int, np.integer)):
        return Axis.from_any(axis).to_vec3()
    v = np.asarray(axis, dtype=np.float64)
    if v.shape != (3,):
        raise ValueError(f"Axis vector must have shape (3,), got {v.shape}")
    n = math.sqrt(float(v @ v))
    if n == 0.0:
        raise ValueError("Axis vector must be non-zero")
    return v / n
