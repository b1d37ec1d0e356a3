from .types import MAXVAL, Axis, AxisType, axis_to_vec3

__all__ = ["MAXVAL", "Axis", "AxisType", "axis_to_vec3"]
