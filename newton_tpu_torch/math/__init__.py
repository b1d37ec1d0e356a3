from .mat33 import det3, inv3, solve3
from .quat import (
    cross,
    quat_conjugate,
    quat_from_axis_angle,
    quat_integrate,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inv,
    quat_to_axis_angle,
    quat_to_matrix,
)
from .spatial import (
    orthonormal_basis,
    safe_norm,
    safe_normalize,
    spatial_cross,
    spatial_cross_dual,
    velocity_at_point,
)
from .transform import (
    transform_inverse,
    transform_multiply,
    transform_point,
    transform_point_inv,
)

__all__ = [
    "det3", "inv3", "solve3", "cross", "quat_conjugate", "quat_from_axis_angle", "quat_integrate",
    "quat_mul", "quat_normalize", "quat_rotate", "quat_rotate_inv",
    "quat_to_axis_angle", "quat_to_matrix",
    "orthonormal_basis", "safe_norm", "safe_normalize", "spatial_cross",
    "spatial_cross_dual", "velocity_at_point", "transform_inverse",
    "transform_multiply", "transform_point", "transform_point_inv",
]
