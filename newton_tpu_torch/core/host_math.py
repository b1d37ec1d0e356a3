"""Host-side (numpy, float64) quaternion/transform helpers for model building
(port of ``newton_tpu/core/host_math.py``).

Quaternions are **xyzw**; transforms are ``[px, py, pz, qx, qy, qz, qw]``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "np_quat_identity", "np_quat_mul", "np_quat_rotate", "np_quat_rotate_inv",
    "np_quat_from_axis_angle", "np_transform_identity", "np_transform",
    "np_transform_multiply", "np_transform_inverse", "np_transform_point",
    "np_transform_vector", "np_quat_between_axes",
]


def np_quat_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 1.0])


def np_quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def np_quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    u = np.asarray(q[:3], dtype=np.float64)
    w = float(q[3])
    v = np.asarray(v, dtype=np.float64)
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def np_quat_rotate_inv(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    return np_quat_rotate(np.array([-q[0], -q[1], -q[2], q[3]]), v)


def np_quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    h = 0.5 * float(angle)
    s = np.sin(h)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, np.cos(h)])


def np_quat_between_axes(a, b) -> np.ndarray:
    """Quaternion rotating unit vector a onto unit vector b."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.cross(a, b)
    d = float(a @ b)
    if d < -1.0 + 1e-12:
        # 180 degrees: pick any orthogonal axis
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-8:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        axis /= np.linalg.norm(axis)
        return np.array([axis[0], axis[1], axis[2], 0.0])
    q = np.array([c[0], c[1], c[2], 1.0 + d])
    return q / np.linalg.norm(q)


def np_transform_identity() -> np.ndarray:
    return np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])


def np_transform(p=None, q=None) -> np.ndarray:
    t = np_transform_identity()
    if p is not None:
        t[:3] = np.asarray(p, dtype=np.float64)
    if q is not None:
        t[3:] = np.asarray(q, dtype=np.float64)
    return t


def np_transform_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    p = a[:3] + np_quat_rotate(a[3:], b[:3])
    q = np_quat_mul(a[3:], b[3:])
    return np.concatenate([p, q])


def np_transform_inverse(t: np.ndarray) -> np.ndarray:
    qc = np.array([-t[3], -t[4], -t[5], t[6]])
    p = -np_quat_rotate(qc, t[:3])
    return np.concatenate([p, qc])


def np_transform_point(t: np.ndarray, p) -> np.ndarray:
    return t[:3] + np_quat_rotate(t[3:], np.asarray(p, dtype=np.float64))


def np_transform_vector(t: np.ndarray, v) -> np.ndarray:
    return np_quat_rotate(t[3:], np.asarray(v, dtype=np.float64))
