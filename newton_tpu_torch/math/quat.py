"""Quaternion algebra on ``(..., 4)`` tensors, xyzw storage (port of
``newton_tpu/math/quat.py``). Shape-polymorphic over leading batch dims;
quaternions rotate column vectors by ``v' = q v q*``."""

from __future__ import annotations

import torch

__all__ = ["cross", "quat_mul", "quat_conjugate", "quat_normalize",
           "quat_rotate", "quat_rotate_inv", "quat_from_axis_angle",
           "quat_to_axis_angle", "quat_to_matrix", "quat_integrate"]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (broadcasting leading dims)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (apply b's rotation first, then a's)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion; a (near-)zero input maps to the identity."""
    n2 = (q * q).sum(-1, keepdim=True)
    ident = torch.zeros_like(q)
    ident[..., 3] = 1.0
    safe = torch.where(n2 > 1e-12, q, ident)
    return safe / torch.linalg.vector_norm(safe, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by the inverse of quaternion(s) q."""
    u = -q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * cross(u, v)
    return v + w * t + cross(u, t)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor
                         ) -> torch.Tensor:
    half = 0.5 * angle
    return torch.cat([axis * torch.sin(half)[..., None],
                      torch.cos(half)[..., None]], dim=-1)


def quat_to_axis_angle(q: torch.Tensor):
    """(axis, angle) with angle in [0, pi]: q and -q give the same pair;
    the axis is unit X at angle 0."""
    q = torch.where(q[..., 3:4] < 0.0, -q, q)
    v = q[..., :3]
    ok = (v * v).sum(-1) > 1e-12
    unit_x = torch.zeros_like(v)
    unit_x[..., 0] = 1.0
    safe_v = torch.where(ok[..., None], v, unit_x)
    sin_half = torch.linalg.vector_norm(safe_v, dim=-1)
    angle = torch.where(ok, 2.0 * torch.atan2(sin_half, q[..., 3]), 0.0)
    return safe_v / sin_half[..., None], angle


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> rotation matrix, shape (..., 3, 3)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(*q.shape[:-1], 3, 3)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate orientation by world-frame angular velocity, renormalized."""
    dq = quat_mul(torch.cat([omega, torch.zeros_like(omega[..., :1])], -1), q)
    return quat_normalize(q + 0.5 * dt * dq)
