"""Spatial (6D) vectors, linear-first ``[v, w]`` (port of
``newton_tpu/math/spatial.py``)."""

from __future__ import annotations

import torch

from .quat import cross

__all__ = ["spatial_cross", "spatial_cross_dual", "velocity_at_point",
           "orthonormal_basis", "safe_norm", "safe_normalize"]


def spatial_cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Motion-cross-motion: [w_a x v_b + v_a x w_b, w_a x w_b]."""
    va, wa = a[..., 0:3], a[..., 3:6]
    vb, wb = b[..., 0:3], b[..., 3:6]
    return torch.cat([cross(wa, vb) + cross(va, wb), cross(wa, wb)], dim=-1)


def spatial_cross_dual(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Motion-cross-force: [w_a x f_b, w_a x t_b + v_a x f_b]."""
    va, wa = a[..., 0:3], a[..., 3:6]
    fb, tb = b[..., 0:3], b[..., 3:6]
    return torch.cat([cross(wa, fb), cross(wa, tb) + cross(va, fb)], dim=-1)


def velocity_at_point(twist: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return twist[..., 0:3] + cross(twist[..., 3:6], r)


def orthonormal_basis(n: torch.Tensor):
    """Two unit tangents orthogonal to unit normal n (branch-free, Duff et
    al.), with [n, t1, t2] right-handed."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + nz)
    b = nx * ny * a
    t1 = torch.stack([1.0 + s * nx * nx * a, s * b, -s * nx], dim=-1)
    t2 = torch.stack([b, s + ny * ny * a, -ny], dim=-1)
    return t1, t2


def safe_norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Norm over the last axis; 0 where the squared norm is <= eps."""
    n2 = (v * v).sum(-1)
    ok = n2 > eps
    return torch.where(ok, torch.sqrt(torch.where(ok, n2, 1.0)), 0.0)


def safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit vector over the last axis; 0 where the squared norm is <= eps."""
    n2 = (v * v).sum(-1, keepdim=True)
    ok = n2 > eps
    safe_v = torch.where(ok, v, 1.0)
    unit = safe_v / torch.sqrt((safe_v * safe_v).sum(-1, keepdim=True))
    return torch.where(ok, unit, 0.0)
