"""Rigid transforms on ``(..., 7)`` tensors ``[p, q_xyzw]`` (port of
``newton_tpu/math/transform.py``)."""

from __future__ import annotations

import torch

from .quat import quat_conjugate, quat_mul, quat_rotate, quat_rotate_inv

__all__ = ["transform_multiply", "transform_inverse", "transform_point",
           "transform_point_inv"]


def transform_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose transforms: (a*b) maps a point first by b, then by a."""
    p = a[..., 0:3] + quat_rotate(a[..., 3:7], b[..., 0:3])
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    return torch.cat([p, q], dim=-1)


def transform_inverse(t: torch.Tensor) -> torch.Tensor:
    qi = quat_conjugate(t[..., 3:7])
    return torch.cat([-quat_rotate(qi, t[..., 0:3]), qi], dim=-1)


def transform_point(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return t[..., 0:3] + quat_rotate(t[..., 3:7], x)


def transform_point_inv(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Point x in the frame of transform t."""
    return quat_rotate_inv(t[..., 3:7], x - t[..., 0:3])
