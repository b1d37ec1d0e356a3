"""Closed-form 3x3 determinant, inverse and solve on ``(..., 3, 3)``
tensors. Unlike ``torch.linalg.det/inv/solve`` on the card, they launch a
few elementwise kernels, never check for singular input and so never wait
for the device: a singular matrix gives inf or NaN, as the JAX package's
LU forms may."""

from __future__ import annotations

import torch

__all__ = ["det3", "inv3", "solve3"]


def _cofactors(M: torch.Tensor):
    a, b, c = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    bc = torch.linalg.cross(b, c)
    return a, bc, torch.linalg.cross(c, a), torch.linalg.cross(a, b)


def det3(M: torch.Tensor) -> torch.Tensor:
    a, bc, _, _ = _cofactors(M)
    return (a * bc).sum(-1)


def inv3(M: torch.Tensor) -> torch.Tensor:
    """M^-1: its columns are the cross products of M's rows over det M."""
    a, bc, ca, ab = _cofactors(M)
    det = (a * bc).sum(-1)
    return torch.stack([bc, ca, ab], -1) / det[..., None, None]


def solve3(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """x with M x = v, v (..., 3)."""
    a, bc, ca, ab = _cofactors(M)
    det = (a * bc).sum(-1)
    return (bc * v[..., 0:1] + ca * v[..., 1:2] + ab * v[..., 2:3]) \
        / det[..., None]
