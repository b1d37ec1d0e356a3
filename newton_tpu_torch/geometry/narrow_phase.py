"""Batched primitive narrow phase (port of ``newton_tpu/geometry/narrow_phase.py``).

Every (GeoType, GeoType) class is one branch-free function over all pairs
of that class, emitting a fixed number of manifold slots per pair. The
functions take world transforms ``X0/X1 (..., 7)`` of the two shape frames
and scales ``s0/s1 (..., 3)`` and return ``(position (..., K, 3),
normal (..., K, 3), depth (..., K))``; the normal points from shape0 to
shape1 and depth > 0 means overlap (thickness is the caller's).

Shape frames: PLANE has normal +Z; SPHERE radius = scale[0]; CAPSULE radius
= scale[0], half-height = scale[1], axis +Z.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..math import quat_rotate, transform_point
from .types import GeoType

__all__ = ["pair_slot_count", "PRIMITIVE_FNS", "contact_fn_for",
           "plane_sphere", "plane_capsule"]

_P, _S, _C = int(GeoType.PLANE), int(GeoType.SPHERE), int(GeoType.CAPSULE)

# slots per pair class among the shape types the builder takes (the JAX
# package's values: they fix the contact slot layout)
_SLOTS: Dict[Tuple[int, int], int] = {
    (_P, _S): 1, (_P, _C): 2, (_S, _S): 1, (_S, _C): 1, (_C, _C): 2,
}


def pair_slot_count(t0: int, t1: int) -> int:
    return _SLOTS[(min(int(t0), int(t1)), max(int(t0), int(t1)))]


def _plane_sdf(X_plane, p_world):
    """Signed distance of world points to a +Z plane shape, and the world
    plane normal."""
    ez = torch.zeros_like(X_plane[..., 0:3])
    ez[..., 2] = 1.0
    n = quat_rotate(X_plane[..., 3:7], ez)
    d = ((p_world - X_plane[..., 0:3]) * n).sum(-1)
    return d, n


def _segment_endpoints(X, half_h):
    """Capsule axis endpoints in world space, (..., 3) each."""
    z = torch.zeros_like(half_h)
    a = transform_point(X, torch.stack([z, z, half_h], dim=-1))
    b = transform_point(X, torch.stack([z, z, -half_h], dim=-1))
    return a, b


def plane_sphere(X0, X1, s0, s1):
    c = X1[..., 0:3]
    d, n = _plane_sdf(X0, c)
    depth = s1[..., 0] - d
    pos = c - n * (d[..., None] - 0.5 * depth[..., None])
    return pos[..., None, :], n[..., None, :], depth[..., None]


def plane_capsule(X0, X1, s0, s1):
    a, b = _segment_endpoints(X1, s1[..., 1])
    pts = torch.stack([a, b], dim=-2)                       # (..., 2, 3)
    d, n = _plane_sdf(X0[..., None, :], pts)
    depth = s1[..., 0:1] - d
    pos = pts - n * (d[..., None] - 0.5 * depth[..., None])
    return pos, n.expand_as(pos), depth


# dispatch table keyed by (type0, type1) in canonical order
PRIMITIVE_FNS = {
    (_P, _S): plane_sphere,
    (_P, _C): plane_capsule,
}


def contact_fn_for(t0: int, t1: int):
    """(fn, swapped, slots) for a type pair; raises for pair classes the
    port does not have yet."""
    key = (int(t0), int(t1))
    if key in PRIMITIVE_FNS:
        return PRIMITIVE_FNS[key], False, pair_slot_count(t0, t1)
    if key[::-1] in PRIMITIVE_FNS:
        return PRIMITIVE_FNS[key[::-1]], True, pair_slot_count(t0, t1)
    raise NotImplementedError(
        f"contact pair {GeoType(t0).name}-{GeoType(t1).name} is not ported "
        "yet")
