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
           "plane_sphere", "plane_capsule", "sphere_sphere", "sphere_capsule",
           "capsule_capsule"]

_EPS = 1e-9     # the JAX package's guard on every division and normal

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


def _closest_point_segment_segment(p1, q1, p2, q2):
    """Closest points between segments [p1, q1] and [p2, q2], branch-free
    (Ericson, Real-Time Collision Detection 5.1.9). Both branches of each
    ``where`` are evaluated, so every denominator is clamped: parallel
    segments (denom 0) and zero-length segments (a or e 0) stay finite."""
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a = (d1 * d1).sum(-1)
    e = (d2 * d2).sum(-1)
    f = (d2 * r).sum(-1)
    c = (d1 * r).sum(-1)
    b = (d1 * d2).sum(-1)
    denom = a * e - b * b
    s = torch.where(denom > _EPS, torch.clamp(
        (b * f - c * e) / torch.clamp(denom, min=_EPS), 0.0, 1.0), 0.0)
    t = torch.where(e > _EPS, (b * s + f) / torch.clamp(e, min=_EPS), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    s = torch.where(a > _EPS, torch.clamp(
        (b * t - c) / torch.clamp(a, min=_EPS), 0.0, 1.0), 0.0)
    return p1 + d1 * s[..., None], p2 + d2 * t[..., None]


def _unit_or_z(d):
    """d / |d|, or +Z where |d| <= eps (coincident points); and |d|."""
    dist = torch.linalg.vector_norm(d, dim=-1)
    ez = torch.zeros_like(d)
    ez[..., 2] = 1.0
    n = torch.where(dist[..., None] > _EPS,
                    d / torch.clamp(dist, min=_EPS)[..., None], ez)
    return n, dist


def sphere_sphere(X0, X1, s0, s1):
    n, dist = _unit_or_z(X1[..., 0:3] - X0[..., 0:3])
    depth = s0[..., 0] + s1[..., 0] - dist
    pos = X0[..., 0:3] + n * (s0[..., 0] - 0.5 * depth)[..., None]
    return pos[..., None, :], n[..., None, :], depth[..., None]


def sphere_capsule(X0, X1, s0, s1):
    a, b = _segment_endpoints(X1, s1[..., 1])
    c = X0[..., 0:3]
    ab = b - a
    t = torch.clamp(((c - a) * ab).sum(-1)
                    / torch.clamp((ab * ab).sum(-1), min=_EPS), 0.0, 1.0)
    n, dist = _unit_or_z(a + ab * t[..., None] - c)
    depth = s0[..., 0] + s1[..., 0] - dist
    pos = c + n * (s0[..., 0] - 0.5 * depth)[..., None]
    return pos[..., None, :], n[..., None, :], depth[..., None]


def capsule_capsule(X0, X1, s0, s1):
    """Two slots: the closest points, and the closest points with both
    segments' endpoints swapped (near-parallel capsules resting on each
    other touch along a line)."""
    a0, b0 = _segment_endpoints(X0, s0[..., 1])
    a1, b1 = _segment_endpoints(X1, s1[..., 1])
    c0, c1 = _closest_point_segment_segment(a0, b0, a1, b1)
    c0b, c1b = _closest_point_segment_segment(b0, a0, b1, a1)
    p0 = torch.stack([c0, c0b], dim=-2)                     # (..., 2, 3)
    n, dist = _unit_or_z(torch.stack([c1, c1b], dim=-2) - p0)
    depth = s0[..., 0:1] + s1[..., 0:1] - dist
    pos = p0 + n * (s0[..., 0:1] - 0.5 * depth)[..., None]
    return pos, n, depth


# dispatch table keyed by (type0, type1) in canonical order
PRIMITIVE_FNS = {
    (_P, _S): plane_sphere,
    (_P, _C): plane_capsule,
    (_S, _S): sphere_sphere,
    (_S, _C): sphere_capsule,
    (_C, _C): capsule_capsule,
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
