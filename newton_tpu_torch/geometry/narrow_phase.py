"""Batched primitive narrow phase (port of ``newton_tpu/geometry/narrow_phase.py``).

Every (GeoType, GeoType) class is one branch-free function over all pairs
of that class, emitting a fixed number of manifold slots per pair. The
functions take world transforms ``X0/X1 (..., 7)`` of the two shape frames
and scales ``s0/s1 (..., 3)`` and return ``(position (..., K, 3),
normal (..., K, 3), depth (..., K))``; the normal points from shape0 to
shape1 and depth > 0 means overlap (thickness is the caller's).

Shape frames: PLANE has normal +Z; SPHERE radius = scale[0]; BOX
half-extents = scale; CAPSULE, CYLINDER and CONE radius = scale[0],
half-height = scale[1], axis +Z (the cone's apex at +h); ELLIPSOID radii =
scale. A cylinder collides as the capsule of the same radius and
half-height (the JAX package's model, kept for parity: its flat end caps
engage one radius early, ROADMAP C.12), except against a plane, where its
rim points are exact. Every other pair of the six analytic types without
a function of its own (a cone or an ellipsoid against a box, capsule,
cylinder or cone) runs through the support-map MPR of
``geometry/mpr.py`` (``contact_fn_for``'s fallback). Pairs with a mesh,
convex hull or heightfield have no function here: the pipeline's mesh
classes take them (``sim/collide_mesh.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..math import (
    cross,
    orthonormal_basis,
    quat_rotate,
    quat_rotate_inv,
    quat_to_matrix,
    transform_point,
    transform_point_inv,
)
from .types import GeoType

__all__ = ["pair_slot_count", "PRIMITIVE_FNS", "contact_fn_for",
           "plane_sphere", "plane_capsule", "plane_box", "plane_cylinder",
           "plane_cone", "plane_ellipsoid",
           "sphere_sphere", "sphere_capsule", "sphere_box",
           "sphere_cylinder", "sphere_ellipsoid", "capsule_capsule",
           "capsule_box", "capsule_cylinder", "box_box", "box_cylinder",
           "ellipsoid_ellipsoid"]

_EPS = 1e-9     # the JAX package's guard on every division and normal

_P, _S, _B = int(GeoType.PLANE), int(GeoType.SPHERE), int(GeoType.BOX)
_C, _CY, _CO = int(GeoType.CAPSULE), int(GeoType.CYLINDER), int(GeoType.CONE)
_M, _E, _CX = int(GeoType.MESH), int(GeoType.ELLIPSOID), int(GeoType.CONVEX)
_HF = int(GeoType.HFIELD)

# slots per pair class, keyed (lower type, higher type): the JAX package's
# table, which fixes the contact slot layout; 4 for a pair not listed
_SLOTS: Dict[Tuple[int, int], int] = {
    (_P, _S): 1, (_P, _B): 8, (_P, _C): 2, (_P, _CY): 4, (_P, _CO): 4,
    (_P, _E): 1, (_P, _M): 8, (_P, _CX): 8,
    (_S, _S): 1, (_S, _B): 1, (_S, _C): 1, (_S, _CY): 1, (_S, _CO): 1,
    (_S, _E): 1, (_S, _M): 4, (_S, _CX): 1,
    (_B, _B): 16, (_B, _C): 4, (_C, _C): 2, (_B, _M): 16, (_C, _M): 8,
    (_M, _M): 16, (_CY, _CY): 2, (_B, _CY): 4, (_C, _CY): 2, (_E, _E): 1,
    (_B, _CX): 5, (_CX, _CX): 5, (_C, _CX): 8,
    (_HF, _S): 1, (_HF, _C): 2, (_HF, _B): 8, (_HF, _M): 16,
    # the support-map MPR pairs (contact_fn_for's fallback)
    (_C, _CO): 2, (_CY, _CO): 4, (_CO, _CO): 4, (_B, _CO): 4,
    (_CO, _E): 1, (_B, _E): 4, (_C, _E): 1, (_CY, _E): 2,
}


def pair_slot_count(t0: int, t1: int) -> int:
    return _SLOTS.get((min(int(t0), int(t1)), max(int(t0), int(t1))), 4)


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


def _box_corners(X, half):
    """(..., 8, 3) world-space corners of boxes with half-extents half,
    signs (-, -, -), (-, -, +), ..., (+, +, +) (x slowest, z fastest: the
    JAX package's order). The signs are made on the device (a copy from
    host memory in every substep would make the host wait for the card)."""
    bits = torch.arange(8, device=X.device)[:, None] >> torch.arange(
        2, -1, -1, device=X.device)
    signs = ((bits & 1) * 2 - 1).to(X.dtype)
    return transform_point(X[..., None, :], signs * half[..., None, :])


def _box_sdf_local(p, half):
    """Signed distance and its gradient of axis-aligned boxes at local
    points p (..., 3). Inside, the gradient is the axis of largest
    q = |p| - half, ties to the first (as ``jnp.argmax``)."""
    q = p.abs() - half
    outside = torch.clamp(q, min=0.0)
    o2 = (outside * outside).sum(-1)
    d_out = torch.where(o2 > 0.0, torch.sqrt(torch.clamp(o2, min=_EPS * _EPS)),
                        0.0)
    d_in = torch.clamp(q.max(-1).values, max=0.0)
    g_out = outside * torch.sign(p) / torch.clamp(d_out, min=_EPS)[..., None]
    one_hot = torch.nn.functional.one_hot(q.argmax(-1), 3).to(p.dtype)
    g_in = torch.sign(p) * one_hot
    inside = (d_in < 0.0) & (d_out <= _EPS)
    return d_out + d_in, torch.where(inside[..., None], g_in, g_out)


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


def plane_box(X0, X1, s0, s1):
    """Eight slots: the box corners against the plane."""
    corners = _box_corners(X1, s1)                          # (..., 8, 3)
    d, n = _plane_sdf(X0[..., None, :], corners)
    pos = corners - n * (d[..., None] * 0.5)
    return pos, n.expand_as(pos), -d


def plane_cylinder(X0, X1, s0, s1):
    """Four rim points: on each cap circle the point nearest the plane and
    the one opposite it (an axis along the normal takes the basis
    tangent)."""
    axis, radial = _axis_radial(X0, X1)
    r, h = s1[..., 0:1], s1[..., 1:2]
    top = X1[..., 0:3] + axis * h
    bot = X1[..., 0:3] - axis * h
    return _plane_points(X0, torch.stack(
        [top + radial * r, bot + radial * r, top - radial * r,
         bot - radial * r], dim=-2))


def _axis_radial(X0, X1):
    """The shape's world axis (its +Z), and the unit direction normal to it
    that points toward the plane (an axis along the plane normal takes the
    basis tangent t1)."""
    ez = torch.zeros_like(X1[..., 0:3])
    ez[..., 2] = 1.0
    axis = quat_rotate(X1[..., 3:7], ez)
    _, n = _plane_sdf(X0, X1[..., 0:3])
    radial = -(n - axis * (n * axis).sum(-1, keepdim=True))
    rn = torch.linalg.vector_norm(radial, dim=-1, keepdim=True)
    t1, _ = orthonormal_basis(axis)
    radial = torch.where(rn > 1e-6, radial / torch.clamp(rn, min=_EPS), t1)
    return axis, radial


def _plane_points(X0, pts):
    """Contacts of world points (..., K, 3) against a plane: each point
    pushed half its depth along the normal."""
    d, n2 = _plane_sdf(X0[..., None, :], pts)
    pos = pts - n2 * (d[..., None] * 0.5)
    return pos, n2.expand_as(pos), -d


def plane_cone(X0, X1, s0, s1):
    """Four slots: the apex and three base-rim points 120 degrees apart,
    the first the rim point nearest the plane."""
    axis, radial = _axis_radial(X0, X1)
    r, h = s1[..., 0:1], s1[..., 1:2]
    apex = X1[..., 0:3] + axis * h
    base = X1[..., 0:3] - axis * h
    side = cross(axis, radial)
    pts = torch.stack([apex, base + radial * r,
                       base - 0.5 * radial * r + 0.866 * side * r,
                       base - 0.5 * radial * r - 0.866 * side * r], dim=-2)
    return _plane_points(X0, pts)


def _ellipsoid_support(X, s, d):
    """World support point of ellipsoids of radii s along world
    directions d: s v / |v| with v = s (R^T d)."""
    v = quat_rotate_inv(X[..., 3:7], d) * s
    return transform_point(X, s * v / torch.clamp(
        torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=_EPS))


def plane_ellipsoid(X0, X1, s0, s1):
    """One slot: the ellipsoid's support point along -n against the
    plane."""
    _, n = _plane_sdf(X0, X1[..., 0:3])
    p = _ellipsoid_support(X1, s1, -n)
    d, n2 = _plane_sdf(X0, p)
    pos = p - n2 * (d[..., None] * 0.5)
    return pos[..., None, :], n2[..., None, :], -d[..., None]


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


def sphere_box(X0, X1, s0, s1):
    """One slot: the sphere centre against the box's signed distance."""
    d, g = _box_sdf_local(transform_point_inv(X1, X0[..., 0:3]), s1)
    n = -quat_rotate(X1[..., 3:7], g)               # sphere -> box surface
    depth = s0[..., 0] - d
    pos = X0[..., 0:3] + n * (s0[..., 0] - 0.5 * depth)[..., None]
    return pos[..., None, :], n[..., None, :], depth[..., None]


def _unit(d):
    """d / max(|d|, eps) (the JAX package's centre-line normal)."""
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=_EPS)


def sphere_ellipsoid(X0, X1, s0, s1):
    """One slot, along the centre line: the ellipsoid's support point
    toward the sphere against the sphere's radius (the JAX package's
    approximation)."""
    n = _unit(X1[..., 0:3] - X0[..., 0:3])
    sup = _ellipsoid_support(X1, s1, -n)
    depth = s0[..., 0] - ((sup - X0[..., 0:3]) * n).sum(-1)
    pos = X0[..., 0:3] + n * (s0[..., 0] - 0.5 * depth)[..., None]
    return pos[..., None, :], n[..., None, :], depth[..., None]


def ellipsoid_ellipsoid(X0, X1, s0, s1):
    """One slot, along the centre line: the gap between the two support
    points toward each other (the JAX package's approximation)."""
    n = _unit(X1[..., 0:3] - X0[..., 0:3])
    sup0 = _ellipsoid_support(X0, s0, n)
    sup1 = _ellipsoid_support(X1, s1, -n)
    depth = ((sup0 - sup1) * n).sum(-1)
    return (0.5 * (sup0 + sup1))[..., None, :], n[..., None, :], \
        depth[..., None]


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


def capsule_box(X0, X1, s0, s1):
    """Four slots: the capsule's endpoints and two interior points of its
    axis at thirds, each against the box's signed distance."""
    a, b = _segment_endpoints(X0, s0[..., 1])
    ts = torch.arange(4, dtype=X0.dtype, device=X0.device) / 3.0
    pts = a[..., None, :] + (b - a)[..., None, :] * ts[:, None]  # (..., 4, 3)
    d, g = _box_sdf_local(transform_point_inv(X1[..., None, :], pts),
                          s1[..., None, :])
    n = -quat_rotate(X1[..., None, 3:7], g)
    depth = s0[..., 0:1] - d
    pos = pts + n * (s0[..., 0:1] - 0.5 * depth)[..., None]
    return pos, n, depth


def _take(x, idx):
    """x (..., 6, ...) at axis index idx (...,) along dim -2 or -1."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def box_box(X0, X1, s0, s1):
    """Sixteen slots from the face axes' separating-axis test: the axis of
    least overlap among the six face normals is the normal; each box's
    corners past the other's face along it, clamped into that face's
    rectangle, are the manifold points (set 1 then set 0; edge-edge
    contact takes the nearest face axis, as in the JAX package)."""
    R0 = quat_to_matrix(X0[..., 3:7])                        # (..., 3, 3)
    R1 = quat_to_matrix(X1[..., 3:7])
    axes = torch.cat([R0.transpose(-1, -2), R1.transpose(-1, -2)], -2)
    dp = X1[..., 0:3] - X0[..., 0:3]
    r0 = ((axes @ R0).abs() @ s0[..., None])[..., 0]          # (..., 6)
    r1 = ((axes @ R1).abs() @ s1[..., None])[..., 0]
    dist = (axes @ dp[..., None])[..., 0]
    overlap = r0 + r1 - dist.abs()
    best = overlap.argmin(-1)                                # first of ties
    n_axis = torch.gather(axes, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    sign = torch.sign(_take(dist, best))
    sign = torch.where(sign == 0, 1.0, sign)
    n = n_axis * sign[..., None]                             # 0 -> 1
    min_overlap = _take(overlap, best)
    separated = min_overlap < 0.0

    c0 = _box_corners(X0, s0)                                # (..., 8, 3)
    c1 = _box_corners(X1, s1)
    face0 = (X0[..., 0:3] * n).sum(-1) + _take(r0, best)
    depth1 = face0[..., None] - (c1 * n[..., None, :]).sum(-1)  # (..., 8)
    face1 = (X1[..., 0:3] * n).sum(-1) - _take(r1, best)
    depth0 = (c0 * n[..., None, :]).sum(-1) - face1[..., None]
    # corners past the face are clamped into the other box's face
    # rectangle; the axis along the normal is widened so it never clamps
    big = 10.0 * (s0.max(-1).values + s1.max(-1).values)[..., None]
    n_in0 = (n[..., None, :] @ R0)[..., 0, :].abs()          # (..., 3)
    n_in1 = (n[..., None, :] @ R1)[..., 0, :].abs()
    ext0 = (s0 + big * n_in0)[..., None, :]
    ext1 = (s1 + big * n_in1)[..., None, :]
    l1_in0 = (c1 - X0[..., None, 0:3]) @ R0
    l0_in1 = (c0 - X1[..., None, 0:3]) @ R1
    c1 = X0[..., None, 0:3] + torch.minimum(torch.maximum(
        l1_in0, -ext0), ext0) @ R0.transpose(-1, -2)
    c0 = X1[..., None, 0:3] + torch.minimum(torch.maximum(
        l0_in1, -ext1), ext1) @ R1.transpose(-1, -2)
    cap = torch.clamp(min_overlap, min=0.0)[..., None]
    sep = separated[..., None]
    depth1 = torch.where(sep, -1.0, torch.minimum(depth1, cap))
    depth0 = torch.where(sep, -1.0, torch.minimum(depth0, cap))
    pos1 = c1 + n[..., None, :] * (0.5 * depth1)[..., None]
    pos0 = c0 - n[..., None, :] * (0.5 * depth0)[..., None]
    pos = torch.cat([pos1, pos0], -2)
    return (pos, n[..., None, :].expand_as(pos),
            torch.cat([depth1, depth0], -1))


def box_cylinder(X0, X1, s0, s1):
    """The cylinder as a capsule against the box: capsule_box with the
    arguments swapped and the normal turned back to box -> cylinder."""
    pos, nrm, depth = capsule_box(X1, X0, s1, s0)
    return pos, -nrm, depth


def sphere_cylinder(X0, X1, s0, s1):
    """The cylinder as a capsule of its radius and half-height."""
    return sphere_capsule(X0, X1, s0, s1)


def capsule_cylinder(X0, X1, s0, s1):
    """The cylinder as a capsule of its radius and half-height."""
    return capsule_capsule(X0, X1, s0, s1)

# dispatch table keyed by (type0, type1); capsule_box is keyed (CAPSULE,
# BOX) as in the JAX package, so a BOX-CAPSULE pair runs it swapped
PRIMITIVE_FNS = {
    (_P, _S): plane_sphere,
    (_P, _C): plane_capsule,
    (_P, _B): plane_box,
    (_P, _CY): plane_cylinder,
    (_P, _CO): plane_cone,
    (_P, _E): plane_ellipsoid,
    (_S, _S): sphere_sphere,
    (_S, _C): sphere_capsule,
    (_S, _B): sphere_box,
    (_S, _E): sphere_ellipsoid,
    (_S, _CY): sphere_cylinder,
    (_C, _C): capsule_capsule,
    (_C, _B): capsule_box,
    (_B, _B): box_box,
    (_C, _CY): capsule_cylinder,
    (_CY, _CY): capsule_capsule,
    (_B, _CY): box_cylinder,
    (_E, _E): ellipsoid_ellipsoid,
}


def contact_fn_for(t0: int, t1: int):
    """(fn, swapped, slots) for a type pair. A pair of the six analytic
    types without a function of its own gets the support-map MPR function
    of the sorted pair (``swapped`` when t0 > t1, as the JAX package
    keys it); a pair with any other type (a mesh kind: the pipeline's
    mesh classes take it, ``sim/collide_mesh.py``) gets (None, False,
    slots), as in the JAX package."""
    key = (int(t0), int(t1))
    if key in PRIMITIVE_FNS:
        return PRIMITIVE_FNS[key], False, pair_slot_count(t0, t1)
    if key[::-1] in PRIMITIVE_FNS:
        return PRIMITIVE_FNS[key[::-1]], True, pair_slot_count(t0, t1)
    from .support import SUPPORT_TYPES, support_contact_fn
    if key[0] in SUPPORT_TYPES and key[1] in SUPPORT_TYPES:
        k = pair_slot_count(t0, t1)
        lo, hi = min(key), max(key)
        return support_contact_fn(lo, hi, k), key[0] > key[1], k
    return None, False, pair_slot_count(t0, t1)
