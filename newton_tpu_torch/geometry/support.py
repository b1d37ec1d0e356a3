"""Support maps of convex shapes (port of ``newton_tpu/geometry/support.py``).

Every convex shape exposes a world support map ``sup(d) -> point`` (the
point of the shape farthest along the world direction ``d``), so that any
convex-convex pair runs through one generic MPR contact path
(``geometry/mpr.py``) instead of an analytic function per type pair. A
support map is a closure over the batched transforms and scales,
evaluated branch-free for every pair of a batch at once; leading batch
dimensions ``(...,)`` are allowed throughout.

Shape frames (as ``geometry/narrow_phase.py``): SPHERE radius = scale[0];
BOX half-extents = scale; CAPSULE, CYLINDER and CONE radius = scale[0],
half-height = scale[1], axis +Z (the cone's apex at +h, its base disc at
-h); ELLIPSOID radii = scale; CONVEX and MESH a hull vertex cloud (padded
by repetition). The hull types' maps are here, but the builder makes no
CONVEX or MESH shape yet (ROADMAP A.6).

``make_support_mixed`` and ``support_center_mixed`` take a per-row type
instead of one type: they evaluate the local support of each type present
and select each row's, so that the support pairs of several type classes
run as one batch with the values the per-class maps give. Every analytic
map (``make_support`` is the mixed map with one type present) rotates by
a matrix made once per map, not by the quaternion each call (the JAX
package's form, kept for the hull clouds): the same points up to
rounding, at a tenth of the operations.
"""

from __future__ import annotations

import torch

from ..math import quat_rotate_inv, quat_to_matrix, transform_point
from .types import GeoType

__all__ = ["SUPPORT_TYPES", "make_support", "support_center",
           "support_contact_fn", "make_support_mixed",
           "support_center_mixed"]

_S, _B = int(GeoType.SPHERE), int(GeoType.BOX)
_C, _CY, _CO = int(GeoType.CAPSULE), int(GeoType.CYLINDER), int(GeoType.CONE)
_E, _CX, _M = int(GeoType.ELLIPSOID), int(GeoType.CONVEX), int(GeoType.MESH)

# geo types with an analytic support map (hull types need vertex clouds)
SUPPORT_TYPES = frozenset({_S, _B, _C, _CY, _CO, _E})


def _hull_support(verts, X, d):
    """World support point of local vertex clouds: verts (..., H, 3),
    X (..., 7), d (..., 3) world directions; the first vertex among equal
    projections (as ``jnp.argmax``)."""
    dl = quat_rotate_inv(X[..., 3:7], d)
    dots = (verts * dl[..., None, :]).sum(-1)
    idx = dots.argmax(-1)
    p = torch.gather(verts, -2, idx[..., None, None].expand(
        *idx.shape, 1, 3))[..., 0, :]
    return transform_point(X, p)


def _local_support(t: int, s, dl):
    """Support point in the shape frame of type ``t`` along normalized
    local directions dl (..., 3); s (..., 3) the scales."""
    if t == _S:
        return s[..., 0:1] * dl
    if t == _B:
        return torch.where(dl >= 0.0, s, -s)
    if t == _E:
        v = s * dl
        return s * v / torch.clamp(torch.linalg.vector_norm(
            v, dim=-1, keepdim=True), min=1e-9)
    r, h = s[..., 0:1], s[..., 1:2]
    dz = dl[..., 2:3]
    zero = torch.zeros_like(dz)
    if t == _C:
        # segment endpoint + radius sweep
        tip = torch.cat([zero, zero, torch.where(dz >= 0.0, h, -h)], -1)
        return tip + r * dl
    # radial direction in the XY plane (+X on the axis)
    dxy = dl[..., 0:2]
    lxy = torch.linalg.vector_norm(dxy, dim=-1, keepdim=True)
    u = torch.where(lxy > 1e-9, dxy / torch.clamp(lxy, min=1e-9),
                    torch.cat([torch.ones_like(dz), zero], -1))
    if t == _CY:
        return torch.cat([r * u, torch.where(dz >= 0.0, h, -h)], -1)
    if t == _CO:
        # apex (0, 0, h) or the base rim point (r u, -h), whichever lies
        # farther along dl
        dot_apex = h * dz
        dot_base = r * lxy - h * dz
        rim = torch.cat([r * u, -h * torch.ones_like(dz)], -1)
        apex = torch.cat([zero, zero, h], -1)
        return torch.where(dot_base > dot_apex, rim, apex)
    raise ValueError(f"no support map for geo type {t}")


def make_support(geo_type: int, X, s, verts=None):
    """A world support map ``sup(d) -> (..., 3)`` of one shape batch of
    type ``geo_type``: X (..., 7) the shape transforms, s (..., 3) the
    scales, d normalized world directions; CONVEX and MESH also need
    ``verts`` (..., H, 3), their local hull vertices."""
    t = int(geo_type)
    if t in (_CX, _M):
        if verts is None:
            raise ValueError("hull support needs vertex cloud")
        return lambda d: _hull_support(verts, X, d)
    if t not in SUPPORT_TYPES:
        raise ValueError(f"no support map for geo type {t}")
    return make_support_mixed(None, (t,), X, s)


def support_center(geo_type: int, X, s, verts=None):
    """A strictly interior point of each shape (the MPR ray origin): the
    frame origin, the hull's mean vertex, and the cone's centroid
    (0, 0, -h/2), which conditions its portal better."""
    t = int(geo_type)
    if t in (_CX, _M):
        if verts is None:
            raise ValueError("hull center needs vertex cloud")
        return transform_point(X, verts.mean(-2))
    if t == _CO:
        h = s[..., 1:2]
        z = torch.zeros_like(h)
        return transform_point(X, torch.cat([z, z, -0.5 * h], -1))
    return X[..., 0:3]


def make_support_mixed(types, present, X, s):
    """A world support map of shapes of the analytic types ``present``
    (host ints), ``types`` (...,) each row's type (None where one type is
    present). Each present type's local support is evaluated for every
    row and each row takes its own; a sphere's point is c + r d. The
    rotation is a matrix made once per map: three operations a direction,
    against ~40 for a quaternion rotation (the JAX package's form; the two
    differ in rounding only)."""
    present = sorted(int(t) for t in present)
    R = quat_to_matrix(X[..., 3:7])                         # (..., 3, 3)
    c = X[..., 0:3]
    local = [t for t in present if t != _S]
    if not local:
        return lambda d: c + s[..., 0:1] * d
    masks = [(types == t)[..., None] for t in local[1:]]
    sphere = (types == _S)[..., None] if _S in present else None

    def sup(d):
        dl = (R * d[..., :, None]).sum(-2)                  # R^T d
        p = _local_support(local[0], s, dl)
        for t, m in zip(local[1:], masks):
            p = torch.where(m, _local_support(t, s, dl), p)
        p = c + (R * p[..., None, :]).sum(-1)               # c + R p
        if sphere is not None:
            p = torch.where(sphere, c + s[..., 0:1] * d, p)
        return p
    return sup


def support_center_mixed(types, present, X, s):
    """``support_center`` of shapes of mixed analytic types."""
    c = X[..., 0:3]
    if int(_CO) not in {int(t) for t in present}:
        return c
    return torch.where((types == _CO)[..., None],
                       support_center(_CO, X, s), c)


def support_contact_fn(t0: int, t1: int, slots: int):
    """The generic convex-convex pair function through support-map MPR:
    ``fn(X0, X1, s0, s1) -> (pos (..., slots, 3), nrm, depth)``, usable
    wherever a ``PRIMITIVE_FNS`` entry is. The five-point manifold of
    ``support_manifold`` is cut to ``slots`` by keeping the deepest."""
    from .mpr import support_manifold

    def fn(X0, X1, s0, s1):
        pos, nrm, dep = support_manifold(
            make_support(t0, X0, s0), make_support(t1, X1, s1),
            support_center(t0, X0, s0), support_center(t1, X1, s1))
        return keep_deepest(pos, nrm, dep, slots)

    fn.__name__ = f"support_{GeoType(t0).name.lower()}_" \
                  f"{GeoType(t1).name.lower()}"
    return fn


def keep_deepest(pos, nrm, dep, k: int):
    """The k deepest of a manifold's points (all of them where it has no
    more), deepest first with ties to the lower index (``lax.top_k``'s
    order: a stable descending sort)."""
    if k >= dep.shape[-1]:
        return pos[..., :k, :], nrm[..., :k, :], dep[..., :k]
    top, sel = torch.sort(dep, dim=-1, descending=True, stable=True)
    top, sel = top[..., :k], sel[..., :k]
    idx = sel[..., None].expand(*sel.shape, 3)
    return (torch.gather(pos, -2, idx), torch.gather(nrm, -2, idx), top)
