"""Minkowski Portal Refinement for convex-convex penetration (port of
``newton_tpu/geometry/mpr.py``).

The portal algebra runs branch-free over the whole pair batch with fixed
iteration counts (6 discovery and 20 refinement steps): every conditional
portal update is a ``torch.where``, so one program serves all pairs, and
the host never waits on the card for an exit test. A portal vertex keeps
its point of the difference A - B and its two witnesses packed as one
(..., 9) row ``[v | a | b]``, so that a portal swap is one select.

The core (``mpr_contact_support``) works on support maps
(``geometry/support.py``), so analytic primitives and hull vertex clouds
share one contact path; ``mpr_contact`` and ``convex_manifold`` wrap hull
clouds. Outputs follow the contact convention: the normal points from A
(first) toward B (second), depth > 0 is penetration, and translating B by
+depth * normal separates the pair. The manifold (``support_manifold``)
adds four support probes tilted toward the tangent diagonals, which walk
to the corners of a flat contact patch.

``_normalize`` is ``v * rsqrt(max(|v|^2, 1e-12))``, the JAX package's
exact form: the portal tests are sign tests on small numbers.
"""

from __future__ import annotations

import torch

from ..math import transform_point
from .support import _hull_support

__all__ = ["mpr_contact", "mpr_contact_support", "convex_manifold",
           "support_manifold"]


def _normalize(v, eps=1e-12):
    return v * torch.rsqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                       min=eps))


def _dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def mpr_contact_support(supA, supB, ca, cb, discover_iters: int = 6,
                        refine_iters: int = 20):
    """Penetration of overlapping convex pairs: supA/supB world support
    maps, ca/cb (..., 3) strictly interior points (the portal ray's
    origin). Returns (hit (...,), depth (...,), normal (..., 3) from A
    toward B, point (..., 3) the world contact midpoint); for pairs that
    do not overlap hit is False and the rest best effort."""
    def msup(d):
        """Support of A - B along d with its witnesses: [v | a | b]."""
        pa = supA(d)
        pb = supB(-d)
        return torch.cat([pa - pb, pa, pb], -1)

    def sel(m, x, y):
        return torch.where(m[..., None], x, y)

    v0 = ca - cb
    # coincident centres: nudge so the ray is defined
    tiny = torch.zeros_like(v0)
    tiny[..., 0] = 1e-5
    v0 = sel(_dot(v0, v0) < 1e-12, v0 + tiny, v0)

    d1 = _normalize(-v0)
    p1 = msup(d1)
    v1 = p1[..., 0:3]
    # a miss when the boundary along the origin ray lies before the origin
    miss = _dot(v1, d1) < 0.0

    d2r = cross(v1, v0)
    # the origin on the v0-v1 line (face-aligned boxes): the ray direction
    # is the contact normal, libccd's touching case
    colinear = _dot(d2r, d2r) < 1e-14
    # any direction orthogonal to d1 (Duff et al. basis)
    s = torch.where(d1[..., 2] >= 0.0, 1.0, -1.0)
    a_ = -1.0 / (s + d1[..., 2])
    ortho = torch.stack([1.0 + s * d1[..., 0] * d1[..., 0] * a_,
                         s * d1[..., 0] * d1[..., 1] * a_,
                         -s * d1[..., 0]], -1)
    d2 = _normalize(sel(colinear, ortho, d2r))
    p2 = msup(d2)
    miss = miss | (~colinear & (_dot(p2[..., 0:3], d2) < 0.0))

    n = cross(v1 - v0, p2[..., 0:3] - v0)
    swap = _dot(n, v0) > 0.0
    p1, p2 = sel(swap, p2, p1), sel(swap, p1, p2)
    n = sel(swap, -n, n)
    p3 = msup(_normalize(n))

    # portal discovery (libccd discoverPortal, branch-free): keep the
    # candidate portal (v1, v2, v3) wrapped around the v0 -> origin ray
    for _ in range(discover_iters):
        v1, v2, v3 = p1[..., 0:3], p2[..., 0:3], p3[..., 0:3]
        c_repl2 = _dot(cross(v1, v3), v0) < 0.0
        c_repl1 = (_dot(cross(v3, v2), v0) < 0.0) & ~c_repl2
        p2 = sel(c_repl2, p3, p2)
        p1 = sel(c_repl1, p3, p1)
        n = _normalize(cross(p1[..., 0:3] - v0, p2[..., 0:3] - v0))
        p3 = sel(c_repl1 | c_repl2, msup(n), p3)

    # portal refinement (libccd expandPortal): push the portal face out to
    # the Minkowski boundary along its own normal
    for _ in range(refine_iters):
        v1, v2, v3 = p1[..., 0:3], p2[..., 0:3], p3[..., 0:3]
        pn = cross(v2 - v1, v3 - v1)
        pn = _normalize(sel(_dot(pn, v1 - v0) < 0.0, -pn, pn))
        p4 = msup(pn)
        v4 = p4[..., 0:3]
        live = ~(_dot(pn, v4 - v1) < 1e-6)
        w = cross(v4, v0)
        c1 = _dot(v1, w) > 0.0
        c2 = _dot(v2, w) > 0.0
        c3 = _dot(v3, w) > 0.0
        p1 = sel(((c1 & c2) | (~c1 & ~c3)) & live, p4, p1)
        p2 = sel((~c1 & c3) & live, p4, p2)
        p3 = sel((c1 & ~c2) & live, p4, p3)

    v1, v2, v3 = p1[..., 0:3], p2[..., 0:3], p3[..., 0:3]
    pn = cross(v2 - v1, v3 - v1)
    pn = _normalize(sel(_dot(pn, v1 - v0) < 0.0, -pn, pn))
    depth = _dot(pn, v1)
    # the colinear case: the ray is the normal, the boundary its depth
    depth = torch.where(colinear, _dot(v1, d1), depth)
    pn = sel(colinear, d1, pn)
    hit = (depth >= 0.0) & ~miss

    # witnesses: barycentric coordinates of the origin's projection onto
    # the portal
    P = depth[..., None] * pn
    e1 = v2 - v1
    e2 = v3 - v1
    ep = P - v1
    d11 = _dot(e1, e1)
    d12 = _dot(e1, e2)
    d22 = _dot(e2, e2)
    dp1 = _dot(ep, e1)
    dp2 = _dot(ep, e2)
    den = torch.clamp(d11 * d22 - d12 * d12, min=1e-12)
    l2 = torch.clamp((d22 * dp1 - d12 * dp2) / den, 0.0, 1.0)
    l3 = torch.clamp((d11 * dp2 - d12 * dp1) / den, 0.0, 1.0)
    l1 = torch.clamp(1.0 - l2 - l3, 0.0, 1.0)
    tot = torch.clamp(l1 + l2 + l3, min=1e-9)
    l1, l2, l3 = l1 / tot, l2 / tot, l3 / tot
    wab = (l1[..., None] * p1[..., 3:9] + l2[..., None] * p2[..., 3:9]
           + l3[..., None] * p3[..., 3:9])
    point = 0.5 * (wab[..., 0:3] + wab[..., 3:6])
    point = sel(colinear, 0.5 * (p1[..., 3:6] + p1[..., 6:9]), point)
    return hit, depth, pn, point


def mpr_contact(va, Xa, vb, Xb, discover_iters: int = 6,
                refine_iters: int = 20):
    """Hull-cloud MPR: va/vb (..., H, 3) shape-local hull vertices (padded
    by repeating a vertex), Xa/Xb (..., 7) world transforms."""
    ca = transform_point(Xa, va.mean(-2))
    cb = transform_point(Xb, vb.mean(-2))
    return mpr_contact_support(
        lambda d: _hull_support(va, Xa, d),
        lambda d: _hull_support(vb, Xb, d), ca, cb, discover_iters,
        refine_iters)


def support_manifold(supA, supB, ca, cb, tilt: float = 0.02):
    """Up to five contacts per pair: MPR's core contact (for separated
    pairs the Frank-Wolfe closest points, ``gjk_closest``), then four
    support probes tilted from the core normal toward the tangent
    diagonals; a probe within 1e-4 of the core point or of an earlier
    probe gets depth -1e9. Returns (pos (..., 5, 3), nrm (..., 5, 3),
    depth (..., 5)); a negative depth is a separation along the core
    normal, for the caller's margin to judge."""
    from .gjk import gjk_closest
    hit, depth0, n0, p0 = mpr_contact_support(supA, supB, ca, cb)
    dist, pa_s, pb_s = gjk_closest(supA, supB, ca, cb)
    d_sep = _normalize(pb_s - pa_s)          # A -> B at closest approach
    fallback = (d_sep * d_sep).sum(-1) < 0.5    # touching: degenerate
    n_sep = torch.where(fallback[..., None], _normalize(cb - ca), d_sep)
    n0 = torch.where(hit[..., None], n0, n_sep)
    depth0 = torch.where(hit, depth0, -dist)
    p0 = torch.where(hit[..., None], p0, 0.5 * (pa_s + pb_s))

    # tangent basis of the core normal (Duff et al.)
    nx, ny, nz = n0[..., 0], n0[..., 1], n0[..., 2]
    s = torch.where(nz >= 0.0, 1.0, -1.0)
    a_ = -1.0 / (s + nz)
    b_ = nx * ny * a_
    t1 = torch.stack([1.0 + s * nx * nx * a_, s * b_, -s * nx], -1)
    t2 = torch.stack([b_, s + ny * ny * a_, -ny], -1)

    # diagonal probes resolve the patch corners even under support ties
    # on axis-aligned faces
    pos, dep = [p0], [depth0]
    for tdir in (t1 + t2, t1 - t2, -t1 + t2, -t1 - t2):
        t = _normalize(tdir)
        qa = supA(_normalize(n0 + tilt * t))     # A's face extreme
        qb = supB(_normalize(-n0 + tilt * t))    # B's, same side
        # the patch boundary toward t: the tighter of the two extremes
        p = torch.where((_dot(qa, t) < _dot(qb, t))[..., None], qa, qb)
        pos.append(p - _dot(p - p0, n0)[..., None] * n0)   # onto the plane
        dep.append(_dot(qa - qb, n0))     # face gap along the core normal
    pos = torch.stack(pos, -2)                                # (..., 5, 3)
    dep = torch.stack(dep, -1)
    # probes that collapse (sphere-like shapes) onto the core point or an
    # earlier probe get a depth the margin test rejects
    dup = []
    for i in range(1, 5):
        close = ((pos[..., i:i + 1, :] - pos[..., :i, :]) ** 2).sum(-1) \
            < 1e-8
        dup.append(close.any(-1))
    dup = torch.stack(dup, -1)
    dep = torch.cat([dep[..., :1], torch.where(dup, -1e9, dep[..., 1:])],
                    -1)
    return pos, n0[..., None, :].expand_as(pos), dep


def convex_manifold(va, Xa, vb, Xb, tilt: float = 0.02):
    """Hull-cloud manifold: see ``support_manifold``."""
    ca = transform_point(Xa, va.mean(-2))
    cb = transform_point(Xb, vb.mean(-2))
    return support_manifold(lambda d: _hull_support(va, Xa, d),
                            lambda d: _hull_support(vb, Xb, d), ca, cb,
                            tilt)
