"""Convex-convex distance through support maps (port of
``newton_tpu/geometry/gjk.py``).

The Frank-Wolfe form of GJK on the Minkowski difference: each iteration
takes the support point along the negative gradient and steps by an exact
line search. The iteration counts are fixed (no data-dependent exit), so
a batch runs one program and the host never waits for the card. Leading
batch dimensions ``(...,)`` are allowed throughout.
"""

from __future__ import annotations

import torch

from ..math import quat_rotate_inv, transform_point

__all__ = ["support_point", "gjk_distance", "gjk_closest"]


def support_point(verts, X, d):
    """Farthest point of convex vertex clouds along world directions d:
    verts (..., K, 3) shape-local, X (..., 7), d (..., 3); the first of
    equal projections."""
    d_local = quat_rotate_inv(X[..., 3:7], d)
    dots = (verts * d_local[..., None, :]).sum(-1)
    idx = dots.argmax(-1)
    p = torch.gather(verts, -2, idx[..., None, None].expand(
        *idx.shape, 1, 3))[..., 0, :]
    return transform_point(X, p)


def _fw_step(x, wa, wb, sa, sb):
    """One Frank-Wolfe step toward the support point s = sa - sb with the
    exact line search t in [0, 1]; the witnesses follow."""
    dxs = (sa - sb) - x
    denom = (dxs * dxs).sum(-1)
    t = torch.where(denom > 1e-12, -(x * dxs).sum(-1)
                    / torch.clamp(denom, min=1e-12), 0.0)
    t = torch.clamp(t, 0.0, 1.0)[..., None]
    return x + t * dxs, wa + t * (sa - wa), wb + t * (sb - wb)


def gjk_distance(verts_a, X_a, verts_b, X_b, iterations: int = 32):
    """Distance and closest points (dist, p_a, p_b) between convex vertex
    clouds; dist is 0 for touching or overlapping pairs."""
    d0 = X_b[..., 0:3] - X_a[..., 0:3]
    pa = support_point(verts_a, X_a, -d0)
    pb = support_point(verts_b, X_b, d0)
    x, wa, wb = pa - pb, pa, pb
    for _ in range(iterations):
        x, wa, wb = _fw_step(x, wa, wb, support_point(verts_a, X_a, -x),
                             support_point(verts_b, X_b, x))
    return torch.linalg.vector_norm(x, dim=-1), wa, wb


def gjk_closest(supA, supB, ca, cb, iterations: int = 24):
    """Frank-Wolfe closest points on support maps (``geometry/support.py``
    ``make_support``); ca/cb interior points. Returns (dist, p_a, p_b) as
    ``gjk_distance``: the exact separation and witness points of pairs
    not yet touching, which the manifold's margin contacts take."""
    pa = supA(_normalize_fw(cb - ca))
    pb = supB(_normalize_fw(ca - cb))
    x, wa, wb = pa - pb, pa, pb
    for _ in range(iterations):
        x, wa, wb = _fw_step(x, wa, wb, supA(-x), supB(x))
    return torch.linalg.vector_norm(x, dim=-1), wa, wb


def _normalize_fw(v, eps=1e-9):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)
