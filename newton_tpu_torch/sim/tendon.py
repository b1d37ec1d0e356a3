"""Spatial tendons with sphere and cylinder wrap geometry (port of
``newton_tpu/sim/tendon.py``).

A tendon path is a static sequence of elements: attachment sites
(body-frame points), optionally separated by wrap geoms (sphere or cylinder
surfaces the path slides around). Between two sites around a wrap geom the
path is the shortest one: straight tangent, geodesic arc (a helix on a
cylinder: unrolled, the axial coordinate varies linearly with the 2D path
length), straight tangent; where the straight segment misses the surface
the wrap is inactive and the segment is straight. The moment rows dL/dq
follow from the envelope theorem: tangent points are material points of
the wrap body, so only the straight segments contribute, each as
``u . (dp1/dq - dp0/dq)``. A sidesite forces the wrap to pass on its side;
without one the shorter of the two candidate paths wins.

The port keeps vectors on a trailing axis of 3: body poses ``(..., B,
7)``, the dof subspace ``(..., D, 3)``; lengths come out ``(..., )`` and
moment rows ``(..., D)`` per tendon. Both candidate wraps are evaluated
and selected with ``torch.where``, so the JAX package's epsilons are kept:
the side that is not selected stays finite. Host callers (the rest length
at finalize) pass float64 CPU tensors.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..math import cross, quat_rotate

__all__ = ["SpatialTendonPath", "eval_spatial_tendons",
           "spatial_tendon_rest_length", "spatial_tendon_rest_lengths"]

_EPS = 1e-12


class SpatialTendonPath:
    """Static description of one spatial tendon's routing (host side).

    ``elems`` is a list of tuples in path order:
      ("site", body, pos)                      attachment or via point
      ("sphere", body, pos, radius, side)      wrap sphere (side: the body-
                                               frame sidesite, or None)
      ("cylinder", body, pos, axis, radius, side)  wrap cylinder
    ``body == -1`` means fixed in the world. A wrap element sits between
    two sites (MuJoCo's rule: two consecutive objects cannot both be wrap
    geoms)."""

    __slots__ = ("elems",)

    def __init__(self, elems: Sequence[tuple]):
        elems = list(elems)
        if len(elems) < 2 or elems[0][0] != "site" or elems[-1][0] != "site":
            raise ValueError("spatial tendon path must start and end with "
                             "a site")
        for a, b in zip(elems, elems[1:]):
            if a[0] != "site" and b[0] != "site":
                raise ValueError("two consecutive wrap geoms are not "
                                 "supported (MuJoCo has the same rule)")
        self.elems = elems

    def remapped(self, body_map) -> "SpatialTendonPath":
        """The same path with each body ``b >= 0`` replaced by
        ``body_map(b)``."""
        return SpatialTendonPath([
            (e[0], body_map(e[1]) if e[1] >= 0 else -1, *e[2:])
            for e in self.elems])

    def key(self):
        """A hashable form (element kinds, bodies and constants)."""
        def h(x):
            if isinstance(x, (tuple, list, np.ndarray)):
                return tuple(float(v) for v in x)
            return x
        return tuple(tuple(h(x) for x in e) for e in self.elems)


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(a):
    return torch.sqrt(torch.clamp(_dot(a, a), min=_EPS))


def _normalize(a):
    inv = 1.0 / _norm(a)
    return a * inv[..., None], 1.0 / inv


_CONSTS = {}


def _const(v, like):
    """A host constant (a site's position, a wrap's axis) on ``like``'s
    device and dtype, copied once: a copy from host memory in every call
    would make the host wait for the card and cannot be captured in a
    CUDA graph."""
    a = np.asarray(v, dtype=np.float64)
    key = (a.tobytes(), a.shape, like.dtype, str(like.device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(a, dtype=like.dtype,
                                           device=like.device)
    return t


def _point_world(body_q, body: int, pos):
    """World position of a body-frame point (static body index)."""
    loc = _const(pos, body_q)
    if body < 0:
        return loc.expand(*body_q.shape[:-2], 3)
    X = body_q[..., body, :]
    return X[..., 0:3] + quat_rotate(X[..., 3:7], loc.expand_as(X[..., 0:3]))


def _axis_world(body_q, body: int, axis):
    loc = _const(axis, body_q)
    if body < 0:
        return loc.expand(*body_q.shape[:-2], 3)
    q = body_q[..., body, 3:7]
    return quat_rotate(q, loc.expand(*q.shape[:-1], 3))


def _wrap_2d(ax, ay, bx, by, r, side_sign=None):
    """Shortest path from a to b around the circle of radius ``r`` at the
    origin (2D). Returns (active, t1, t2, l_tan_a, arc, l_tan_b) with the
    tangent points as (x, y) pairs. ``side_sign`` (+-1) forces the wrap
    side; None picks the shorter path. Every output is finite, also where
    the wrap is inactive."""
    da2 = ax * ax + ay * ay
    db2 = bx * bx + by * by
    da2s = torch.clamp(da2, min=_EPS)
    db2s = torch.clamp(db2, min=_EPS)
    ta = torch.sqrt(torch.clamp(da2 - r * r, min=0.0))
    tb = torch.sqrt(torch.clamp(db2 - r * r, min=0.0))
    # does the straight segment a-b come within r of the origin?
    ex, ey = bx - ax, by - ay
    e2 = torch.clamp(ex * ex + ey * ey, min=_EPS)
    t_seg = torch.clamp(-(ax * ex + ay * ey) / e2, 0.0, 1.0)
    cx, cy = ax + t_seg * ex, ay + t_seg * ey
    d_seg2 = cx * cx + cy * cy
    active = (d_seg2 < r * r) & (da2 > r * r) & (db2 > r * r)
    rr = max(r * r, _EPS)

    def candidate(omega):
        # winding omega: +1 = counterclockwise travel a -> b around the arc
        t1x = (r * r * ax - omega * r * ta * ay) / da2s
        t1y = (r * r * ay + omega * r * ta * ax) / da2s
        t2x = (r * r * bx + omega * r * tb * by) / db2s
        t2y = (r * r * by - omega * r * tb * bx) / db2s
        cosd = (t1x * t2x + t1y * t2y) / rr
        sind = omega * (t1x * t2y - t1y * t2x) / rr
        dth = torch.atan2(sind, cosd)
        dth = torch.where(dth < 0.0, dth + 2.0 * math.pi, dth)
        return (t1x, t1y), (t2x, t2y), dth

    t1p, t2p, dth_p = candidate(1.0)
    t1m, t2m, dth_m = candidate(-1.0)
    if side_sign is None:
        pick_p = dth_p <= dth_m
    else:
        # the side of the candidate's tangent points against the chord
        # a -> b must match the sidesite's; the shorter when ambiguous
        def side_of(t):
            return (bx - ax) * (t[1] - ay) - (by - ay) * (t[0] - ax)
        sp = side_of(t1p) + side_of(t2p)
        sm = side_of(t1m) + side_of(t2m)
        pick_p = torch.where(side_sign * sp > 0, True,
                             torch.where(side_sign * sm > 0, False,
                                         dth_p <= dth_m))
    t1 = tuple(torch.where(pick_p, p, m) for p, m in zip(t1p, t1m))
    t2 = tuple(torch.where(pick_p, p, m) for p, m in zip(t2p, t2m))
    arc = r * torch.where(pick_p, dth_p, dth_m)
    return active, t1, t2, ta, arc, tb


def _in_plane(O, xh, yh, t):
    return O + xh * t[0][..., None] + yh * t[1][..., None]


def _wrap_sphere(P, Q, O, r, S):
    """Wrap the P -> Q segment around a sphere (center O, radius r),
    sidesite world position S or None. Returns (active, T1, T2, L) with
    T1/T2 the world tangent points (material points of the wrap body)."""
    a = P - O
    b = Q - O
    # plane basis: x along a, y completing in the (a, b) plane
    xh, la = _normalize(a)
    b_x = _dot(b, xh)
    y0 = b - xh * b_x[..., None]
    # a, b collinear: any perpendicular to x
    ny0 = torch.sqrt(torch.clamp(_dot(y0, y0), min=0.0))
    ex = torch.zeros_like(xh)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(xh)
    ey[..., 1] = 1.0
    fb1, fb2 = cross(xh, ex), cross(xh, ey)
    fallback = torch.where((_dot(fb1, fb1) < 1e-6)[..., None], fb2, fb1)
    y0 = torch.where((ny0 * ny0 > _EPS)[..., None], y0, fallback)
    yh, _ = _normalize(y0)
    ax_, ay_ = la, torch.zeros_like(la)
    bx_, by_ = b_x, _dot(b, yh)
    side = None
    if S is not None:
        s = S - O
        sx, sy = _dot(s, xh), _dot(s, yh)
        side = torch.sign((bx_ - ax_) * (sy - ay_) - (by_ - ay_) * (sx - ax_))
    active, t1, t2, ta, arc, tb = _wrap_2d(ax_, ay_, bx_, by_, r, side)
    return active, _in_plane(O, xh, yh, t1), _in_plane(O, xh, yh, t2), \
        ta + arc + tb


def _wrap_cylinder(P, Q, O, zh, r, S):
    """Wrap the P -> Q segment around an infinite cylinder (point O on the
    axis, unit world axis zh, radius r): tangent, helix, tangent; unrolled
    a straight line, so the axial coordinate varies linearly with the 2D
    path length (MuJoCo's construction)."""
    a3 = P - O
    b3 = Q - O
    az = _dot(a3, zh)
    bz = _dot(b3, zh)
    aperp = a3 - zh * az[..., None]
    bperp = b3 - zh * bz[..., None]
    xh, la = _normalize(aperp)
    yh = cross(zh, xh)
    ax_, ay_ = la, torch.zeros_like(la)
    bx_, by_ = _dot(bperp, xh), _dot(bperp, yh)
    side = None
    if S is not None:
        s3 = S - O
        sp = s3 - zh * _dot(s3, zh)[..., None]
        sx, sy = _dot(sp, xh), _dot(sp, yh)
        side = torch.sign((bx_ - ax_) * (sy - ay_) - (by_ - ay_) * (sx - ax_))
    active, t1, t2, ta, arc, tb = _wrap_2d(ax_, ay_, bx_, by_, r, side)
    # axial interpolation by the 2D path-length fraction
    total2d = torch.clamp(ta + arc + tb, min=_EPS)
    z1 = az + (bz - az) * ta / total2d
    z2 = az + (bz - az) * (ta + arc) / total2d
    T1 = _in_plane(O, xh, yh, t1) + zh * z1[..., None]
    T2 = _in_plane(O, xh, yh, t2) + zh * z2[..., None]
    dz = bz - az
    return active, T1, T2, torch.sqrt(total2d * total2d + dz * dz)


def _seg_jac(v_o, w_o, anc, b0, p0, b1, p1, u):
    """Moment row of a straight segment: for each dof k, u . (dp1/dq_k -
    dp0/dq_k), where dp/dq_k of a material point p on body b is anc[b, k]
    (v_o[k] + w_o[k] x p). Returns (..., D) or 0."""
    def side(b, p):
        if b < 0:
            return 0.0
        u_v = _dot(v_o, u[..., None, :])                      # (..., D)
        pxu_w = _dot(w_o, cross(p, u)[..., None, :])
        return anc[b] * (u_v + pxu_w)
    return side(b1, p1) - side(b0, p0)


def eval_spatial_tendons(paths: Sequence[SpatialTendonPath], body_q,
                         v_o=None, w_o=None, anc=None):
    """Lengths (and moment rows) of spatial tendons.

    Args:
        paths: static path descriptions (bodies index ``body_q``'s axis -2).
        body_q: body poses ``(..., B, 7)``.
        v_o, w_o: the world dof subspace ``(..., D, 3)``; None for lengths
            only.
        anc: ``(B, D)`` ancestor mask (float) of the bodies over the dofs.
    Returns:
        (lengths, jacs): per tendon ``(...)`` lengths and ``(..., D)``
        moment rows (jacs None without ``v_o``).
    """
    want_jac = v_o is not None
    lengths: List[torch.Tensor] = []
    jacs: Optional[List[torch.Tensor]] = [] if want_jac else None
    for path in paths:
        el = path.elems
        prev_body = el[0][1]
        prev_pt = _point_world(body_q, prev_body, el[0][2])
        L = torch.zeros_like(prev_pt[..., 0])
        J = 0.0
        i = 1
        while i < len(el):
            e = el[i]
            if e[0] == "site":
                pt = _point_world(body_q, e[1], e[2])
                seg = pt - prev_pt
                slen = _norm(seg)
                L = L + slen
                if want_jac:
                    J = J + _seg_jac(v_o, w_o, anc, prev_body, prev_pt,
                                     e[1], pt, seg / slen[..., None])
                prev_body, prev_pt = e[1], pt
                i += 1
                continue
            # a wrap element between the previous site and the next one
            nxt = el[i + 1]
            nbody = nxt[1]
            npt = _point_world(body_q, nbody, nxt[2])
            wbody = e[1]
            O = _point_world(body_q, wbody, e[2])
            if e[0] == "sphere":
                r, sloc = float(e[3]), e[4]
                S = None if sloc is None else _point_world(body_q, wbody, sloc)
                active, T1, T2, Lw = _wrap_sphere(prev_pt, npt, O, r, S)
            else:
                r, sloc = float(e[4]), e[5]
                zh = _axis_world(body_q, wbody, e[3])
                S = None if sloc is None else _point_world(body_q, wbody, sloc)
                active, T1, T2, Lw = _wrap_cylinder(prev_pt, npt, O, zh, r, S)
            seg = npt - prev_pt
            Ls = _norm(seg)
            L = L + torch.where(active, Lw, Ls)
            if want_jac:
                J_straight = _seg_jac(v_o, w_o, anc, prev_body, prev_pt,
                                      nbody, npt, seg / Ls[..., None])
                s1 = T1 - prev_pt
                s2 = npt - T2
                J_wrap = (_seg_jac(v_o, w_o, anc, prev_body, prev_pt, wbody,
                                   T1, s1 / _norm(s1)[..., None])
                          + _seg_jac(v_o, w_o, anc, wbody, T2, nbody, npt,
                                     s2 / _norm(s2)[..., None]))
                J = J + torch.where(active[..., None], J_wrap, J_straight)
            prev_body, prev_pt = nbody, npt
            i += 2
        lengths.append(L)
        if want_jac:
            if not isinstance(J, torch.Tensor):
                J = torch.zeros_like(v_o[..., 0])
            jacs.append(J)
    return lengths, jacs


def spatial_tendon_rest_length(path: SpatialTendonPath, body_q) -> float:
    """Path length at the build pose, on the host in float64 (the runtime's
    math)."""
    return float(spatial_tendon_rest_lengths([path], body_q)[0])


def spatial_tendon_rest_lengths(paths: Sequence[SpatialTendonPath],
                                body_q) -> np.ndarray:
    """The build-pose lengths of many paths (the default rest lengths at
    finalize), float64 on the host: paths that differ only in their
    bodies (the copies of a replicated world) are evaluated in one batched
    call over their bodies' poses."""
    bq = np.asarray([np.asarray(x, dtype=np.float64) for x in body_q])
    bq = bq.reshape(-1, 7)
    out = np.zeros(len(paths))
    groups = {}
    for k, p in enumerate(paths):
        bodies = sorted({int(e[1]) for e in p.elems if e[1] >= 0})
        local = {b: i for i, b in enumerate(bodies)}
        lp = p.remapped(lambda b: local[b])
        groups.setdefault(lp.key(), (lp, []))[1].append((k, bodies))
    for lp, items in groups.values():
        idx = np.asarray([b for _, b in items], dtype=np.int64)
        poses = bq[idx] if idx.size else np.tile(
            [0.0, 0, 0, 0, 0, 0, 1], (len(items), 1, 1))
        L, _ = eval_spatial_tendons([lp], torch.as_tensor(poses))
        out[[k for k, _ in items]] = L[0].numpy()
    return out
