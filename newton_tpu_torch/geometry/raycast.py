"""Closest-hit ray casts against a model's shapes (port of
``newton_tpu/geometry/raycast.py``).

``raycast_model`` finds, for each ray, the nearest shape. The JAX package
evaluates every (ray, shape) pair densely, an ``(R, S, 3)`` array that XLA
fuses; at a tiled camera's width (R = 4.19 M rays, S = 14,336 shapes) that
form would need terabytes, so the port splits the work:

- the analytic classes (plane; sphere and ellipsoid, both as a sphere of
  radius ``scale[0]``; box; capsule and cylinder, both as a capsule) go
  through ``closest_analytic``: on CUDA tensors the hand-written kernel
  ``raycast_closest_f32`` (``csrc/raycast.cu``, K1: one thread per ray,
  the shapes staged through shared memory, a running minimum with a
  strict ``<`` in ascending shape order), on CPU tensors its plain
  version, the JAX algorithm chunked over rays (a fixed budget of pairs
  per chunk; no ray's answer depends on the chunk);
- shapes with a dense SDF bake that are not BVH meshes (hulls, height
  fields, SDF shapes) are sphere-traced in PyTorch, 64 steps, as in JAX,
  over those shapes alone;
- MESH shapes go through their BVHs (``geometry/bvh.py``), all of them in
  one ``mesh_closest`` call (K2 on CUDA); each BVH is built once per
  distinct mesh and kept on it.

The candidates meet under JAX's ``argmin``: the least t wins, the lowest
shape index on a tie (the 1,024 coincident floor planes of a replicated
scene tie on every floor pixel). Types with no intersector (a cone, a
hull without a bake, sites, Gaussians) are never hit, as in JAX (ROADMAP
C.44). Nothing here reads a value back to the host.

Both versions of K1 do each floating-point operation in the same order,
rounded one by one (no fused multiply-add), so the kernel equals its
plain version bit for bit on the same inputs. At a miss the port returns
a zero normal (the JAX package returns shape 0's local normal rotated).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..math import (quat_rotate, quat_rotate_inv, quat_to_matrix,
                    transform_multiply)
from .bvh import BVHPool, MeshBVH, mesh_closest
from .types import GeoType

__all__ = ["ray_plane", "ray_sphere", "ray_box", "ray_capsule",
           "raycast_model", "closest_analytic", "closest_analytic_plain",
           "shape_classes", "shape_world_transforms", "cull_tables",
           "cull_box_pass", "CLASS_CODES", "PAIR_BUDGET", "CULL_GROUP",
           "CULL_FAN", "CULL_M0", "CULL_KAPPA", "CULL_ABS"]

_INF = 1e10
# K1's class codes: the intersector each GeoType takes (-1: none)
CLASS_CODES = {int(GeoType.PLANE): 0, int(GeoType.SPHERE): 1,
               int(GeoType.ELLIPSOID): 1, int(GeoType.BOX): 2,
               int(GeoType.CAPSULE): 3, int(GeoType.CYLINDER): 3}
# ray-shape pairs per chunk of the plain versions and the SDF trace
PAIR_BUDGET = 1 << 21
# K1's culling (csrc/raycast.cu's kCull* constants, held equal by a test):
# shapes a group, groups a top box, and the margin m0 + kr D + ka A of a
# box at distance bound D from a ray origin, kr = CULL_KAPPA + 1.5 sqrt(|
# |d|^2 - 1 |), A the largest absolute coordinate of the box and the
# origin
CULL_GROUP = 16
CULL_FAN = 16
CULL_M0 = 1e-3
CULL_KAPPA = 2e-3
CULL_ABS = 2.0 ** -20


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _unit(v, floor):
    return v / torch.clamp(torch.sqrt(_dot(v, v)), min=floor)[..., None]


def _t_plane(o, d):
    dz = d[..., 2]
    ok = dz.abs() > 1e-9
    t = -o[..., 2] / torch.where(ok, dz, 1e-9)
    return torch.where(ok & (t > 0), t, _INF)


def _t_sphere(o, d, r):
    b = _dot(o, d)
    c = _dot(o, o) - r * r
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    t = torch.where(t > 0, t, -b + sq)
    return torch.where((disc >= 0) & (t > 0), t, _INF)


def _t_box(o, d, half):
    inv = 1.0 / torch.where(d.abs() > 1e-9, d, 1e-9)
    t1 = (-half - o) * inv
    t2 = (half - o) * inv
    tmin = torch.minimum(t1, t2).amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    hit = tmax >= torch.clamp(tmin, min=0.0)
    t = torch.where(tmin > 0, tmin, tmax)
    return torch.where(hit & (t > 0), t, _INF)


def _t_capsule(o, d, r, h):
    a = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
    b = o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1]
    c = o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1] - r * r
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_cyl = (-b - sq) / torch.where(a > 1e-12, a, 1e-12)
    z = o[..., 2] + d[..., 2] * t_cyl
    ok = (disc >= 0) & (a > 1e-12) & (t_cyl > 0) & (z.abs() <= h)
    t = torch.where(ok, t_cyl, _INF)
    for sign in (1.0, -1.0):
        oz = o[..., 2] - sign * h
        bb = o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1] + oz * d[..., 2]
        cc = o[..., 0] * o[..., 0] + o[..., 1] * o[..., 1] + oz * oz - r * r
        dd = bb * bb - cc
        ts = -bb - torch.sqrt(torch.clamp(dd, min=0.0))
        t = torch.minimum(t, torch.where((dd >= 0) & (ts > 0), ts, _INF))
    return t


def _n_sphere(o, d, t):
    return _unit(o + d * t[..., None], 1e-9)


def _n_box(o, d, t, half):
    q = (o + d * t[..., None]) / torch.clamp(half, min=1e-9)
    ax = q.abs().argmax(-1)
    onehot = ax[..., None] == torch.arange(3, device=o.device)
    return onehot.to(o.dtype) * torch.sign(q)


def _n_capsule(o, d, t, h):
    p = o + d * t[..., None]
    zc = torch.minimum(torch.maximum(p[..., 2], -h), h)
    n = torch.stack([p[..., 0], p[..., 1], p[..., 2] - zc], -1)
    return _unit(n, 1e-9)


def _n_plane(o):
    zero = torch.zeros_like(o[..., 0])
    return torch.stack([zero, zero, torch.ones_like(zero)], -1)


def ray_plane(o, d):
    """Ray against the z = 0 plane, local frame: (t, n), t = 1e10 on a
    miss."""
    return _t_plane(o, d), _n_plane(o)


def ray_sphere(o, d, r):
    t = _t_sphere(o, d, r)
    return t, _n_sphere(o, d, t)


def ray_box(o, d, half):
    t = _t_box(o, d, half)
    return t, _n_box(o, d, t, half)


def ray_capsule(o, d, r, h):
    """Capsule along z, half-height h, radius r."""
    t = _t_capsule(o, d, r, h)
    return t, _n_capsule(o, d, t, h)


def shape_classes(model) -> np.ndarray:
    """K1's class code of each shape (S,) int32 (-1: none)."""
    types = np.asarray(model.structure.shape_type)
    return np.asarray([CLASS_CODES.get(int(t), -1) for t in types],
                      dtype=np.int32)


def _tables(model, device) -> dict:
    """The model's static index tensors on ``device``, made once and kept
    on its structure (a host-to-device copy per call would synchronize):
    each shape's body and staticness and class code, the SDF-traced
    shapes and their grids, the mesh shapes, their BVH indices and pool
    (one BVH per distinct mesh, built once and kept on the mesh)."""
    st = model.structure
    cache = st.__dict__.setdefault("_raycast_tables", {})
    tab = cache.get(device)
    if tab is not None:
        return tab
    sb = np.asarray(st.shape_body)
    types = np.asarray(st.shape_type)

    def dev(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    tab = dict(body_idx=dev(np.maximum(sb, 0), torch.long),
               static=dev(sb < 0, torch.bool)[:, None],
               cls=dev(shape_classes(model), torch.int32), mesh=None,
               sdf=None)
    sid = np.asarray(st.shape_source_id)
    mesh = [s for s in range(len(types)) if types[s] == int(GeoType.MESH)
            and len(sid) and sid[s] >= 0 and st.meshes]
    if mesh:
        mids = sorted({int(sid[s]) for s in mesh})
        bvhs, verts = [], []
        for mid in mids:
            m = st.meshes[mid]
            if getattr(m, "_torch_bvh", None) is None:
                m._torch_bvh = MeshBVH(m.vertices, m.indices)
            bvhs.append(m._torch_bvh)
            verts.append(np.asarray(m.vertices, dtype=np.float32))
        tab["mesh"] = (dev(mesh, torch.long),
                       dev([mids.index(int(sid[s])) for s in mesh],
                           torch.int32), BVHPool(bvhs, verts, device))
    sdf_id = np.asarray(st.shape_sdf_id)
    sdf = [s for s in np.nonzero(sdf_id >= 0)[0].tolist()
           if s not in mesh] if len(sdf_id) and model.sdf_grids.shape[0] \
        else []
    if sdf:
        tab["sdf"] = (dev(sdf, torch.long), dev(sdf_id[sdf], torch.long))
    cache[device] = tab
    return tab


def shape_world_transforms(model, state) -> torch.Tensor:
    """(S, 7) world transforms of the shapes: body pose times the shape's
    local transform, the identity for static shapes."""
    if not model.structure.body_count:
        return model.shape_transform
    tab = _tables(model, state.body_q.device)
    # made on the device: an indexed store of a host scalar synchronizes
    q = state.body_q
    identity = torch.cat([q.new_zeros(6), q.new_ones(1)])
    X_body = torch.where(tab["static"], identity,
                         state.body_q[tab["body_idx"]])
    return transform_multiply(X_body, model.shape_transform)


def _local(X, o, d):
    """Rays (R, 3) into the frames of transforms X (S, 7): (R, S, 3)."""
    q = X[None, :, 3:7]
    o_loc = quat_rotate_inv(q, o[:, None, :] - X[None, :, 0:3])
    d_loc = quat_rotate_inv(q, d[:, None, :].expand_as(o_loc))
    return o_loc, d_loc


def _class_normal(o, d, t, scale, cls):
    """The local normal at t of each ray's own shape (R,) class."""
    n = _n_plane(o)
    n = torch.where((cls == 1)[:, None], _n_sphere(o, d, t), n)
    n = torch.where((cls == 2)[:, None], _n_box(o, d, t, scale), n)
    return torch.where((cls == 3)[:, None],
                       _n_capsule(o, d, t, scale[:, 1]), n)


def closest_analytic_plain(o, d, X, scale, cls, max_dist: float):
    """Plain version of ``closest_analytic``: every (ray, shape) pair of
    a chunk of rays, as the JAX package computes them, then the first
    minimum over shapes and the winner's normal."""
    R, S = o.shape[0], X.shape[0]
    t_out = torch.full((R,), _INF, dtype=o.dtype, device=o.device)
    s_out = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    n_out = torch.zeros((R, 3), dtype=o.dtype, device=o.device)
    if S == 0 or R == 0:
        return t_out, s_out, n_out
    step = max(1, PAIR_BUDGET // S)
    r0, h0 = scale[None, :, 0], scale[None, :, 1]
    c = cls[None, :]
    for a in range(0, R, step):
        oc, dc = o[a:a + step], d[a:a + step]
        o_loc, d_loc = _local(X, oc, dc)
        t = torch.where(c == 0, _t_plane(o_loc, d_loc), _INF)
        t = torch.where(c == 1, _t_sphere(o_loc, d_loc, r0), t)
        t = torch.where(c == 2, _t_box(o_loc, d_loc, scale[None]), t)
        t = torch.where(c == 3, _t_capsule(o_loc, d_loc, r0, h0), t)
        best = t.argmin(1)
        tb = t.gather(1, best[:, None])[:, 0]
        hit = (tb <= max_dist) & (tb < _INF)
        ar = torch.arange(oc.shape[0], device=o.device)
        ob, db = o_loc[ar, best], d_loc[ar, best]
        n = _class_normal(ob, db, tb, scale[best], cls[best])
        n = quat_rotate(X[best, 3:7], n)
        t_out[a:a + step] = torch.where(hit, tb, _INF)
        s_out[a:a + step] = torch.where(hit, best.to(torch.int32), -1)
        n_out[a:a + step] = torch.where(hit[:, None], n, 0.0)
    return t_out, s_out, n_out


def _part1by2(x):
    """The 10 low bits of x spread to every third bit (a Morton code's
    component)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def cull_tables(X, scale, cls) -> dict:
    """K1's pre-pass, on the shapes' device with no host sync: ``order``
    (S,) int32, the finite shapes (classes 1-3) in Morton order of their
    centres (stable: index order on a tie), then the planes kept, then the
    rest; ``counts`` (2,) int32, (finite shapes, planes kept); ``gbox``
    (ceil(S / CULL_GROUP), 6) the world box (lo, hi) of each run of
    CULL_GROUP finite shapes in that order (rows past the finite shapes
    are empty: lo = inf, hi = -inf); ``tbox`` the boxes of runs of
    CULL_FAN groups.
    A shape's box: a sphere p +- r, a capsule p +- (|axis| h + r), a box p
    +- |R| h; unbounded where its transform or scale is not finite or its
    quaternion is off unit length by more than 1e-5. Of the planes with
    no rotation (q.xyz == 0) and one height, only the lowest index is
    kept: a ray meets them all at the same t, bit for bit."""
    S, group, fan = X.shape[0], CULL_GROUP, CULL_FAN
    dev = X.device
    inf = X.new_full((), float("inf"))       # made on the device: no sync
    if S == 0:
        empty = torch.stack([inf, inf, inf, -inf, -inf, -inf])[None]
        return dict(order=torch.zeros(0, dtype=torch.int32, device=dev),
                    counts=torch.zeros(2, dtype=torch.int32, device=dev),
                    gbox=empty, tbox=empty)
    cls = cls.to(torch.int64)
    p, q = X[:, 0:3], X[:, 3:7]
    sc = scale.abs()
    finite = (cls >= 1) & (cls <= 3)
    plane = cls == 0
    # planes: one of each level height
    level = plane & (q[:, 0:3] == 0).all(1)
    z = torch.where(level, p[:, 2], torch.nan)
    zs, perm = torch.sort(z, stable=True)
    first = torch.ones(S, dtype=torch.bool, device=dev)
    first[1:] = zs[1:] != zs[:-1]
    dup = torch.zeros(S, dtype=torch.bool, device=dev)
    dup[perm] = ~first
    kept = plane & ~(level & dup)
    # world half extents
    qn = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    Rm = quat_to_matrix(qn)
    r = sc[:, 0:1]
    he = torch.where((cls == 1)[:, None], r.expand(S, 3), 0.0)
    he = torch.where((cls == 3)[:, None],
                     Rm[:, :, 2].abs() * sc[:, 1:2] + r, he)
    he = torch.where((cls == 2)[:, None],
                     (Rm.abs() * sc[:, None, :]).sum(2), he)
    ok = (torch.isfinite(X).all(1) & torch.isfinite(scale).all(1)
          & ((q * q).sum(1) - 1.0).abs().le(1e-5))
    lo = torch.where(ok[:, None], p - he, -inf)
    hi = torch.where(ok[:, None], p + he, inf)
    # the order: finite shapes by Morton code, kept planes, the rest
    use = (finite & ok)[:, None]
    c_lo = torch.where(use, p, inf).amin(0)
    c_hi = torch.where(use, p, -inf).amax(0)
    cell = (p - c_lo) / torch.clamp(c_hi - c_lo, min=1e-6) * 1023.0
    cell = torch.where(use, cell, 0.0).clamp(0.0, 1023.0).to(torch.int64)
    m = _part1by2(cell)
    code = m[:, 0] | (m[:, 1] << 1) | (m[:, 2] << 2)
    bucket = torch.where(finite, 0, torch.where(kept, 1, 2))
    order = torch.sort(bucket * (1 << 30) + torch.where(finite, code, 0),
                       stable=True)[1]
    counts = torch.stack([finite.sum(), kept.sum()]).to(torch.int32)
    # group and top boxes over the sorted finite shapes
    n_grp = max(1, -(-S // group))
    pad = n_grp * group - S
    valid = (torch.arange(n_grp * group, device=dev) < counts[0])[:, None]
    glo = torch.where(valid, torch.cat([lo[order], inf.expand(pad, 3)]), inf)
    ghi = torch.where(valid, torch.cat([hi[order], (-inf).expand(pad, 3)]),
                      -inf)
    glo = glo.reshape(n_grp, group, 3).amin(1)
    ghi = ghi.reshape(n_grp, group, 3).amax(1)
    n_top = -(-n_grp // fan)
    pad = n_top * fan - n_grp
    tlo = torch.cat([glo, inf.expand(pad, 3)]).reshape(n_top, fan, 3)
    thi = torch.cat([ghi, (-inf).expand(pad, 3)]).reshape(n_top, fan, 3)
    return dict(order=order.to(torch.int32), counts=counts,
                gbox=torch.cat([glo, ghi], 1).contiguous(),
                tbox=torch.cat([tlo.amin(1), thi.amax(1)], 1).contiguous())


def cull_box_pass(o, d, box, t_lim):
    """Plain version of K1's culling test (csrc/raycast.cu: box_pass), the
    same rounded operations: does each ray (o, d (N, 3)) enter its box
    ((N, 6): lo, hi) grown by CULL_M0 + kr D + CULL_ABS A at an entry t
    <= t_lim (N,)?"""
    one = torch.ones((), dtype=o.dtype, device=o.device)
    small = ~(d.abs() > 1e-9)
    inv = one / torch.where(small, one, d)
    dd = _dot(d, d)
    kr = CULL_KAPPA + 1.5 * torch.sqrt((dd - 1.0).abs())
    lo, hi = box[:, 0:3], box[:, 3:6]
    a = torch.fmax((o - lo).abs(), (o - hi).abs())
    D = (a[:, 0] + a[:, 1]) + a[:, 2]
    A = torch.fmax(o.abs(), torch.fmax(lo.abs(), hi.abs()))
    A = torch.fmax(torch.fmax(A[:, 0], A[:, 1]), A[:, 2])
    m = ((CULL_M0 + kr * D) + CULL_ABS * A)[:, None]
    lg, hg = lo - m, hi + m
    x, y = (lg - o) * inv, (hg - o) * inv
    inside = (o >= lg) & (o <= hg)
    gap = torch.fmin((lg - o).abs(), (hg - o).abs()) * 0.999e9
    ninf = torch.full_like(x, float("-inf"))
    a = torch.where(small, torch.where(inside, ninf, gap), torch.fmin(x, y))
    c = torch.where(small, -ninf, torch.fmax(x, y))
    tmin = torch.fmax(torch.fmax(torch.fmax(ninf[:, 0], a[:, 0]), a[:, 1]),
                      a[:, 2])
    tmax = torch.fmin(torch.fmin(torch.fmin(-ninf[:, 0], c[:, 0]), c[:, 1]),
                      c[:, 2])
    return (tmax >= torch.fmax(tmin, torch.zeros_like(tmin))) \
        & (tmin <= t_lim)


def closest_analytic(o, d, X, scale, cls, max_dist: float = 1e6,
                     stats=None, cull=None):
    """Closest analytic hit of rays o, d (R, 3) among shapes with world
    transforms X (S, 7), scales (S, 3) and class codes ``cls`` (S,) int32
    (``CLASS_CODES``; -1 never hit): (t (R,), shape (R,) int32, world
    normal (R, 3)); t = 1e10, shape -1 and a zero normal where nothing
    lies within ``max_dist``. CUDA tensors go to the kernel (K1, after
    ``cull_tables``) or raise; CPU tensors to the plain version.
    ``cull``: ``cull_tables(X, scale, cls)`` where the caller has them.
    ``closest_analytic.launches`` counts kernel launches; ``stats`` (a
    dict, CUDA only) gets the kernel's box tests, boxes opened and pairs
    evaluated of each class (plane, sphere, box, capsule), each counted
    once per live ray of the warp that did it, and the same counted per
    ray where that ray's own test passed (``ray_*``: every top box, the
    groups of the top boxes it passes, the pairs of the groups it passes);
    read back: a host sync."""
    if o.dtype != torch.float32:
        raise TypeError("closest_analytic takes float32 tensors")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"rays must be (R, 3), got {tuple(o.shape)} and "
                         f"{tuple(d.shape)}")
    S = X.shape[0]
    if X.shape != (S, 7) or scale.shape != (S, 3) or cls.shape != (S,):
        raise ValueError("shapes must be X (S, 7), scale (S, 3), cls (S,)")
    if o.device.type == "cpu":
        return closest_analytic_plain(o, d, X, scale, cls, max_dist)
    if o.device.type != "cuda":
        raise ValueError(f"closest_analytic: unsupported device {o.device}")
    from .. import _kernels
    _kernels.refuse_grad("closest_analytic (K1)", o, d, X, scale)
    R = o.shape[0]
    o, d, X, scale = (x.contiguous().to(torch.float32)
                      for x in (o, d, X, scale))
    cls = cls.to(torch.int32).contiguous()
    tab = cull_tables(X, scale, cls) if cull is None else cull
    t = torch.empty(R, dtype=torch.float32, device=o.device)
    s = torch.empty(R, dtype=torch.int32, device=o.device)
    n = torch.empty((R, 3), dtype=torch.float32, device=o.device)
    cnt = (torch.zeros(12, dtype=torch.int64, device=o.device)
           if stats is not None else None)
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().raycast_closest_f32(
            o.data_ptr(), d.data_ptr(), R, X.data_ptr(), scale.data_ptr(),
            cls.data_ptr(), tab["order"].data_ptr(),
            tab["counts"].data_ptr(), tab["gbox"].data_ptr(),
            tab["tbox"].data_ptr(), float(max_dist), t.data_ptr(),
            s.data_ptr(),
            n.data_ptr(), None if cnt is None else cnt.data_ptr(), stream)
    closest_analytic.launches += 1
    _kernels.check(err, "closest_analytic")
    if stats is not None:
        c = cnt.tolist()
        stats.update(box_tests=c[0], boxes_opened=c[1],
                     pairs=tuple(c[2:6]), ray_box_tests=c[6],
                     ray_boxes_passed=c[7], ray_pairs=tuple(c[8:12]),
                     planes_kept=int(tab["counts"][1]),
                     finite_shapes=int(tab["counts"][0]),
                     groups=int(tab["gbox"].shape[0]),
                     tops=int(tab["tbox"].shape[0]))
    return t, s, n


closest_analytic.launches = 0


def _sdf_candidates(model, X, o, d, sel, sid):
    """Sphere-trace the baked grids ``sid`` (n,) of shapes ``sel`` (n,), 64
    steps from each ray's entry into the grid's box: t (R, n) and local
    normals (R, n, 3)."""
    from .sdf import sample_sdf_grad, sample_sdf_grid
    lo, hi = model.sdf_lower[sid], model.sdf_upper[sid]
    Xs = X[sel]
    ts, ns = [], []
    step = max(1, PAIR_BUDGET // sel.shape[0])
    for a in range(0, o.shape[0], step):
        o_loc, d_loc = _local(Xs, o[a:a + step], d[a:a + step])
        dd = torch.where(d_loc.abs() > 1e-9, d_loc, 1e-9)
        t0b, t1b = (lo - o_loc) / dd, (hi - o_loc) / dd
        t_near = torch.minimum(t0b, t1b).amax(-1)
        t_far = torch.maximum(t0b, t1b).amin(-1)
        t_m = torch.clamp(t_near, min=0.0)
        hit = torch.zeros_like(t_m, dtype=torch.bool)
        gid = sid.expand_as(t_m)
        for _ in range(64):
            p = o_loc + d_loc * t_m[..., None]
            dist = sample_sdf_grid(model.sdf_grids, lo, hi, p, gid=gid)
            hit = hit | (dist < 1e-3)
            t_m = torch.where(hit, t_m, t_m + torch.clamp(dist, min=1e-3))
        miss = (~hit) | (t_m > t_far) | (t_far < 0.0)
        ts.append(torch.where(miss, _INF, t_m))
        g = sample_sdf_grad(model.sdf_grids, lo, hi,
                            o_loc + d_loc * t_m[..., None], gid=gid)
        ns.append(_unit(g, 1e-9))
    return torch.cat(ts, 0), torch.cat(ns, 0)


def raycast_model(model, state, origins: torch.Tensor, dirs: torch.Tensor,
                  max_dist: float = 1e6, cache=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest hit of each ray (R, 3) against the model's shapes: (t (R,),
    shape index (R,) int32, -1 on a miss, world normal (R, 3)). Used by
    viewer picking and the tiled camera. ``cache`` (a dict): the shapes'
    world transforms and, on CUDA, K1's cull tables of this ``state``,
    kept there for another call on the same state (a render's shadow
    rays)."""
    cache = {} if cache is None else cache
    if "X" not in cache:
        cache["X"] = shape_world_transforms(model, state)
    X = cache["X"]
    tab = _tables(model, X.device)
    if X.is_cuda and "cull" not in cache:
        cache["cull"] = cull_tables(X, model.shape_scale, tab["cls"])
    t, shape, nrm = closest_analytic(origins, dirs, X, model.shape_scale,
                                     tab["cls"], max_dist,
                                     cull=cache.get("cull"))
    if tab["mesh"] is None and tab["sdf"] is None:
        return t, shape, nrm
    # JAX's argmin over the candidates: the least t, then the lowest index
    cands = []
    if tab["sdf"] is not None:
        sel, sid = tab["sdf"]
        cands.append((sel, *_sdf_candidates(model, X, origins, dirs, sel,
                                            sid)))
    if tab["mesh"] is not None:
        sel, bvh_of, pool = tab["mesh"]
        tm, nm = mesh_closest(pool, origins, dirs, bvh_of, X[sel],
                              model.shape_scale[sel])
        cands.append((sel, tm.T, nm.transpose(0, 1)))
    ts, ns = [t[:, None]], [nrm[:, None]]
    idx = [torch.where(shape >= 0, shape, 1 << 30)[:, None]]
    for sel, tc, nc in cands:
        ts.append(tc)
        idx.append(sel.to(torch.int32).expand_as(tc))
        ns.append(quat_rotate(X[sel, 3:7][None], nc))
    T = torch.cat(ts, 1)
    T = torch.where(T <= max_dist, T, _INF)
    index = torch.cat(idx, 1)
    t_best = T.amin(1)
    at_min = T == t_best[:, None]
    best = torch.where(at_min, index, 1 << 30).amin(1)
    col = (at_min & (index == best[:, None])).to(torch.int32).argmax(1)
    hit = t_best < _INF
    n = torch.cat(ns, 1)[torch.arange(T.shape[0], device=T.device), col]
    return (t_best, torch.where(hit, best, -1).to(torch.int32),
            torch.where(hit[:, None], n, 0.0))
