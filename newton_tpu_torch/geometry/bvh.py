"""Triangle-mesh BVH: host build, device refit, closest-hit traversal
(port of ``newton_tpu/geometry/bvh.py``).

The build is the JAX package's, in numpy, so its arrays are equal bit for
bit: a median split over triangle centroids into a complete binary
layout (children of node i at 2i + 1 and 2i + 2), leaves at level
``depth - 1`` holding at most ``leaf_budget`` triangles (padded with the
first triangle, masked by ``leaf_mask``). ``refit`` recomputes the node
boxes bottom-up on the device for deformed vertices.

Traversal keeps the JAX walk: pop the top of a stack, test the node's box
(the slab test, ``tmin < t_best``), test a leaf's triangles
(Moller-Trumbore, the first minimum of the leaf, taken where strictly
below the best so far), push ``2i + 1`` then ``2i + 2`` for a hit
interior node. ``mesh_closest`` runs it for many (ray, mesh shape) pairs
at once over a ``BVHPool`` (every distinct mesh's arrays concatenated):
on CUDA tensors through the hand-written kernel ``raycast_mesh_f32``
(``csrc/raycast.cu``, K2), on CPU tensors through its plain version, a
batched stack walk over the pairs still active. The JAX package walks
each ray in a ``lax.while_loop``; an eager walk would read a flag back
to the host at every node, so the card runs the walk in one kernel. Both
versions do each floating-point operation in the same order (products
and sums rounded one by one, no fused multiply-add), so they agree bit
for bit. The kernel walks the same order without a stack (after a miss
or a leaf: climb while the node is a left child, then take the left
sibling) over the pool's packed boxes and leaf slots (``BVHPool.boxes``,
``slots``, ``counts``), each warp testing its lanes' leaves together.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..math import quat_rotate_inv

__all__ = ["MeshBVH", "BVHPool", "ray_triangles", "mesh_closest",
           "mesh_closest_plain", "MAX_STACK"]

_INF = 1e10
MAX_STACK = 64          # depth <= 31: the kernel's node indices are int32


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] \
        + a[..., 2] * b[..., 2]


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def ray_triangles(o, d, v0, v1, v2):
    """Moller-Trumbore: rays (..., 3) against triangles (..., 3),
    broadcasting. Returns (t, n): t = 1e10 on a miss, n the unit face
    normal turned against the ray."""
    e1 = v1 - v0
    e2 = v2 - v0
    p = _cross(d, e2)
    det = _dot(e1, p)
    ok = det.abs() > 1e-12
    inv = 1.0 / torch.where(ok, det, 1e-12)
    s = o - v0
    u = _dot(s, p) * inv
    q = _cross(s, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
    n = _cross(e1, e2)
    n = n / torch.clamp(torch.sqrt(_dot(n, n)), min=1e-12)[..., None]
    n = torch.where((_dot(n, d) > 0)[..., None], -n, n)
    return torch.where(hit, t, _INF), n


class MeshBVH:
    """Complete-binary-layout BVH over one triangle mesh.

    Attributes: ``depth`` (leaves at level depth - 1), ``lo``/``hi``
    (n_nodes, 3) float32 node boxes, ``leaf_tris`` (n_leaves, K, 3) int32
    numpy vertex indices, ``leaf_mask`` (n_leaves, K) bool, ``leaf_budget``
    K, ``n_leaves``, ``n_nodes``; tensors on ``device`` (the CPU by
    default)."""

    def __init__(self, vertices: np.ndarray, indices: np.ndarray,
                 leaf_size: int = 4, max_depth: int = 12, device="cpu"):
        verts = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
        tris = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
        T = len(tris)
        cent = verts[tris].mean(axis=1)

        depth = 1
        while (1 << (depth - 1)) * leaf_size < T and depth < max_depth:
            depth += 1
        n_leaves = 1 << (depth - 1)
        self.depth = depth
        buckets: List[Optional[np.ndarray]] = [None] * n_leaves

        def split(ids, node, level):
            if level == depth - 1:
                buckets[node - (n_leaves - 1)] = ids
                return
            if len(ids) == 0:
                split(ids, 2 * node + 1, level + 1)
                split(ids, 2 * node + 2, level + 1)
                return
            c = cent[ids]
            axis = int(np.argmax(c.max(0) - c.min(0)))
            order = np.argsort(c[:, axis], kind="stable")
            half = (len(ids) + 1) // 2
            split(ids[order[:half]], 2 * node + 1, level + 1)
            split(ids[order[half:]], 2 * node + 2, level + 1)

        split(np.arange(T), 0, 0)
        K = max(1, max(len(b) for b in buckets))
        leaf_tris = np.zeros((n_leaves, K, 3), dtype=np.int32)
        leaf_mask = np.zeros((n_leaves, K), dtype=bool)
        for li, ids in enumerate(buckets):
            leaf_tris[li, :len(ids)] = tris[ids]
            leaf_mask[li, :len(ids)] = True
            if len(ids) == 0:
                leaf_tris[li] = tris[0] if T else 0
        self.leaf_budget = K
        self.leaf_tris = leaf_tris
        self.leaf_mask = torch.as_tensor(leaf_mask, device=device)
        self.n_leaves = n_leaves
        self.n_nodes = (1 << depth) - 1
        lo, hi = self._bounds_np(verts, leaf_tris, leaf_mask)
        self.lo = torch.as_tensor(lo.astype(np.float32), device=device)
        self.hi = torch.as_tensor(hi.astype(np.float32), device=device)

    def _bounds_np(self, verts, leaf_tris, leaf_mask):
        n_nodes, n_leaves = self.n_nodes, self.n_leaves
        lo = np.full((n_nodes, 3), np.inf)
        hi = np.full((n_nodes, 3), -np.inf)
        pts = verts[leaf_tris]                       # (L, K, 3, 3)
        m = leaf_mask[..., None, None]
        lo[n_leaves - 1:] = np.where(m, pts, np.inf).reshape(
            n_leaves, -1, 3).min(1)
        hi[n_leaves - 1:] = np.where(m, pts, -np.inf).reshape(
            n_leaves, -1, 3).max(1)
        for i in range(n_leaves - 2, -1, -1):
            lo[i] = np.minimum(lo[2 * i + 1], lo[2 * i + 2])
            hi[i] = np.maximum(hi[2 * i + 1], hi[2 * i + 2])
        return lo, hi

    def refit(self, vertices: torch.Tensor) -> "MeshBVH":
        """A shallow copy whose node boxes bound ``vertices`` (V, 3) (the
        topology kept), computed on the vertices' device level by level."""
        n_leaves = self.n_leaves
        tris = torch.as_tensor(self.leaf_tris, dtype=torch.long,
                               device=vertices.device)
        pts = vertices[tris]                         # (L, K, 3, 3)
        m = self.leaf_mask.to(vertices.device)[..., None, None]
        cur_lo = torch.where(m, pts, torch.inf).reshape(
            n_leaves, -1, 3).amin(1)
        cur_hi = torch.where(m, pts, -torch.inf).reshape(
            n_leaves, -1, 3).amax(1)
        los, his = [cur_lo], [cur_hi]
        n = n_leaves
        while n > 1:
            n //= 2
            cur_lo = torch.minimum(cur_lo[0::2], cur_lo[1::2])
            cur_hi = torch.maximum(cur_hi[0::2], cur_hi[1::2])
            los.append(cur_lo)
            his.append(cur_hi)
        out = object.__new__(MeshBVH)
        out.__dict__.update(self.__dict__)
        out.lo = torch.cat(list(reversed(los)), 0)
        out.hi = torch.cat(list(reversed(his)), 0)
        return out

    def raycast(self, vertices: torch.Tensor, o: torch.Tensor,
                d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Closest hit of rays (R, 3) given in the mesh's frame: (t (R,),
        n (R, 3)), t = 1e10 on a miss. CUDA tensors take the kernel."""
        pool = BVHPool([self], [vertices], o.device)
        t, n = mesh_closest(pool, o, d, torch.zeros(1, dtype=torch.int32,
                                                    device=o.device))
        return t[0], n[0]


class BVHPool:
    """BVHs and their meshes' vertices concatenated for one traversal
    launch: node boxes (N, 3), leaf triangles (L, K, 3) int32 into the
    pooled vertices (V, 3) float32 (a BVH with a smaller budget padded and
    masked), the leaf masks (L, K) uint8, and per BVH (node offset, leaf
    offset, leaf count, depth) int32. The kernel reads them packed, made
    once here: ``boxes`` (N, 8) float32 (lo, 0, hi, 0), ``slots`` (L K, 12)
    float32 (each slot's v0, e1 = v1 - v0, e2 = v2 - v0, rounded as the
    walk rounds them, then three zeros) and ``counts`` (L,) int32, the
    valid slots of each leaf (every mask is a prefix)."""

    def __init__(self, bvhs: Sequence[MeshBVH], vertices: Sequence,
                 device):
        device = torch.device(device)
        K = max(b.leaf_budget for b in bvhs)
        tris, masks, params = [], [], []
        v_off = n_off = l_off = 0
        for b, v in zip(bvhs, vertices):
            lt = np.zeros((b.n_leaves, K, 3), dtype=np.int32)
            lt[:, :b.leaf_budget] = b.leaf_tris + v_off
            lm = np.zeros((b.n_leaves, K), dtype=np.uint8)
            lm[:, :b.leaf_budget] = b.leaf_mask.cpu().numpy()
            tris.append(lt)
            masks.append(lm)
            params.append((n_off, l_off, b.n_leaves, b.depth))
            v_off += len(v)
            n_off += b.n_nodes
            l_off += b.n_leaves
            if 2 * b.depth + 2 > MAX_STACK:
                raise ValueError(f"BVH depth {b.depth} exceeds the "
                                 f"traversal stack ({MAX_STACK})")
        self.leaf_budget = K
        self.max_stack = 2 * max(b.depth for b in bvhs) + 2
        self.lo = torch.cat([b.lo.to(device) for b in bvhs], 0).contiguous()
        self.hi = torch.cat([b.hi.to(device) for b in bvhs], 0).contiguous()
        self.tris = torch.as_tensor(np.concatenate(tris), device=device)
        self.mask = torch.as_tensor(np.concatenate(masks), device=device)
        self.verts = torch.cat([torch.as_tensor(v, dtype=torch.float32)
                                .to(device).reshape(-1, 3)
                                for v in vertices], 0).contiguous()
        self.params = torch.as_tensor(np.asarray(params, dtype=np.int32),
                                      device=device)
        self.params_np = np.asarray(params, dtype=np.int64)
        mask = np.concatenate(masks).astype(bool)
        counts = mask.sum(1)
        if not np.array_equal(mask, np.arange(K) < counts[:, None]):
            raise ValueError("BVHPool: a leaf mask is not a prefix")
        self.counts = torch.as_tensor(counts.astype(np.int32), device=device)
        zero = torch.zeros_like(self.lo[:, :1])
        self.boxes = torch.cat([self.lo, zero, self.hi, zero], 1)
        p = (self.verts[self.tris.long()] if len(self.verts) else
             torch.zeros(self.tris.shape + (3,), device=device)
             ).reshape(-1, 3, 3)                             # (L K, 3, 3)
        self.slots = torch.cat([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0],
                                torch.zeros_like(p[:, 0])], 1).contiguous()


def _local_rays(o, d, xform, scale):
    """World rays (R, 3) into each shape's frame, divided by its scale:
    (M, R, 3) origins and directions (the rays themselves where
    ``xform`` is None)."""
    if xform is None:
        return o[None], d[None]
    q, p = xform[:, None, 3:7], xform[:, None, 0:3]
    o_loc = quat_rotate_inv(q, o[None] - p)
    d_loc = quat_rotate_inv(q, d[None].expand_as(o_loc))
    if scale is not None:
        sc = torch.clamp(scale, min=1e-9)[:, None, :]
        o_loc, d_loc = o_loc / sc, d_loc / sc
    return o_loc, d_loc


def mesh_closest_plain(pool: BVHPool, o, d, bvh_of, xform=None,
                       scale=None, stats=None, trace=None):
    """Plain version of ``mesh_closest``: the batched stack walk. Pair
    (m, r) runs ray r in shape m's frame (``xform`` (M, 7) world
    transforms, ``scale`` (M, 3), both None for rays given in the mesh's
    frame) through BVH ``bvh_of[m]``. Returns t (M, R) and the local
    normal (M, R, 3) (divided by the scale and renormalized where
    ``scale`` is given). ``stats`` (a dict) gets the nodes visited and the
    triangles tested; ``trace`` (a list) gets each step's (pairs, nodes
    popped), the pairs as m R + r."""
    M = bvh_of.shape[0]
    o_loc, d_loc = _local_rays(o, d, xform, scale)
    R = o.shape[0]
    o_q = o_loc.expand(M, R, 3).reshape(-1, 3)
    d_q = d_loc.expand(M, R, 3).reshape(-1, 3)
    Q = M * R
    dev = o.device
    b_q = bvh_of.long().repeat_interleave(R)
    prm = pool.params.long()
    node_off, leaf_off = prm[b_q, 0], prm[b_q, 1]
    leaf_base = prm[b_q, 2] - 1
    inv = 1.0 / torch.where(d_q.abs() > 1e-9, d_q, 1e-9)
    stack = torch.zeros((Q, pool.max_stack), dtype=torch.long, device=dev)
    sp = torch.ones(Q, dtype=torch.long, device=dev)
    t_best = torch.full((Q,), _INF, dtype=o.dtype, device=dev)
    n_best = torch.zeros((Q, 3), dtype=o.dtype, device=dev)
    nodes = tris_tested = 0
    idx = torch.arange(Q, device=dev)
    while idx.numel():
        sp_a = sp[idx] - 1
        node = stack[idx, sp_a]
        sp[idx] = sp_a
        if trace is not None:
            trace.append((idx.clone(), node.clone()))
        g = node_off[idx] + node
        o1, inv1, tb = o_q[idx], inv[idx], t_best[idx]
        t1 = (pool.lo[g] - o1) * inv1
        t2 = (pool.hi[g] - o1) * inv1
        tmin = torch.minimum(t1, t2).amax(-1)
        tmax = torch.maximum(t1, t2).amin(-1)
        hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < tb)
        leaf = node >= leaf_base[idx]
        nodes += idx.numel()
        lf = torch.nonzero(hit & leaf).squeeze(1)
        if lf.numel():
            q = idx[lf]
            gl = leaf_off[q] + node[lf] - leaf_base[q]
            tv = pool.verts[pool.tris[gl].long()]          # (n, K, 3, 3)
            t_tri, n_tri = ray_triangles(o_q[q][:, None], d_q[q][:, None],
                                         tv[:, :, 0], tv[:, :, 1],
                                         tv[:, :, 2])
            valid = pool.mask[gl].bool()
            tris_tested += int(valid.sum())
            t_tri = torch.where(valid, t_tri, _INF)
            k = t_tri.argmin(1)
            tk = t_tri.gather(1, k[:, None])[:, 0]
            better = tk < t_best[q]
            qb = q[better]
            t_best[qb] = tk[better]
            n_best[qb] = n_tri[better, k[better]]
        push = torch.nonzero(hit & ~leaf).squeeze(1)
        if push.numel():
            q, s0, nd = idx[push], sp_a[push], node[push]
            stack[q, s0] = 2 * nd + 1
            stack[q, s0 + 1] = 2 * nd + 2
            sp[q] = s0 + 2
        idx = idx[sp[idx] > 0]
    if stats is not None:
        stats.update(nodes=nodes, triangles=tris_tested)
    n = n_best.reshape(M, R, 3)
    if scale is not None:
        n = n / torch.clamp(scale, min=1e-9)[:, None, :]
        n = n / torch.clamp(torch.sqrt(_dot(n, n)), min=1e-9)[..., None]
    return t_best.reshape(M, R), n


def mesh_closest(pool: BVHPool, o, d, bvh_of, xform=None, scale=None,
                 stats=None):
    """Closest hit of every (mesh shape, ray) pair (see
    ``mesh_closest_plain``): t (M, R), local normal (M, R, 3). CUDA
    tensors go to the kernel (K2) or raise; CPU tensors to the plain
    version. ``mesh_closest.launches`` counts
    kernel launches."""
    if o.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError("mesh_closest takes float32 rays")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"rays must be (R, 3), got {tuple(o.shape)} and "
                         f"{tuple(d.shape)}")
    if o.device.type == "cpu":
        return mesh_closest_plain(pool, o, d, bvh_of, xform, scale, stats)
    if o.device.type != "cuda":
        raise ValueError(f"mesh_closest: unsupported device {o.device}")
    from .. import _kernels
    _kernels.refuse_grad("mesh_closest (K2)", o, d, xform, scale)
    M, R = bvh_of.shape[0], o.shape[0]
    t = torch.empty((M, R), dtype=o.dtype, device=o.device)
    n = torch.empty((M, R, 3), dtype=o.dtype, device=o.device)
    cnt = (torch.zeros(2, dtype=torch.int64, device=o.device)
           if stats is not None else None)
    args = [o.contiguous(), d.contiguous(), bvh_of.to(torch.int32)
            .contiguous()]
    xf = None if xform is None else xform.contiguous()
    sc = None if scale is None else scale.contiguous()

    def ptr(x):
        return None if x is None else x.data_ptr()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().raycast_mesh_f32(
            ptr(args[0]), ptr(args[1]), R, ptr(xf), ptr(sc), ptr(args[2]),
            M, pool.boxes.data_ptr(), pool.slots.data_ptr(),
            pool.counts.data_ptr(), pool.params.data_ptr(),
            pool.leaf_budget, t.data_ptr(), n.data_ptr(), ptr(cnt), stream)
    mesh_closest.launches += 1
    _kernels.check(err, "mesh_closest")
    if stats is not None:
        c = cnt.tolist()
        stats.update(nodes=c[0], triangles=c[1])
    return t, n


mesh_closest.launches = 0
