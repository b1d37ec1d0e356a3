"""K2's walk on the CPU: the mesh BVH walked without a stack over the
pool's packed data (csrc/raycast.cu: raycast_mesh_kernel), against the
stack walk of ``bvh.mesh_closest_plain``.

On the complete binary layout the stack walk's order needs no stack: a
hit interior node goes to its right child 2i + 2 (the stack pops it
first); after a miss or a leaf the walk climbs while the node is a left
child (odd) and steps to the left sibling of the right child reached; the
root ends it. The kernel reads a node's box as two float4 and a leaf's
triangles as v0, e1 = v1 - v0, e2 = v2 - v0 with a count of valid slots
(``BVHPool.boxes``, ``slots``, ``counts``). Plain-PyTorch walks of that
algorithm, one per lane alone and one in the kernel's warps of 32
consecutive rays (each lane walks until enough lanes stand at a hit leaf,
then the warp tests those leaves together and each keeps its least (t
bits, slot)), visit the stack walk's nodes in its order, pair by pair,
and give its (t, normal) bit for bit and its node and triangle counts: on a fractal
terrain, on a terrain at the depth cap of 12, and on a pool of two BVHs
with different leaf budgets under transforms and scales, with rays that
miss the root, graze the surface, run along the axes or start inside the
root box. No JAX: a few seconds on one worker.
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.geometry import bvh as tbvh
from newton_tpu_torch.geometry.terrain import (generate_fractal_terrain,
                                               heightfield_to_mesh)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the torus mesh)

torch.set_num_threads(1)
_INF = 1e10


def _mesh(name):
    if name == "torus":
        return cs.torus_mesh(nt, R=0.3, r=0.1, nu=20, nv=10)
    if name == "field":          # tests/test_torch_raycast.py's terrain
        return heightfield_to_mesh(generate_fractal_terrain(
            nx=24, ny=24, size_x=4.0, size_y=4.0, seed=1))
    return heightfield_to_mesh(generate_fractal_terrain(     # 9,522 tris
        nx=70, ny=70, size_x=4.0, size_y=4.0, seed=2))


def _rays(m, n, seed):
    """n rays of each kind: aimed into the box from outside, random (most
    miss the root), grazing the surface from its side, along the axes, and
    from inside the root box."""
    rng = np.random.RandomState(seed)
    lo, hi = m.vertices.min(0), m.vertices.max(0)
    c, ext = 0.5 * (lo + hi), float(np.max(hi - lo))
    o_in = c + ext * rng.uniform(-1.2, 1.2, (n, 3))
    d_in = c + 0.5 * (hi - lo) * rng.uniform(-1, 1, (n, 3)) - o_in
    o_rand = c + ext * rng.uniform(-2, 2, (n, 3))
    d_rand = rng.randn(n, 3)
    z = rng.uniform(lo[2], hi[2], n)
    o_graze = np.c_[np.full(n, lo[0] - 0.1 * ext),
                    rng.uniform(lo[1], hi[1], n), z]
    d_graze = np.c_[np.ones(n), rng.uniform(-0.2, 0.2, n),
                    rng.uniform(-1e-3, 1e-3, n)]
    o_axis = lo + (hi - lo) * rng.uniform(0, 1, (n, 3))
    o_axis[:, 2] = hi[2] + 0.1 * ext
    d_axis = np.zeros((n, 3))
    d_axis[:, 2] = -1.0
    d_axis[: n // 2, 2] = 0.0
    d_axis[: n // 2, 0] = 1.0
    o_axis[: n // 2, 0] = lo[0] - 0.1 * ext
    o_inside = lo + (hi - lo) * rng.uniform(0.05, 0.95, (n, 3))
    d_inside = rng.randn(n, 3)
    o = np.concatenate([o_in, o_rand, o_graze, o_axis, o_inside])
    d = np.concatenate([d_in, d_rand, d_graze, d_axis, d_inside])
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32)),
            torch.as_tensor(d.astype(np.float32)))


def _case(name, device="cpu", n=60):
    """(pool, rays, bvh_of, X, scale) on ``device``, n rays of each
    kind."""
    if name == "pool":
        meshes = [_mesh("torus"), _mesh("field")]
        bvh_of = [0, 1, 0]
    else:
        meshes, bvh_of = [_mesh(name)], [0]
    bvhs = [tbvh.MeshBVH(m.vertices, m.indices) for m in meshes]
    pool = tbvh.BVHPool(bvhs, [m.vertices for m in meshes], device)
    o, d = _rays(meshes[-1], n, 11)
    X = sc = None
    if name == "pool":
        rng = np.random.RandomState(4)
        Xn = np.c_[rng.uniform(-0.3, 0.3, (3, 3)), rng.randn(3, 4)]
        Xn[:, 3:] /= np.linalg.norm(Xn[:, 3:], axis=1, keepdims=True)
        X = torch.as_tensor(Xn, dtype=torch.float32)
        sc = torch.tensor([[1, 1, 1], [1.2, 0.7, 1.0], [0.5, 0.5, 0.5]],
                          dtype=torch.float32)
    bvh_of = torch.tensor(bvh_of, dtype=torch.int32)
    o, d, bvh_of, X, sc = (None if x is None else x.to(device)
                           for x in (o, d, bvh_of, X, sc))
    return pool, (o, d), bvh_of, X, sc


@pytest.fixture(scope="module")
def cases():
    return {n: _case(n) for n in ("field", "deep", "pool")}


def _triangles(o, d, v0, e1, e2):
    """bvh.ray_triangles from v0, e1, e2 (the same operations in order)."""
    _dot, _cross = tbvh._dot, tbvh._cross
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


def _climb(node):
    """After a miss or a leaf: the next node of the walk, -1 at its end."""
    node = node.clone()
    while True:
        odd = node % 2 == 1
        if not bool(odd.any()):
            break
        node = torch.where(odd, (node - 1) // 2, node)
    return torch.where(node == 0, -1, node - 1)


class _Pairs:
    """Every (shape, ray) pair in the shape's frame, with its BVH's
    offsets (as mesh_closest_plain forms them)."""

    def __init__(self, pool, rays, bvh_of, X, sc):
        o, d = rays
        self.M, self.R = bvh_of.shape[0], o.shape[0]
        ol, dl = tbvh._local_rays(o, d, X, sc)
        self.o = ol.expand(self.M, self.R, 3).reshape(-1, 3)
        self.d = dl.expand(self.M, self.R, 3).reshape(-1, 3)
        self.inv = 1.0 / torch.where(self.d.abs() > 1e-9, self.d, 1e-9)
        prm = pool.params.long()[bvh_of.long().repeat_interleave(self.R)]
        self.node_off, self.leaf_off = prm[:, 0], prm[:, 1]
        self.leaf_base = prm[:, 2] - 1
        self.pool, self.sc = pool, sc
        Q = self.M * self.R
        self.t = torch.full((Q,), _INF)
        self.n = torch.zeros((Q, 3))
        self.nodes = self.tris = 0

    def box_hit(self, q, node):
        box = self.pool.boxes[self.node_off[q] + node]
        t1 = (box[:, 0:3] - self.o[q]) * self.inv[q]
        t2 = (box[:, 4:7] - self.o[q]) * self.inv[q]
        tmin = torch.minimum(t1, t2).amax(-1)
        tmax = torch.maximum(t1, t2).amin(-1)
        self.nodes += q.numel()
        return (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < self.t[q])

    def leaf(self, q, node):
        """The leaves' valid slots; the first minimum below the best."""
        if not q.numel():
            return
        K = self.pool.leaf_budget
        lf = self.leaf_off[q] + node - self.leaf_base[q]
        cnt = self.pool.counts[lf].long()
        s = self.pool.slots.view(-1, K, 12)[lf]
        t, n = _triangles(self.o[q][:, None], self.d[q][:, None],
                          s[..., 0:3], s[..., 3:6], s[..., 6:9])
        t = torch.where(torch.arange(K) < cnt[:, None], t, _INF)
        self.tris += int(cnt.sum())
        k = t.argmin(1)
        tk = t.gather(1, k[:, None])[:, 0]
        better = tk < self.t[q]
        self.t[q[better]] = tk[better]
        self.n[q[better]] = n[better, k[better]]

    def result(self):
        n = self.n.reshape(self.M, self.R, 3)
        if self.sc is not None:
            n = n / torch.clamp(self.sc, min=1e-9)[:, None, :]
            n = n / torch.clamp(torch.sqrt(tbvh._dot(n, n)),
                                min=1e-9)[..., None]
        return self.t.reshape(self.M, self.R), n


def _lane_walk(pool, rays, bvh_of, X, sc, trace):
    """Each pair walks alone, without a stack."""
    w = _Pairs(pool, rays, bvh_of, X, sc)
    node = torch.zeros(w.M * w.R, dtype=torch.long)
    q = torch.arange(w.M * w.R)
    while q.numel():
        nd = node[q]
        trace.append((q.clone(), nd.clone()))
        hit = w.box_hit(q, nd)
        interior = nd < w.leaf_base[q]
        lf = hit & ~interior
        w.leaf(q[lf], nd[lf])
        nxt = torch.where(hit & interior, 2 * nd + 2, _climb(nd))
        node[q] = nxt
        q = q[nxt >= 0]
    return w


def _warp_walk(pool, rays, bvh_of, X, sc, trace, ready=8):
    """The kernel's warps: 32 consecutive rays of one shape; each lane
    walks alone until ``ready`` lanes (csrc/raycast.cu: kLeafLanes) stand
    at a hit leaf, or every lane stands at one or has ended; then the
    warp's leaves are tested together and each takes its least (t bits,
    slot), the leaf's first minimum."""
    w = _Pairs(pool, rays, bvh_of, X, sc)
    nw = (w.R + 31) // 32
    r = torch.arange(nw * 32).reshape(nw, 32)
    lanes = (torch.arange(w.M)[:, None, None] * w.R + r[None]).reshape(-1, 32)
    live = (r < w.R)[None].expand(w.M, nw, 32).reshape(-1, 32)
    lanes = torch.where(live, lanes, 0)
    node = torch.where(live, 0, -1)
    at_leaf = torch.zeros_like(live)
    K = pool.leaf_budget
    while bool((node >= 0).any()):
        while True:
            rdy = (node < 0) | at_leaf
            stop = rdy.all(1) | (at_leaf.sum(1) >= ready)
            go = ~stop[:, None] & ~rdy
            if not bool(go.any()):
                break
            q, nd = lanes[go], node[go]
            trace.append((q.clone(), nd.clone()))
            hit = w.box_hit(q, nd)
            leaf = nd >= w.leaf_base[q]
            node[go] = torch.where(hit & ~leaf, 2 * nd + 2,
                                   torch.where(hit, nd, _climb(nd)))
            at_leaf[go] = hit & leaf
        q, nd = lanes[at_leaf], node[at_leaf]
        if q.numel():
            lf = w.leaf_off[q] + nd - w.leaf_base[q]
            cnt = pool.counts[lf].long()
            s = pool.slots.view(-1, K, 12)[lf]
            t, n = _triangles(w.o[q][:, None], w.d[q][:, None],
                              s[..., 0:3], s[..., 3:6], s[..., 6:9])
            t = torch.where(torch.arange(K) < cnt[:, None], t, _INF)
            w.tris += int(cnt.sum())
            key = (t.view(torch.int32).long() << 32) + torch.arange(K)
            k = key.amin(1) & 0xffffffff
            tk = t.gather(1, k[:, None])[:, 0]
            better = tk < w.t[q]
            w.t[q[better]] = tk[better]
            w.n[q[better]] = n[better, k[better]]
            node[at_leaf] = _climb(nd)
            at_leaf[:] = False
    return w


def _sequences(trace):
    """Each pair's nodes in walk order: (pairs, nodes) sorted by pair."""
    q = torch.cat([a for a, _ in trace])
    n = torch.cat([b for _, b in trace])
    order = torch.sort(q, stable=True).indices
    return q[order], n[order]


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("walk", ["lane", "warp"])
@pytest.mark.parametrize("name", ["field", "deep", "pool"])
def test_stackless_walk_equals_the_stack_walk(cases, name, walk):
    """The same nodes in the same order for every pair, the same (t,
    normal) bit for bit, the same node and triangle counts."""
    pool, rays, bvh_of, X, sc = cases[name]
    ref_trace, stats = [], {}
    tp, np_ = tbvh.mesh_closest_plain(pool, *rays, bvh_of, X, sc,
                                      stats=stats, trace=ref_trace)
    trace = []
    w = (_lane_walk if walk == "lane" else _warp_walk)(
        pool, rays, bvh_of, X, sc, trace)
    t, n = w.result()
    rq, rn = _sequences(ref_trace)
    q, nn = _sequences(trace)
    assert torch.equal(q, rq) and torch.equal(nn, rn)
    assert torch.equal(_bits(t), _bits(tp)) and torch.equal(_bits(n),
                                                            _bits(np_))
    assert (w.nodes, w.tris) == (stats["nodes"], stats["triangles"])
    hit = tp < _INF
    assert hit.any() and (~hit).any()


def test_depth_cap_and_budgets(cases):
    """The cases reach what they are for: the depth cap of 12, two leaf
    budgets in one pool, rays that miss the root and rays that start
    inside it."""
    pool = cases["deep"][0]
    assert int(pool.params[0, 3]) == 12
    two = cases["pool"][0]
    assert two.params.shape[0] == 2
    budgets = [int(two.counts[int(l0):int(l0) + int(nl)].max())
               for _, l0, nl, _ in two.params_np]
    assert budgets[0] != budgets[1]
    (o, d), lo, hi = cases["field"][1], cases["field"][0].lo[0], \
        cases["field"][0].hi[0]
    inside = ((o >= lo) & (o <= hi)).all(1)
    assert inside.sum() >= 50
    t, _ = tbvh.mesh_closest_plain(cases["field"][0], o, d,
                                   cases["field"][2])
    assert int((t[0] >= _INF).sum()) >= 50


@pytest.mark.parametrize("name", ["field", "deep", "pool"])
def test_pool_packs_boxes_and_slots(cases, name):
    """boxes = (lo, 0, hi, 0); slots = v0, v1 - v0, v2 - v0 of verts[tris]
    in float32 and three zeros; counts = mask.sum(1); every mask a
    prefix."""
    pool = cases[name][0]
    zero = np.zeros((pool.lo.shape[0], 1), np.float32)
    np.testing.assert_array_equal(
        pool.boxes.numpy().view(np.int32),
        np.concatenate([pool.lo.numpy(), zero, pool.hi.numpy(), zero],
                       1).view(np.int32))
    p = pool.verts.numpy()[pool.tris.numpy()].reshape(-1, 3, 3)
    want = np.concatenate([p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0],
                           np.zeros_like(p[:, 0])], 1)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(pool.slots.numpy().view(np.int32),
                                  want.view(np.int32))
    mask = pool.mask.numpy().astype(bool)
    cnt = pool.counts.numpy()
    np.testing.assert_array_equal(cnt, mask.sum(1))
    np.testing.assert_array_equal(
        mask, np.arange(pool.leaf_budget) < cnt[:, None])
    assert pool.boxes.shape == (pool.lo.shape[0], 8)
    assert pool.slots.shape == (mask.size, 12)


def test_pool_refuses_a_mask_that_is_not_a_prefix():
    m = _mesh("field")
    b = tbvh.MeshBVH(m.vertices, m.indices)
    mask = b.leaf_mask.clone()
    row = int(torch.nonzero(mask.sum(1) >= 2)[0])
    mask[row, 0] = False
    b.leaf_mask = mask
    with pytest.raises(ValueError, match="prefix"):
        tbvh.BVHPool([b], [m.vertices], "cpu")


def test_warp_walk_threshold_matches_the_kernel():
    """_warp_walk's default is the kernel's kLeafLanes."""
    import inspect
    import re
    src = os.path.join(os.path.dirname(tbvh.__file__), "..", "csrc",
                       "raycast.cu")
    with open(src) as f:
        k = int(re.search(r"constexpr int kLeafLanes = (\d+);",
                          f.read()).group(1))
    assert inspect.signature(_warp_walk).parameters["ready"].default == k
