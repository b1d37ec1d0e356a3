"""K1's culling on the CPU (geometry/raycast.py: cull_tables, the pre-pass
that runs on the device before every K1 launch, and cull_box_pass, the
plain twin of the kernel's box test).

K1 must return what ``closest_analytic_plain`` returns, bit for bit: the
first minimum over all shapes. Culling keeps that answer exactly when the
winner's group box and top box pass the kernel's test whenever the kernel
tests them; the running best is then never below the winner's t, so the
tests here hold each winner's boxes to the strongest case, t_lim = min(t,
max_dist). The scenes: the replicated ant x 16 (C.45's 8 m grid) with its
track cameras' rays, their shadow rays and grazing rays from the far
corner of a 32 x 32 grid of worlds (~330 m away, where the intersectors'
rounding puts reported hits outside their shapes' exact boxes), and the
shape zoo of tests/test_torch_raycast.py. A plain-PyTorch
walk of the kernel's algorithm (warps of 32 rays, planes kept by the
pre-pass, then top boxes and groups opened where a ray of the warp passes
them) equals the plain version bit for bit; so does the plain version on
the shapes the plane reduction keeps. The margin is also held far from
the world's origin (scenes moved 1e4-1e5 m, rays grazing the shapes'
extreme points from a few cm). No JAX: about 20 s on one worker.
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.geometry import raycast as rc
from newton_tpu_torch.math import quat_to_matrix

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the camera ant scene)
from test_torch_raycast import _rays, zoo_scene  # noqa: E402

torch.set_num_threads(1)
FAR_MAX_DIST = 1e6          # the far rays' hits lie ~330 m away
CAM_MAX_DIST = 100.0        # SensorTiledCamera's default


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same(a, b):
    """(t, shape, normal) equal bit for bit."""
    return (torch.equal(_bits(a[0]), _bits(b[0])) and torch.equal(a[1], b[1])
            and torch.equal(_bits(a[2]), _bits(b[2])))


def _grazing(X, sc, cls, n, seed, corner=(248.0, 248.0)):
    """Rays from around the far corner of a 32 x 32 grid of 8 m worlds,
    each aimed just beside a finite shape's silhouette (its radius, or a
    box's half diagonal, plus -5 cm to +30 cm sideways)."""
    rng = np.random.RandomState(seed)
    Xn, scn, cn = (a.numpy().astype(np.float64) for a in (X, sc, cls))
    fin = np.nonzero((cn >= 1) & (cn <= 3))[0]
    s = fin[rng.randint(0, len(fin), n)]
    O = np.c_[corner[0] + rng.uniform(-4, 4, n),
              corner[1] + rng.uniform(-4, 4, n), rng.uniform(0.05, 3.0, n)]
    R = quat_to_matrix(torch.as_tensor(Xn[s, 3:7])).numpy()
    h = np.where(cn[s] == 3, scn[s, 1], 0.0)
    c = Xn[s, :3] + R[:, :, 2] * (rng.uniform(-1, 1, n) * h)[:, None]
    r = np.where(cn[s] == 2, np.linalg.norm(scn[s], axis=1), scn[s, 0])
    v = c - O
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    a = rng.randn(n, 3)
    a -= (a * v).sum(1, keepdims=True) * v
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    off = r * (1.0 + rng.uniform(-0.02, 0.02, n)) + rng.uniform(-0.05, 0.3, n)
    d = c + a * off[:, None] - O
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(O.astype(np.float32)),
            torch.as_tensor(d.astype(np.float32)))


def _ant_scene():
    m = cs.camera_ant_scene(nt, 16).finalize("cpu")
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    X = rc.shape_world_transforms(m, s)
    cls = torch.as_tensor(rc.shape_classes(m))
    from newton_tpu_torch.sensors import SensorTiledCamera
    cam = SensorTiledCamera(m, width=32, height=32, fov_y=cs.CAM_FOV)
    torso = np.nonzero(np.asarray(m.structure.body_key) == "torso")[0]
    poses = torch.cat([s.body_q[torso, :3] + torch.tensor(cs.CAM_OFFSET),
                       torch.tensor(cs.CAM_QUAT).expand(16, 4)], 1)
    o, d = cam.rays(poses)
    t, _, n = rc.closest_analytic_plain(o, d, X, m.shape_scale, cls,
                                        CAM_MAX_DIST)
    so = o + d * t[:, None] + n * 1e-3
    sd = (-cam._light).expand_as(so).contiguous()
    return X, m.shape_scale, cls, dict(
        primary=(o, d, CAM_MAX_DIST), shadow=(so, sd, CAM_MAX_DIST),
        grazing=_grazing(X, m.shape_scale, cls, 6144, 1) + (FAR_MAX_DIST,))


def _zoo_scene():
    m = zoo_scene(nt).finalize("cpu")
    rng = np.random.RandomState(11)
    q = m.joint_q0.numpy().copy().reshape(-1, 7)
    q[:, :3] += 0.05 * rng.randn(len(q), 3)
    q[:, 3:] += 0.2 * rng.randn(len(q), 4)
    q[:, 3:] /= np.linalg.norm(q[:, 3:], axis=1, keepdims=True)
    s = nt.eval_fk(m, torch.as_tensor(q.reshape(-1).astype(np.float32)),
                   m.joint_qd0, m.state())
    X = rc.shape_world_transforms(m, s)
    cls = torch.as_tensor(rc.shape_classes(m))
    o, d = (torch.as_tensor(a) for a in _rays(4096, 5))
    far = _grazing(X, m.shape_scale, cls, 4096, 2)
    return X, m.shape_scale, cls, dict(
        primary=(o, d, CAM_MAX_DIST), grazing=far + (FAR_MAX_DIST,))


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        _SCENES[name] = _ant_scene() if name == "ant16" else _zoo_scene()
    return _SCENES[name]


CASES = [("ant16", "primary"), ("ant16", "shadow"), ("ant16", "grazing"),
         ("zoo", "primary"), ("zoo", "grazing")]


def _winner_boxes(tab, shape):
    """Each winner's (group, top) box rows (its position in the order)."""
    pos = torch.empty_like(tab["order"], dtype=torch.long)
    pos[tab["order"].long()] = torch.arange(pos.numel())
    g = pos[shape.long()] // rc.CULL_GROUP
    return tab["gbox"][g], tab["tbox"][g // rc.CULL_FAN]


@pytest.mark.parametrize("scene, rays", CASES)
def test_every_winner_passes_its_boxes(scene, rays):
    """Every ray's winning finite shape (closest_analytic_plain) lies in a
    group box and a top box that the ray passes with the kernel's test
    and margin at t_lim = min(t, max_dist); on the grazing rays some
    winners' reported hits lie outside their shapes' exact boxes, so the
    margin is what keeps them."""
    X, sc, cls, rays_of = _scene(scene)
    o, d, md = rays_of[rays]
    tab = rc.cull_tables(X, sc, cls)
    t, s, _ = rc.closest_analytic_plain(o, d, X, sc, cls, md)
    fin = (s >= 0) & (cls[s.clamp(min=0).long()] >= 1)
    assert int(fin.sum()) > 100
    gb, tb = _winner_boxes(tab, s[fin])
    lim = torch.clamp(t[fin], max=md)
    assert bool(rc.cull_box_pass(o[fin], d[fin], gb, lim).all())
    assert bool(rc.cull_box_pass(o[fin], d[fin], tb, lim).all())
    if rays == "grazing":
        p = o[fin].double() + d[fin].double() * t[fin].double()[:, None]
        lo, hi = _shape_boxes(X, sc, cls, s[fin].long())
        outside = ((p < lo) | (p > hi)).any(1)
        assert int(outside.sum()) > 50


def _extreme_rays(X, sc, cls, n, seed, reach):
    """Rays that graze a sphere's or capsule's extreme point along a world
    axis (where its box's face lies; for a capsule its end's) 0-1e-3 r
    inside, from ``reach`` (lo, hi) m away, perpendicular to that axis."""
    rng = np.random.RandomState(seed)
    Xn, scn, cn = (a.numpy().astype(np.float64) for a in (X, sc, cls))
    fin = np.nonzero((cn == 1) | (cn == 3))[0]
    s = fin[rng.randint(0, len(fin), n)]
    a = quat_to_matrix(torch.as_tensor(Xn[s, 3:7])).numpy()[:, :, 2]
    e = np.eye(3)[rng.randint(0, 3, n)] * rng.choice([-1.0, 1.0], n)[:, None]
    side = np.where((a * e).sum(1) < 0, -1.0, 1.0)
    h = np.where(cn[s] == 3, scn[s, 1], 0.0)
    q = Xn[s, :3] + a * (side * h)[:, None] \
        + e * (scn[s, 0] * (1.0 - rng.uniform(0.0, 1e-3, n)))[:, None]
    u = rng.randn(n, 3)
    u -= (u * e).sum(1, keepdims=True) * e
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    o = q - u * rng.uniform(*reach, n)[:, None]
    return (torch.as_tensor(o.astype(np.float32)),
            torch.as_tensor(u.astype(np.float32)))


def _far_scene(name, offset):
    """The ant x 16 moved ``offset`` m along x and y, or a cluster of n
    spheres of 3-10 mm in a 6 cm cube at (offset, offset, 1); rays that
    graze the shapes' extreme points from 0.3-1 m (the ant) or 2-8 cm."""
    if name == "ant16":
        X, sc, cls, _ = _scene("ant16")
        X = X.clone()
        X[:, 0:2] += offset
        reach = (0.3, 1.0)
    else:
        n = int(name[len("cluster"):])
        rng = np.random.RandomState(7)
        p = rng.uniform(-0.03, 0.03, (n, 3)) + [offset, offset, 1.0]
        X = torch.as_tensor(np.c_[p, np.zeros((n, 3)), np.ones(n)]
                            .astype(np.float32))
        sc = torch.as_tensor(np.c_[rng.uniform(0.003, 0.01, n),
                                   np.zeros((n, 2))].astype(np.float32))
        cls = torch.ones(n, dtype=torch.int32)
        reach = (0.02, 0.08)
    return (X, sc, cls) + _extreme_rays(X, sc, cls, 8192, 5, reach)


@pytest.mark.parametrize("name, offset", [
    ("ant16", 1e4), ("ant16", 1e5), ("cluster16", 1e4), ("cluster16", 1e5),
    ("cluster4", 1e5), ("cluster1", 1e5)])
def test_margin_holds_far_from_the_origin(name, offset):
    """Far from the world's origin a box's float32 faces round by up to
    half an ulp of the coordinates (3.9 mm at 1e5 m), more than m0 + kr D
    gives a box a few cm from the ray origin. With the margin's term for
    the coordinates' size (CULL_ABS) every winner's boxes pass (without
    it the 4-sphere cluster at 1e5 m loses ~1,160 of ~5,900 winners), and
    the walk of the culled algorithm equals the plain version bit for
    bit."""
    X, sc, cls, o, d = _far_scene(name, offset)
    tab = rc.cull_tables(X, sc, cls)
    t, s, _ = rc.closest_analytic_plain(o, d, X, sc, cls, FAR_MAX_DIST)
    fin = (s >= 0) & (cls[s.clamp(min=0).long()] >= 1)
    assert int(fin.sum()) > 1000
    gb, tb = _winner_boxes(tab, s[fin])
    assert bool(rc.cull_box_pass(o[fin], d[fin], gb, t[fin]).all())
    assert bool(rc.cull_box_pass(o[fin], d[fin], tb, t[fin]).all())
    o, d = o[:2048], d[:2048]
    assert _same(_walk(o, d, X, sc, cls, FAR_MAX_DIST),
                 rc.closest_analytic_plain(o, d, X, sc, cls, FAR_MAX_DIST))


def _shape_boxes(X, sc, cls, s):
    """The shapes' exact world boxes in float64 (cull_tables' rules)."""
    q = X[s, 3:7].double()
    R = quat_to_matrix(q / q.norm(dim=1, keepdim=True))
    c, a = cls[s], sc[s].double().abs()
    r = a[:, 0:1]
    he = torch.where((c == 1)[:, None], r.expand(-1, 3), 0.0)
    he = torch.where((c == 3)[:, None], R[:, :, 2].abs() * a[:, 1:2] + r, he)
    he = torch.where((c == 2)[:, None], (R.abs() * a[:, None, :]).sum(2), he)
    p = X[s, :3].double()
    return p - he, p + he


def _walk(o, d, X, sc, cls, md):
    """The kernel's algorithm in plain PyTorch: warps of 32 consecutive
    rays; the kept planes, then every top box and group that a live ray
    of the warp passes (cull_box_pass at the ray's running best), each
    evaluated by the plain version on the group's shapes for every ray of
    the warp; the least (t, index) wins."""
    tab = rc.cull_tables(X, sc, cls)
    R = o.shape[0]
    W = -(-R // 32)
    t = torch.full((R,), 1e10)
    s = torch.full((R,), -1, dtype=torch.int32)
    n = torch.zeros(R, 3)

    def merge(idx, rows):
        idx = torch.sort(idx.long())[0]
        tc, sc_, nc = rc.closest_analytic_plain(
            o[rows], d[rows], X[idx], sc[idx], cls[idx], float("inf"))
        glob = torch.where(sc_ >= 0, idx[sc_.clamp(min=0).long()], -1)
        better = (sc_ >= 0) & ((tc < t[rows]) | ((tc == t[rows])
                                                 & (glob < s[rows])))
        r = rows[better]
        t[r], s[r], n[r] = tc[better], glob[better].to(torch.int32), \
            nc[better]

    def opened(box):
        need = rc.cull_box_pass(o, d, box.expand(R, 6),
                                torch.clamp(t, max=md))
        warp = torch.nn.functional.pad(need, (0, 32 * W - R)).view(W, 32)
        return torch.nonzero(warp.any(1).repeat_interleave(32)[:R])[:, 0]

    n_fin, n_pl = (int(v) for v in tab["counts"])
    order = tab["order"]
    if n_pl:
        merge(order[n_fin:n_fin + n_pl], torch.arange(R))
    G, F = rc.CULL_GROUP, rc.CULL_FAN
    n_grp = -(-n_fin // G)
    for top in range(-(-n_grp // F)):
        if not opened(tab["tbox"][top]).numel():
            continue
        for g in range(top * F, min(n_grp, (top + 1) * F)):
            rows = opened(tab["gbox"][g])
            if rows.numel():
                merge(order[g * G:min(n_fin, (g + 1) * G)], rows)
    miss = ~(t <= md) | (s < 0)
    return (torch.where(miss, 1e10, t), torch.where(miss, -1, s),
            torch.where(miss[:, None], 0.0, n))


@pytest.mark.parametrize("scene, rays", CASES)
def test_culled_walk_equals_plain(scene, rays):
    """The plain-PyTorch walk of K1's culled algorithm equals
    closest_analytic_plain bit for bit (t, shape index, normal)."""
    X, sc, cls, rays_of = _scene(scene)
    o, d, md = rays_of[rays]
    o, d = o[:4096], d[:4096]
    assert _same(_walk(o, d, X, sc, cls, md),
                 rc.closest_analytic_plain(o, d, X, sc, cls, md))


def _plane_scene():
    """The ant x 16 with planes added: level ones at the floor's height
    (+0 and -0), at 0.5 m, and two tilted ones."""
    X, sc, cls, rays_of = _scene("ant16")
    rng = np.random.RandomState(3)
    extra = [[3.0, -2.0, 0.0, 0, 0, 0, 1], [-1.0, 4.0, -0.0, 0, 0, 0, 1],
             [0.0, 0.0, 0.5, 0, 0, 0, 1], [1.0, 1.0, 0.5, 0, 0, 0, 1]]
    for _ in range(2):
        q = np.r_[0.05 * rng.randn(3), 1.0]
        extra.append([0.0, 0.0, -0.2, *(q / np.linalg.norm(q))])
    Xe = torch.cat([X, torch.tensor(extra, dtype=torch.float32)])
    sce = torch.cat([sc, torch.zeros(len(extra), 3)])
    clse = torch.cat([cls, torch.zeros(len(extra), dtype=cls.dtype)])
    return Xe, sce, clse, rays_of


def test_plane_reduction_is_exact():
    """Of the level planes of one height only the lowest index is kept
    (the ant's 16 floors and the added floor-height ones: 1; the two at
    0.5 m: 1; both tilted planes kept), and the plain version on the kept
    planes and the finite shapes gives what it gives on every shape, bit
    for bit, on primary, shadow and grazing rays."""
    X, sc, cls, rays_of = _plane_scene()
    tab = rc.cull_tables(X, sc, cls)
    n_fin, n_pl = (int(v) for v in tab["counts"])
    assert n_pl == 4 and n_fin == int(((cls >= 1) & (cls <= 3)).sum())
    keep = torch.sort(tab["order"][:n_fin + n_pl].long())[0]
    for o, d, md in rays_of.values():
        t, s, n = rc.closest_analytic_plain(o, d, X[keep], sc[keep],
                                            cls[keep], md)
        s = torch.where(s >= 0, keep[s.clamp(min=0).long()], -1)
        assert _same((t, s.to(torch.int32), n),
                     rc.closest_analytic_plain(o, d, X, sc, cls, md))


def test_cull_tables_bound_their_shapes():
    """The pre-pass's order is a permutation with the finite shapes first
    in Morton order, each group box holds its shapes' exact boxes and each
    top box its groups; a shape with a non-unit quaternion or a
    non-finite transform gets an unbounded box."""
    X, sc, cls, _ = _scene("zoo")
    tab = rc.cull_tables(X, sc, cls)
    S, G, F = X.shape[0], rc.CULL_GROUP, rc.CULL_FAN
    order = tab["order"].long()
    assert torch.equal(torch.sort(order)[0], torch.arange(S))
    n_fin = int(tab["counts"][0])
    fin = order[:n_fin]
    assert bool(((cls[fin] >= 1) & (cls[fin] <= 3)).all())
    lo, hi = _shape_boxes(X, sc, cls, fin)
    g = torch.arange(n_fin) // G
    ulps = 1e-6 * (1.0 + lo.abs() + hi.abs())    # the float32 box's rounding
    assert bool((tab["gbox"][g, :3].double() <= lo + ulps).all())
    assert bool((tab["gbox"][g, 3:].double() >= hi - ulps).all())
    gi = torch.arange(tab["gbox"].shape[0])
    real = gi < -(-n_fin // G)
    assert bool((tab["tbox"][gi // F, :3] <= tab["gbox"][:, :3])[real].all())
    assert bool((tab["tbox"][gi // F, 3:] >= tab["gbox"][:, 3:])[real].all())
    Xb = X.clone()
    Xb[fin[0], 3:7] *= 1.01
    Xb[fin[1], 0] = float("nan")
    tb = rc.cull_tables(Xb, sc, cls)
    assert bool(torch.isinf(tb["gbox"]).all(1)[0])


def test_kernel_cost_of_culled_k1():
    """The culled K1's bound counts the work its counters report: 44 B a
    ray, 48 B a shape (its place in the order too), 24 B a box; per pair
    its class's cost (plane 14, sphere 20, box 59, capsule 72), 56 a box
    test, 113 a ray; far below the all-pairs count on the main path."""
    b, f = cs.kernel_cost("raycast_closest_culled", R=10, S=5, boxes=3,
                          pairs=(1, 2, 3, 4), box_tests=7)
    assert b == 10 * 44 + 5 * 48 + 3 * 24
    assert f == 14 + 2 * 20 + 3 * 59 + 4 * 72 + 7 * 56 + 10 * 113
    culled = cs.bound_ms(*cs.kernel_cost(
        "raycast_closest_culled", R=4194304, S=14336, boxes=952,
        pairs=(4194304, 90686208, 0, 1309399808), box_tests=909390848))
    full = cs.bound_ms(*cs.kernel_cost(
        "raycast_closest", R=4194304, classes=(1024, 1024, 0, 12288)))
    assert culled[1] == full[1] == "operations"
    assert culled[0] < full[0] / 20


def test_cull_constants_match_the_kernel():
    """raycast.py's CULL_* equal csrc/raycast.cu's compile-time kCull*
    (the pre-pass and the plain box test use the former, K1 the latter)."""
    import re
    src = open(os.path.join(os.path.dirname(rc.__file__), "..", "csrc",
                            "raycast.cu")).read()

    def const(name):
        m = re.search(rf"constexpr (?:int|float) {name} = ([0-9.e+-]+)f?;",
                      src)
        assert m, name
        return float(m.group(1))
    assert const("kCullGroup") == rc.CULL_GROUP
    assert const("kCullFan") == rc.CULL_FAN
    for name, value in (("kCullM0", rc.CULL_M0),
                        ("kCullKappa", rc.CULL_KAPPA),
                        ("kCullAbs", rc.CULL_ABS)):
        assert np.float32(const(name)) == np.float32(value), name
