"""Host-side preparation of mesh-kind shapes at ``finalize`` (port of the
mesh part of ``newton_tpu/sim/builder.py``'s ``finalize`` and its helpers;
host numpy, the JAX builder's arrays bit for bit).

For every shape: its contact sample points (32 per shape: farthest-point
samples of a mesh's surface seeded with its feature edges, a
heightfield's grid, fixed points of a primitive) and each sample's
vector area (the Voronoi partition of a dense surface cloud, which the
hydroelastic contacts integrate pressure over); its hull vertex cloud
(convex hulls and boxes, for MPR); and for the shapes that are the
signed-distance side of a pair, a baked SDF: a dense 24^3 grid (a
mesh's at its ``sdf_max_resolution`` below 48, a heightfield's height
function), or a sparse quantized texture at 48 and above, the textures
pooled into one block pool.

The work is cached by what it depends on, (type, scale) for a primitive
and (source, scale) for a mesh, so a model of thousands of worlds
computes each distinct shape once; the SDF-side test reads the candidate
pairs instead of testing every mesh shape against every shape.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry.types import SDF, GeoType, Heightfield, Mesh

__all__ = ["prepare_mesh_data", "mesh_collision_radius", "mesh_mass",
           "SAMPLE_COUNT", "MESH_KINDS"]

SAMPLE_COUNT = 32          # contact samples per shape
_SDF_RES = 24              # dense bake resolution unless the shape asks
# shapes asking for an SDF at or above this resolution get a sparse
# quantized texture instead of a dense pooled grid
_SDF_TEXTURE_MIN_RES = 48
MESH_KINDS = (int(GeoType.MESH), int(GeoType.CONVEX), int(GeoType.HFIELD),
              int(GeoType.SDF))
_MESH, _CONVEX = int(GeoType.MESH), int(GeoType.CONVEX)
_HFIELD, _SDF = int(GeoType.HFIELD), int(GeoType.SDF)
_PLANE, _BOX, _NONE = int(GeoType.PLANE), int(GeoType.BOX), int(GeoType.NONE)


def mesh_mass(source, density: float, scale):
    """(mass, com, inertia) of a mesh or hull shape from its source's unit
    density properties; nothing for a source without them."""
    if source is None or not source.has_inertia:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    scale = np.asarray(scale, dtype=np.float64)
    s3 = float(scale[0] * scale[1] * scale[2])
    m = source.mass * density * s3
    c = source.com * scale
    I = source.inertia * density * s3 * float(np.mean(scale ** 2))
    return m, c, I


def mesh_collision_radius(geo_type: int, scale, source) -> float:
    """Bounding radius of a mesh-kind shape: a mesh's or hull's farthest
    scaled vertex, a heightfield's |scale|, 1 otherwise (an SDF shape)."""
    if geo_type in (_MESH, _CONVEX) and source is not None and \
            source.num_vertices:
        return float(np.max(np.linalg.norm(
            source.vertices * np.asarray(scale), axis=1)))
    if geo_type == _HFIELD:
        return float(np.linalg.norm(scale))
    return 1.0


def _heightfield_grid(src: Heightfield) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """A heightfield's SDF d(x, y, z) = z - h(x, y) on a 24^3 grid over
    its padded box (centred at the origin like ``heightfield_to_mesh``):
    (grid, lower, upper)."""
    hfv = src.heights.astype(np.float64) + src.base
    nx, ny = src.nx, src.ny
    R = _SDF_RES
    pad = max(0.5, 0.1 * (hfv.max() - hfv.min() + 1.0))
    lo = np.array([-src.size_x / 2, -src.size_y / 2, hfv.min() - pad])
    hi = np.array([src.size_x / 2, src.size_y / 2, hfv.max() + pad])
    xs = np.linspace(0, nx - 1, R)
    ys = np.linspace(0, ny - 1, R)
    ix = np.clip(xs.astype(int), 0, nx - 2)
    iy = np.clip(ys.astype(int), 0, ny - 2)
    fx = (xs - ix)[:, None]
    fy = (ys - iy)[None, :]
    h00 = hfv[np.ix_(ix, iy)]
    h10 = hfv[np.ix_(ix + 1, iy)]
    h01 = hfv[np.ix_(ix, iy + 1)]
    h11 = hfv[np.ix_(ix + 1, iy + 1)]
    hg = (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
          + h01 * (1 - fx) * fy + h11 * fx * fy)
    zs = np.linspace(lo[2], hi[2], R)
    grid = (zs[None, None, :] - hg[:, :, None]).astype(np.float32)
    return grid, lo, hi


def _heightfield_samples(src: Heightfield, k: int):
    """A heightfield's contact samples (FPS of its grid points) and their
    vector areas (each grid cell's dA n = (-dh/dx, -dh/dy, 1) dx dy)."""
    hfv = src.heights.astype(np.float64) + src.base
    nx, ny = src.nx, src.ny
    gx, gy = np.meshgrid(np.linspace(-src.size_x / 2, src.size_x / 2, nx),
                         np.linspace(-src.size_y / 2, src.size_y / 2, ny),
                         indexing="ij")
    surf = np.stack([gx, gy, hfv], axis=-1).reshape(-1, 3)
    pts = _fps_sample(surf, k)
    # the area cloud reads the heights without ``base`` (the JAX builder's
    # cloud; the same for base 0)
    h = np.asarray(src.heights, dtype=np.float64)
    dx = src.size_x / max(nx - 1, 1)
    dy = src.size_y / max(ny - 1, 1)
    cloud = np.stack([gx, gy, h], axis=-1).reshape(-1, 3)
    ddx = np.gradient(h, dx, axis=0)
    ddy = np.gradient(h, dy, axis=1)
    n = np.stack([-ddx, -ddy, np.ones_like(h)], axis=-1).reshape(-1, 3)
    slope = np.linalg.norm(n, axis=1)
    areas = _sample_area_weights(pts, cloud, dx * dy * slope,
                                 n / slope[:, None])
    return pts, areas


# a mesh's samples by content (vertices, indices, scale, count): a model
# that holds a mesh another model of the process prepared (the kitchen's
# Franka after the arm alone) reads them back
_MESH_SAMPLES: "OrderedDict[tuple, tuple]" = OrderedDict()
_MESH_SAMPLES_MAX = 128


def _mesh_samples(src: Mesh, scale, k: int):
    key = (hashlib.sha1(src.vertices.tobytes()).hexdigest(),
           hashlib.sha1(src.indices.tobytes()).hexdigest(),
           tuple(np.asarray(scale, np.float64).tolist()), k)
    hit = _MESH_SAMPLES.get(key)
    if hit is None:
        hit = _MESH_SAMPLES[key] = _mesh_samples_of(src, scale, k)
        if len(_MESH_SAMPLES) > _MESH_SAMPLES_MAX:
            _MESH_SAMPLES.popitem(last=False)
    return hit[0].copy(), hit[1].copy()


def _mesh_samples_of(src: Mesh, scale, k: int):
    sv = src.vertices * scale
    pts = _fps_sample(_surface_sample_candidates(sv, src.indices), k,
                      seeds=_feature_edge_seeds(sv, src.indices, k))
    dense = _mesh_surface_cloud(src.vertices * scale, src.indices)
    areas = np.zeros((k, 3))
    if len(dense[0]):
        areas = _sample_area_weights(pts, *dense)
    return pts, areas


def _primitive_samples(t: int, scale, k: int):
    pts = _primitive_sample_points(GeoType(t), scale, k)
    dense = _primitive_surface_cloud(GeoType(t), scale)
    areas = np.zeros((k, 3))
    if dense is not None and len(dense[0]):
        areas = _sample_area_weights(pts, *dense)
    return pts, areas


def _needs_sdf(typ: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """The mesh and hull shapes that are the SDF side of some candidate
    pair: a mesh in any pair (raycasts trace its grid too), a hull paired
    with anything but a hull, a box or a plane (those run MPR or plane
    sampling)."""
    need = np.zeros(len(typ), dtype=bool)
    for a, b in ((0, 1), (1, 0)):
        ta, tb = typ[pairs[:, a]], typ[pairs[:, b]]
        hit = (ta == _MESH) | ((ta == _CONVEX)
                               & ~np.isin(tb, [_CONVEX, _BOX, _PLANE]))
        need[pairs[hit, a]] = True
    return need


def prepare_mesh_data(b, pairs: np.ndarray, device) -> Tuple[dict, dict]:
    """The model's mesh tensors and structure fields of builder ``b``
    whose candidate pairs are ``pairs``: (tensors, structure)."""
    from ..geometry.sdf_cache import (cached_bake_mesh_sdf,
                                      cached_bake_texture_sdf)
    S, K = b.shape_count, SAMPLE_COUNT
    typ = np.asarray(b.shape_type, dtype=np.int64).reshape(-1)
    sc = np.asarray(b.shape_scale, dtype=np.float64).reshape(-1, 3)
    sources = b.shape_source

    # sample points and areas: one row per distinct shape, a zero row
    # for shapes without samples (planes, sites, SDF shapes)
    rows_p: List[np.ndarray] = [np.zeros((K, 3))]
    rows_a: List[np.ndarray] = [np.zeros((K, 3))]
    inv = np.zeros(S, dtype=np.int64)
    prim = ~np.isin(typ, [_MESH, _CONVEX, _PLANE, _NONE, _SDF, _HFIELD])
    if prim.any():
        keys, first, pinv = np.unique(
            np.concatenate([typ[prim, None].astype(np.float64), sc[prim]],
                           1), axis=0, return_index=True,
            return_inverse=True)
        pidx = np.nonzero(prim)[0]
        for f in first:
            p, a = _primitive_samples(int(typ[pidx[f]]), sc[pidx[f]], K)
            rows_p.append(p)
            rows_a.append(a)
        inv[prim] = 1 + pinv.reshape(-1)
    cache: Dict[tuple, int] = {}
    kinds = np.nonzero(np.isin(typ, [_MESH, _CONVEX, _HFIELD]))[0]
    for s in kinds.tolist():
        t, src = int(typ[s]), sources[s]
        if t == _HFIELD and isinstance(src, Heightfield):
            key = ("h", id(src))
        elif t != _HFIELD and isinstance(src, Mesh):
            key = ("m", id(src), tuple(sc[s]))
        else:
            continue
        row = cache.get(key)
        if row is None:
            p, a = (_heightfield_samples(src, K) if key[0] == "h"
                    else _mesh_samples(src, sc[s], K))
            row = cache[key] = len(rows_p)
            rows_p.append(p)
            rows_a.append(a)
        inv[s] = row
    table_p, table_a = np.stack(rows_p), np.stack(rows_a)
    cell_area = np.linalg.norm(table_a, axis=-1).mean(axis=-1)

    # hull vertex clouds: hulls' scaled vertices (FPS to 64), box corners
    hulls: Dict[int, np.ndarray] = {}
    hcache: Dict[tuple, np.ndarray] = {}
    for s in np.nonzero(typ == _CONVEX)[0].tolist():
        src = sources[s]
        if not isinstance(src, Mesh):
            continue
        key = (id(src), tuple(sc[s]))
        hv = hcache.get(key)
        if hv is None:
            hv = src.vertices.astype(np.float64) * sc[s]
            if len(hv) > 64:
                hv = _fps_sample(hv, 64)
            hcache[key] = hv
        hulls[s] = hv
    boxes = np.nonzero(typ == _BOX)[0]
    hull_max = max([1] + [len(h) for h in hulls.values()]
                   + ([8] if len(boxes) else []))
    hull_verts = np.zeros((S, hull_max, 3), dtype=np.float32)
    if len(boxes):
        signs = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                          for z in (-1, 1)], dtype=np.float64)
        corners = signs[None] * sc[boxes, None, :]
        hull_verts[boxes, :8] = corners
        hull_verts[boxes, 8:] = corners[:, :1]
    for s, hv in hulls.items():
        hull_verts[s, :len(hv)] = hv
        hull_verts[s, len(hv):] = hv[0]

    # SDF bakes, in shape order (the pools' order is the JAX builder's)
    need = _needs_sdf(typ, np.asarray(pairs, dtype=np.int64).reshape(-1, 2))
    sdf_id = np.full(S, -1, dtype=np.int32)
    tex_id = np.full(S, -1, dtype=np.int32)
    grids: List[np.ndarray] = []
    lowers: List[np.ndarray] = []
    uppers: List[np.ndarray] = []
    texes: list = []
    baked: Dict[tuple, tuple] = {}
    hf_cache: Dict[int, tuple] = {}
    res_of = b.shape_sdf_resolution
    for s in np.nonzero(np.isin(typ, MESH_KINDS))[0].tolist():
        t, src = int(typ[s]), sources[s]
        if t in (_MESH, _CONVEX) and isinstance(src, Mesh):
            if not need[s]:
                continue
            res = int(res_of[s]) or _SDF_RES
            scl = sc[s]
            use_tex = res >= _SDF_TEXTURE_MIN_RES
            key = (id(src), res, use_tex, tuple(np.round(scl, 12)))
            if key not in baked:
                # bake in the shape's scaled frame: samples are placed
                # without scale, so the grid lives in scaled coordinates
                bsrc = src if np.allclose(scl, 1.0) else Mesh(
                    src.vertices * scl, src.indices, compute_inertia=False)
                if use_tex:
                    baked[key] = ("tex", len(texes))
                    texes.append(cached_bake_texture_sdf(bsrc,
                                                         resolution=res))
                else:
                    sdf = cached_bake_mesh_sdf(bsrc, resolution=res)
                    baked[key] = ("dense", len(grids))
                    grids.append(sdf.data)
                    lowers.append(sdf.lower)
                    uppers.append(sdf.upper)
            kind, kid = baked[key]
            (tex_id if kind == "tex" else sdf_id)[s] = kid
        elif t == _HFIELD and isinstance(src, Heightfield):
            g = hf_cache.get(id(src))
            if g is None:
                g = hf_cache[id(src)] = _heightfield_grid(src)
            sdf_id[s] = len(grids)
            grids.append(g[0])
            lowers.append(g[1])
            uppers.append(g[2])
        elif t == _SDF and isinstance(src, SDF):
            sdf_id[s] = len(grids)
            grids.append(src.data)
            lowers.append(src.lower)
            uppers.append(src.upper)

    tensors = _pool_grids(grids, lowers, uppers, device)
    tensors.update(_pool_textures(texes, device))
    dev_inv = torch.as_tensor(inv, device=device)
    tensors["shape_sample_points"] = torch.as_tensor(
        table_p.astype(np.float32), device=device)[dev_inv]
    tensors["shape_sample_areas"] = torch.as_tensor(
        table_a.astype(np.float32), device=device)[dev_inv]
    structure = dict(shape_sdf_id=sdf_id, shape_sdf_tex_id=tex_id,
                     shape_hull_verts=hull_verts,
                     shape_sample_cell_area=cell_area[inv])
    return tensors, structure


def _pool_grids(grids, lowers, uppers, device) -> dict:
    """Dense grids pooled (n, R, R, R) at the largest resolution (smaller
    ones nearest-upsampled)."""
    if grids:
        R = max(g.shape[0] for g in grids)
        pooled = np.zeros((len(grids), R, R, R), dtype=np.float32)
        for i, g0 in enumerate(grids):
            if g0.shape[0] != R:
                idx = np.linspace(0, g0.shape[0] - 1, R).astype(int)
                g0 = g0[np.ix_(idx, idx, idx)]
            pooled[i] = g0
        lo, hi = np.stack(lowers), np.stack(uppers)
    else:
        pooled = np.zeros((0, 2, 2, 2), dtype=np.float32)
        lo = hi = np.zeros((0, 3))

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
    return dict(sdf_grids=f32(pooled), sdf_lower=f32(lo), sdf_upper=f32(hi))


def _pool_textures(texes, device) -> dict:
    """Sparse textures pooled: their block indices become global slots of
    one shared block pool; a texture with fewer blocks per edge extends
    its upper bound by whole blocks (the cell size kept, the added blocks
    reading the edge-padded coarse grid), so each world-to-cell map stays
    exact."""
    if texes:
        from ..geometry.sdf_texture import BLOCK
        Bmax = max(t.block_index.shape[0] for t in texes)
        n = len(texes)
        index = np.full((n, Bmax, Bmax, Bmax), -1, np.int32)
        coarse = np.zeros((n, Bmax + 1, Bmax + 1, Bmax + 1), np.float32)
        lower = np.zeros((n, 3))
        upper = np.zeros((n, 3))
        blocks, scale, offset = [], [], []
        off = 0
        for i, t in enumerate(texes):
            Bi = t.block_index.shape[0]
            bi = t.block_index.astype(np.int64)
            index[i, :Bi, :Bi, :Bi] = np.where(bi >= 0, bi + off, -1)
            coarse[i] = np.pad(t.coarse, [(0, Bmax - Bi)] * 3, mode="edge")
            cell = (t.upper - t.lower) / (Bi * BLOCK)
            lower[i] = t.lower
            upper[i] = t.lower + cell * (Bmax * BLOCK)
            blocks.append(t.blocks[:len(t.block_scale)])
            scale.append(t.block_scale)
            offset.append(t.block_offset)
            off += len(t.block_scale)
        blocks = np.concatenate(blocks, axis=0)
        scale, offset = np.concatenate(scale), np.concatenate(offset)
    else:
        index = np.full((0, 2, 2, 2), -1, np.int32)
        blocks = np.zeros((0, 9, 9, 9), np.uint8)
        scale = offset = np.zeros(0, np.float32)
        coarse = np.zeros((0, 3, 3, 3), np.float32)
        lower = upper = np.zeros((0, 3))

    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
    return dict(sdf_tex_block_index=torch.as_tensor(index, device=device),
                sdf_tex_blocks=torch.as_tensor(
                    np.asarray(blocks, dtype=np.uint8), device=device),
                sdf_tex_scale=f32(scale), sdf_tex_offset=f32(offset),
                sdf_tex_coarse=f32(coarse), sdf_tex_lower=f32(lower),
                sdf_tex_upper=f32(upper))


# ---------------------------------------------------------------------------
# the JAX builder's helpers, as they are
# ---------------------------------------------------------------------------
def _convex_hull_mesh(mesh: Mesh) -> Mesh:
    """Host-side convex hull (gift-wrapping via scipy-free incremental hull).

    Falls back to the original mesh when hull construction fails.
    """
    try:
        pts = np.unique(mesh.vertices, axis=0)
        if len(pts) < 4:
            return mesh
        hull_idx = _quickhull(pts, mesh.maxhullvert)
        verts = pts[sorted(set(hull_idx.flatten()))]
        remap = {v: i for i, v in enumerate(sorted(set(hull_idx.flatten())))}
        faces = np.vectorize(remap.get)(hull_idx)
        return Mesh(verts, faces.reshape(-1), is_solid=True,
                    maxhullvert=mesh.maxhullvert)
    except Exception:
        return mesh


def _quickhull(pts: np.ndarray, max_verts: int = 64) -> np.ndarray:
    """Minimal 3D quickhull returning (F, 3) face indices into pts."""
    n = len(pts)
    # initial simplex: extreme points
    i0 = int(np.argmin(pts[:, 0])); i1 = int(np.argmax(pts[:, 0]))
    d = np.linalg.norm(np.cross(pts - pts[i0], pts[i1] - pts[i0]), axis=1)
    i2 = int(np.argmax(d))
    nrm = np.cross(pts[i1] - pts[i0], pts[i2] - pts[i0])
    d = np.abs((pts - pts[i0]) @ nrm)
    i3 = int(np.argmax(d))
    if d[i3] < 1e-12:
        raise ValueError("degenerate point set")
    faces = [(i0, i1, i2), (i0, i2, i3), (i0, i3, i1), (i1, i3, i2)]
    centroid = pts[[i0, i1, i2, i3]].mean(axis=0)

    def orient(f):
        a, b, c = f
        nn = np.cross(pts[b] - pts[a], pts[c] - pts[a])
        if nn @ (centroid - pts[a]) > 0:
            return (a, c, b)
        return f

    faces = [orient(f) for f in faces]
    for _ in range(4 * n):
        grew = False
        for fi, (a, b, c) in enumerate(list(faces)):
            nn = np.cross(pts[b] - pts[a], pts[c] - pts[a])
            ln = np.linalg.norm(nn)
            if ln < 1e-15:
                continue
            nn = nn / ln
            dist = (pts - pts[a]) @ nn
            far = int(np.argmax(dist))
            if dist[far] <= 1e-10:
                continue
            # remove all faces visible from `far`, collect horizon edges
            visible = []
            for gi, (p, q, r) in enumerate(faces):
                m = np.cross(pts[q] - pts[p], pts[r] - pts[p])
                if (pts[far] - pts[p]) @ m > 1e-12:
                    visible.append(gi)
            edge_count: Dict[Tuple[int, int], int] = {}
            for gi in visible:
                p, q, r = faces[gi]
                for e in ((p, q), (q, r), (r, p)):
                    kk = (min(e), max(e))
                    edge_count[kk] = edge_count.get(kk, 0) + 1
            horizon = []
            for gi in visible:
                p, q, r = faces[gi]
                for e in ((p, q), (q, r), (r, p)):
                    kk = (min(e), max(e))
                    if edge_count[kk] == 1:
                        horizon.append(e)
            faces = [f for gi, f in enumerate(faces) if gi not in set(visible)]
            for (p, q) in horizon:
                faces.append(orient((p, q, far)))
            grew = True
            break
        if not grew:
            break
        if len(set(i for f in faces for i in f)) >= max_verts:
            break
    return np.asarray(faces, dtype=np.int64)


def _surface_sample_candidates(verts: np.ndarray,
                               indices: np.ndarray) -> np.ndarray:
    """Contact-sample candidates covering a mesh SURFACE, not just its
    vertices: triangle edge midpoints, centroids and interior points are
    added so low-poly meshes (a box is 8 verts) still get face-interior
    contacts. Large meshes contribute their biggest triangles only."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    if len(faces) == 0:
        return verts
    tri = verts[faces]                                     # (T, 3, 3)
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    order = np.argsort(-area)[:2048]                       # cap host cost
    tri = tri[order]
    mids = 0.5 * (tri + np.roll(tri, -1, axis=1))          # edge midpoints
    cent = tri.mean(axis=1, keepdims=True)                 # centroids
    interior = 0.5 * (tri + cent)                          # toward-center pts
    return np.concatenate([verts, mids.reshape(-1, 3), cent.reshape(-1, 3),
                           interior.reshape(-1, 3)])


def _feature_edge_seeds(verts: np.ndarray, indices: np.ndarray,
                        max_seeds: int) -> np.ndarray:
    """Priority contact samples on sharp feature edges, with redundant
    parallel edges culled (geometry/edge_redundancy.py; reference
    edge_redundancy.py:33 + types.py:961 _build_collision_edges). Seeding
    FPS with these guarantees real features (box rims, bevels' survivors)
    keep contact coverage on coarse sample budgets."""
    from ..geometry.edge_redundancy import collision_edges
    verts = np.asarray(verts, dtype=np.float64)
    try:
        ce = collision_edges(verts, indices)
    except Exception:
        return np.zeros((0, 3))
    if len(ce) == 0:
        return np.zeros((0, 3))
    a, b = verts[ce[:, 0]], verts[ce[:, 1]]
    if len(ce) > max_seeds:                   # longest edges first
        order = np.argsort(-np.linalg.norm(b - a, axis=1))[:max_seeds]
        a, b = a[order], b[order]
    return np.concatenate([a, b, 0.5 * (a + b)])


def _fps_sample(points: np.ndarray, k: int,
                seeds: Optional[np.ndarray] = None) -> np.ndarray:
    """Farthest-point sampling of contact candidates from mesh vertices.
    ``seeds`` are chosen first (deduplicated, capped at k) so feature-edge
    points always survive the downsample."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    n = len(pts)
    if n == 0:
        return np.zeros((k, 3))
    if n <= k:
        return np.concatenate([pts, np.repeat(pts[-1:], k - n, axis=0)])
    if seeds is not None and len(seeds):
        sd = np.unique(np.asarray(seeds, dtype=np.float64), axis=0)
        if len(sd) > k:
            sd = _fps_sample(sd, k)
        d = np.linalg.norm(pts[:, None, :] - sd[None, :, :], axis=-1).min(1)
        chosen: List[int] = []
        for _ in range(k - len(sd)):
            i = int(np.argmax(d))
            chosen.append(i)
            d = np.minimum(d, np.linalg.norm(pts - pts[i], axis=1))
        return np.concatenate([sd, pts[chosen]]) if chosen else sd
    chosen = [int(np.argmax(np.linalg.norm(pts - pts.mean(0), axis=1)))]
    d = np.linalg.norm(pts - pts[chosen[0]], axis=1)
    for _ in range(k - 1):
        i = int(np.argmax(d))
        chosen.append(i)
        d = np.minimum(d, np.linalg.norm(pts - pts[i], axis=1))
    return pts[chosen]


def _primitive_sample_points(t: GeoType, sc, k: int) -> np.ndarray:
    """Surface sample points for primitive shapes (used when a primitive
    samples into a mesh SDF — the reverse mesh-contact direction)."""
    pts: List[np.ndarray] = []
    if t == GeoType.SPHERE or t == GeoType.ELLIPSOID:
        r = sc if t == GeoType.ELLIPSOID else np.array([sc[0]] * 3)
        dirs = np.array([[1,0,0],[-1,0,0],[0,1,0],[0,-1,0],[0,0,1],[0,0,-1],
                         [1,1,1],[1,1,-1],[1,-1,1],[1,-1,-1],
                         [-1,1,1],[-1,1,-1],[-1,-1,1],[-1,-1,-1]], dtype=float)
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        pts = list(dirs * r)
    elif t == GeoType.BOX:
        pts = [np.array([sx*sc[0], sy*sc[1], sz*sc[2]])
               for sx in (-1,1) for sy in (-1,1) for sz in (-1,1)]
        pts += [np.array([s_*sc[0],0,0]) for s_ in (-1,1)]
        pts += [np.array([0,s_*sc[1],0]) for s_ in (-1,1)]
        pts += [np.array([0,0,s_*sc[2]]) for s_ in (-1,1)]
    elif t in (GeoType.CAPSULE, GeoType.CYLINDER, GeoType.CONE):
        r, h = sc[0], sc[1]
        for z in (-h - (r if t == GeoType.CAPSULE else 0),
                  h + (r if t == GeoType.CAPSULE else 0)):
            pts.append(np.array([0, 0, z]))
        for z in (-h, 0.0, h):
            for a_ in np.linspace(0, 2*np.pi, 5)[:-1]:
                pts.append(np.array([r*np.cos(a_), r*np.sin(a_), z]))
    out = np.zeros((k, 3))
    n = min(len(pts), k)
    if n:
        out[:n] = np.stack(pts[:n])
        out[n:] = out[0]
    return out


def _sample_area_weights(samples: np.ndarray, dense_pts: np.ndarray,
                         dense_areas: np.ndarray,
                         dense_normals: np.ndarray) -> np.ndarray:
    """Voronoi partition of a dense surface cloud over the contact samples:
    each dense element's VECTOR area (dA * outward normal) accrues to its
    nearest sample, giving per-sample vector areas v_i = sum(dA_j n_j).
    Projecting v_i onto a contact direction yields exactly the projected
    patch area (divergence theorem), so flat-on-flat hydroelastic force
    integrals are exact and side-face slices assigned to edge/corner
    samples contribute nothing in the normal direction. Total vector area
    is conserved; padded duplicate samples receive the shared cell once
    (argmin picks the first)."""
    d = np.linalg.norm(dense_pts[:, None, :] - samples[None, :, :], axis=-1)
    nearest = np.argmin(d, axis=1)
    w = np.zeros((len(samples), 3))
    np.add.at(w, nearest, dense_normals * dense_areas[:, None])
    return w


def _mesh_surface_cloud(verts: np.ndarray, indices: np.ndarray) -> Tuple[
        np.ndarray, np.ndarray, np.ndarray]:
    """Dense (points, areas, outward normals) covering a mesh surface: each
    triangle is split into 4 (edge-midpoint subdivision) and contributes
    its sub-centroids with a quarter of its area — finer than per-triangle
    centroids so the Voronoi partition doesn't lump big faces onto one
    sample."""
    verts = np.asarray(verts, dtype=np.float64)
    faces = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    if len(faces) == 0:
        return np.zeros((0, 3)), np.zeros((0,)), np.zeros((0, 3))
    tri = verts[faces]                                     # (T, 3, 3)
    nvec = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(nvec, axis=1)
    nrm = nvec / np.maximum(np.linalg.norm(nvec, axis=1, keepdims=True),
                            1e-30)
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    ab, bc, ca = 0.5 * (a + b), 0.5 * (b + c), 0.5 * (c + a)
    subs = [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
    pts = np.concatenate([(p + q + r) / 3.0 for p, q, r in subs])
    areas = np.tile(area / 4.0, 4)
    return pts, areas, np.tile(nrm, (4, 1))


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi), np.cos(phi)], axis=-1)


def _primitive_surface_cloud(t: GeoType, sc) -> Optional[
        Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Dense (points, areas, outward normals) on a primitive's surface for
    the hydroelastic area partition. Exact total area for
    sphere/box/capsule/cylinder; first-fundamental-form scaling for the
    ellipsoid."""
    sc = np.asarray(sc, dtype=np.float64)
    if t == GeoType.SPHERE:
        r = sc[0]
        u = _fibonacci_sphere(256)
        return u * r, np.full(256, 4.0 * np.pi * r * r / 256), u
    if t == GeoType.ELLIPSOID:
        u = _fibonacci_sphere(256)
        # linear map A = diag(sc): dA -> det(A) * |A^-T n| dA_unit
        scale = np.prod(sc) * np.sqrt(((u / sc[None, :]) ** 2).sum(-1))
        n = u / sc[None, :]
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        return u * sc[None, :], (4.0 * np.pi / 256) * scale, n
    if t == GeoType.BOX:
        pts, areas, nrms = [], [], []
        g = (np.arange(4) + 0.5) / 4.0 * 2.0 - 1.0         # 4 cells per axis
        for ax in range(3):
            o1, o2 = (ax + 1) % 3, (ax + 2) % 3
            face_area = 4.0 * sc[o1] * sc[o2] / 16.0
            for s in (-1.0, 1.0):
                n = np.zeros(3)
                n[ax] = s
                for u_ in g:
                    for v_ in g:
                        p = np.zeros(3)
                        p[ax] = s * sc[ax]
                        p[o1] = u_ * sc[o1]
                        p[o2] = v_ * sc[o2]
                        pts.append(p)
                        areas.append(face_area)
                        nrms.append(n)
        return np.stack(pts), np.asarray(areas), np.stack(nrms)
    if t in (GeoType.CAPSULE, GeoType.CYLINDER, GeoType.CONE):
        r, h = sc[0], sc[1]
        pts, areas, nrms = [], [], []
        nth, nz = 12, 6
        ths = np.linspace(0, 2 * np.pi, nth, endpoint=False)
        side_h = 2.0 * h
        if t == GeoType.CONE:
            # lateral surface of the cone z in [-h, h], apex at +h
            slant = np.sqrt(side_h ** 2 + r ** 2)
            lat = np.pi * r * slant
            for th in ths:
                ct, st_ = np.cos(th), np.sin(th)
                n = np.array([ct * side_h, st_ * side_h, r]) / slant
                for zf in (np.arange(nz) + 0.5) / nz:
                    z = -h + zf * side_h
                    rr = r * (1.0 - zf)
                    pts.append([rr * ct, rr * st_, z])
                    # annulus weighting ~ local radius
                    areas.append(lat * (1.0 - zf))
                    nrms.append(n)
            areas = list(np.asarray(areas) / np.sum(areas) * lat)
            # base disk
            for th in ths:
                for rf in ((np.arange(3) + 0.5) / 3.0):
                    pts.append([r * rf * np.cos(th), r * rf * np.sin(th), -h])
                    areas.append(np.pi * r * r * rf)
                    nrms.append([0.0, 0.0, -1.0])
            a = np.asarray(areas)
            disk = np.pi * r * r
            a[-nth * 3:] = a[-nth * 3:] / a[-nth * 3:].sum() * disk
            return np.asarray(pts), a, np.asarray(nrms)
        # cylinder side (also the capsule's)
        for th in ths:
            ct, st_ = np.cos(th), np.sin(th)
            for zf in (np.arange(nz) + 0.5) / nz:
                z = -h + zf * side_h
                pts.append([r * ct, r * st_, z])
                areas.append(2 * np.pi * r * side_h / (nth * nz))
                nrms.append([ct, st_, 0.0])
        if t == GeoType.CAPSULE:
            u = _fibonacci_sphere(128)
            cap_a = 4.0 * np.pi * r * r / 128
            for ui in u:
                z_off = h if ui[2] >= 0 else -h
                pts.append([ui[0] * r, ui[1] * r, ui[2] * r + z_off])
                areas.append(cap_a)
                nrms.append(ui)
        else:                                               # cylinder caps
            for th in ths:
                for rf in ((np.arange(3) + 0.5) / 3.0):
                    for s in (-1.0, 1.0):
                        pts.append([r * rf * np.cos(th),
                                    r * rf * np.sin(th), s * h])
                        areas.append(2 * np.pi * r * r / (nth * 3 * 2) * rf
                                     * 2)
                        nrms.append([0.0, 0.0, s])
            a = np.asarray(areas)
            n_cap = nth * 3 * 2
            a[-n_cap:] = a[-n_cap:] / a[-n_cap:].sum() * 2 * np.pi * r * r
            return np.asarray(pts), a, np.asarray(nrms)
        return np.asarray(pts), np.asarray(areas), np.asarray(nrms)
    return None
