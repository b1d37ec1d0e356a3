"""Redundant mesh-edge detection and culling (port of
``newton_tpu/geometry/edge_redundancy.py``; host numpy, the same arrays).

A dihedral-angle filter keeps the feature edges; an optional box
absorption pass removes near-duplicate parallel edges (bevel strips,
tessellation seams) lying inside an oriented box around a sharper, larger
neighbour. The surviving edges seed each mesh's contact sample points at
``finalize`` (``sim/mesh_prep.py``), so the samples sit on real features.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

MINVAL = 1.0e-15


@dataclass
class EdgeFeatures:
    """Unique-edge table with adjacency diagnostics.

    ``edges`` is (E, 2) sorted vertex pairs.  ``face_count`` is how many
    triangles share each edge (1 = boundary, 2 = manifold, >2 = non-manifold).
    For manifold edges ``dihedral`` is the angle between the two adjacent
    face normals (0 = coplanar), ``avg_normal`` their normalized sum and
    ``area_sum`` the summed adjacent triangle area; other edges carry zeros.
    """

    edges: np.ndarray
    face_count: np.ndarray
    dihedral: np.ndarray
    avg_normal: np.ndarray
    area_sum: np.ndarray


@dataclass
class EdgeRedundancyResult:
    """Manifold-edge absorption candidates (reference EdgeRedundancyResult)."""

    edge_indices: np.ndarray          # (M, 2) manifold feature edges
    dihedral_angles: np.ndarray       # (M,)
    adjacent_face_area_sum: np.ndarray
    candidate_for_removal: np.ndarray  # (M,) bool
    num_absorbers_per_edge: np.ndarray
    absorb_count_per_box: np.ndarray
    absorbed: List[np.ndarray]        # per-box absorbed edge index lists
    upper_angle_threshold_rad: float


@dataclass
class EdgeResolutionResult:
    to_remove: np.ndarray
    kept: np.ndarray


def mesh_edge_features(vertices: np.ndarray, indices: np.ndarray) -> EdgeFeatures:
    """Build the unique edge table with dihedral/area diagnostics."""
    verts = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    faces = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    if len(faces) == 0:
        z = np.zeros(0)
        return EdgeFeatures(np.zeros((0, 2), np.int32), z.astype(np.int32), z,
                            np.zeros((0, 3)), z)
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])   # (T, 3)
    fa2 = np.linalg.norm(fn, axis=1)                               # 2*area
    fn_unit = fn / np.maximum(fa2, MINVAL)[:, None]

    # all 3T directed edges -> canonical sorted pairs
    e = np.stack([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]],
                 axis=1).reshape(-1, 2)                            # (3T, 2)
    e_sorted = np.sort(e, axis=1)
    keys = (e_sorted[:, 0] << 32) | e_sorted[:, 1]
    uniq, inv, counts = np.unique(keys, return_inverse=True,
                                  return_counts=True)
    E = len(uniq)
    edges = np.stack([uniq >> 32, uniq & 0xFFFFFFFF], axis=1).astype(np.int32)

    # first/second incident face per edge (by order of appearance)
    face_of = np.repeat(np.arange(len(faces)), 3)
    order = np.argsort(inv, kind="stable")
    starts = np.searchsorted(inv[order], np.arange(E))
    f0 = face_of[order[starts]]
    f1 = np.where(counts >= 2,
                  face_of[order[np.minimum(starts + 1, len(order) - 1)]], f0)

    n0, n1 = fn_unit[f0], fn_unit[f1]
    cosang = np.clip(np.sum(n0 * n1, axis=1), -1.0, 1.0)
    dihedral = np.where(counts == 2, np.arccos(cosang), 0.0)
    avg = n0 + n1
    avg_len = np.linalg.norm(avg, axis=1, keepdims=True)
    avg_normal = np.where(avg_len > MINVAL, avg / np.maximum(avg_len, MINVAL),
                          n0)
    area_sum = np.where(counts == 2, 0.5 * (fa2[f0] + fa2[f1]), 0.5 * fa2[f0])
    return EdgeFeatures(edges, counts.astype(np.int32), dihedral, avg_normal,
                        area_sum)


def find_redundant_edges(
    vertices: np.ndarray,
    indices: np.ndarray,
    *,
    half_normal: Optional[float] = None,
    half_lateral: Optional[float] = None,
    lower_angle_threshold_rad: float = np.deg2rad(5.0),
    upper_angle_threshold_rad: float = np.deg2rad(60.0),
    chunk: int = 512,
) -> EdgeRedundancyResult:
    """Find feature edges absorbable by a neighbour's oriented box.

    Mirrors the reference pipeline (edge_redundancy.py:33): dihedral
    pre-filter -> per-edge OBB in the (dir, tang, normal) frame -> AABB
    broad phase -> exact both-endpoints-in-box containment.  Sharp edges
    (angle >= upper threshold) may absorb but are never absorbed.
    """
    verts = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    feats = mesh_edge_features(verts, indices)
    manifold = feats.face_count == 2
    keep = manifold & (feats.dihedral >= lower_angle_threshold_rad)
    edges = feats.edges[keep]
    angles = feats.dihedral[keep]
    avg_n = feats.avg_normal[keep]
    areas = feats.area_sum[keep]
    M = len(edges)

    diag = 0.0
    if len(verts):
        diag = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    if half_normal is None:
        half_normal = 1.0e-3 * diag
    if half_lateral is None:
        half_lateral = 5.0e-3 * diag

    if M == 0:
        z = np.zeros(0, np.int32)
        return EdgeRedundancyResult(edges, angles, areas, z.astype(bool), z, z,
                                    [], upper_angle_threshold_rad)

    v0, v1 = verts[edges[:, 0]], verts[edges[:, 1]]
    evec = v1 - v0
    elen = np.linalg.norm(evec, axis=1)
    dir_e = evec / np.maximum(elen, MINVAL)[:, None]
    tang = np.cross(avg_n, dir_e)
    tang_len = np.linalg.norm(tang, axis=1)
    tang = tang / np.maximum(tang_len, MINVAL)[:, None]
    normal = np.cross(dir_e, tang)        # re-orthogonalized box normal
    valid = (elen > MINVAL) & (tang_len > MINVAL) & np.isfinite(avg_n).all(1)

    center = 0.5 * (v0 + v1)
    half = np.stack([0.5 * elen + half_lateral,
                     np.full(M, half_lateral),
                     np.full(M, half_normal)], axis=1)              # (M, 3)

    # world AABB of each box: |R| @ half with R = [dir | tang | normal]
    R = np.stack([dir_e, tang, normal], axis=1)                     # (M, 3, 3)
    world_half = np.einsum("mij,mi->mj", np.abs(R), half)
    lo = np.where(valid[:, None], center - world_half, 1e30)
    hi = np.where(valid[:, None], center + world_half, -1e30)

    absorbable = valid & (angles < upper_angle_threshold_rad)
    eps = 1e-9 * max(diag, 1.0)

    absorbed: List[np.ndarray] = [np.zeros(0, np.int64)] * M
    num_absorbers = np.zeros(M, np.int64)
    absorb_count = np.zeros(M, np.int64)
    # AABB broad phase as a sweep along the mesh's longest axis x: a box b
    # can overlap only the absorbable boxes whose lower x lies in
    # [lo_x(b) - eps - L, hi_x(b) + eps], L the longest of them along x (a
    # window of the boxes sorted by lower x, widened a little against
    # rounding). The longest 2% of the
    # absorbable boxes are every box's candidates instead, so that L stays
    # short. The pairs then take the dense test's exact AABB overlap and
    # the exact OBB containment of both endpoints, so the pairs found (and
    # each box's absorbed list, in ascending edge order) are the dense
    # test's.
    boxes = np.nonzero(valid)[0]
    cand = np.nonzero(absorbable)[0]
    if len(boxes) and len(cand):
        ax = int(np.argmax(verts.max(0) - verts.min(0)))
        ext = hi[cand, ax] - lo[cand, ax]
        cut = np.quantile(ext, 0.98)
        long_c = cand[ext > cut]
        cand = cand[ext <= cut]
        order = cand[np.argsort(lo[cand, ax], kind="stable")]
        lo_sorted = lo[order, ax]
        L = float(cut)
        pad = 2.0 * eps + 1e-9 * max(diag, 1.0)
        first = np.searchsorted(lo_sorted, lo[boxes, ax] - L - pad, "left")
        last = np.searchsorted(lo_sorted, hi[boxes, ax] + pad, "right")
        width = last - first + len(long_c)
        for s in range(0, len(boxes), chunk):
            sl = slice(s, s + chunk)
            w = width[sl]
            if not w.sum():
                continue
            b = np.repeat(boxes[sl], w)
            k = np.arange(int(w.sum())) - np.repeat(np.cumsum(w) - w, w)
            nl = len(long_c)
            short = np.repeat(first[sl], w) + k - nl
            ej = np.where(k < nl, np.append(long_c, 0)[np.minimum(k, nl)],
                          np.append(order, 0)[np.clip(short, 0,
                                                      len(order))])
            keep_p = ((lo[b] <= hi[ej] + eps) & (hi[b] >= lo[ej] - eps)).all(1)
            keep_p &= b != ej
            b, ej = b[keep_p], ej[keep_p]
            if len(b) == 0:
                continue
            d0 = verts[edges[ej, 0]] - center[b]
            d1 = verts[edges[ej, 1]] - center[b]
            Rb = R[b]                                               # (P, 3, 3)
            p0 = np.einsum("pij,pj->pi", Rb, d0)
            p1 = np.einsum("pij,pj->pi", Rb, d1)
            inside = ((np.abs(p0) <= half[b] + eps).all(1)
                      & (np.abs(p1) <= half[b] + eps).all(1))
            b, ej = b[inside], ej[inside]
            if len(b) == 0:
                continue
            srt = np.lexsort((ej, b))
            b, ej = b[srt], ej[srt]
            np.add.at(absorb_count, b, 1)
            np.add.at(num_absorbers, ej, 1)
            ub, starts = np.unique(b, return_index=True)
            for bb, lst in zip(ub, np.split(ej, starts[1:])):
                absorbed[bb] = lst

    return EdgeRedundancyResult(
        edge_indices=edges, dihedral_angles=angles,
        adjacent_face_area_sum=areas,
        candidate_for_removal=num_absorbers > 0,
        num_absorbers_per_edge=num_absorbers,
        absorb_count_per_box=absorb_count,
        absorbed=absorbed,
        upper_angle_threshold_rad=float(upper_angle_threshold_rad))


def resolve_edge_removals(
    result: EdgeRedundancyResult,
    upper_angle_threshold_rad: Optional[float] = None,
) -> EdgeResolutionResult:
    """Greedy kept/removed resolution (reference edge_redundancy.py:688).

    Boxes are visited by descending absorb count (adjacent area breaks
    ties); a visited box that is not itself removed is kept and removes
    every edge it absorbed, except sharp or already-kept edges.
    """
    thr = (result.upper_angle_threshold_rad
           if upper_angle_threshold_rad is None else upper_angle_threshold_rad)
    M = len(result.edge_indices)
    to_remove = np.zeros(M, bool)
    kept = np.zeros(M, bool)
    if M == 0:
        return EdgeResolutionResult(to_remove, kept)
    order = np.lexsort((-result.adjacent_face_area_sum,
                        -result.absorb_count_per_box))
    for box in order:
        if result.absorb_count_per_box[box] == 0:
            break
        if to_remove[box]:
            continue
        kept[box] = True
        for e in result.absorbed[box]:
            if not kept[e] and result.dihedral_angles[e] < thr:
                to_remove[e] = True
    return EdgeResolutionResult(to_remove, kept)


def collision_edges(
    vertices: np.ndarray,
    indices: np.ndarray,
    *,
    lower_angle_threshold_rad: float = np.deg2rad(5.0),
    upper_angle_threshold_rad: float = np.deg2rad(60.0),
    enable_box_absorption: bool = True,
    half_normal: Optional[float] = None,
    half_lateral: Optional[float] = None,
) -> np.ndarray:
    """Final culled collision-edge set for contact sampling.

    Boundary and non-manifold edges always survive; coplanar manifold
    edges fail the dihedral filter; redundant parallel feature edges are
    removed by box absorption (reference types.py:961 _build_collision_edges).
    """
    feats = mesh_edge_features(vertices, indices)
    always = feats.face_count != 2
    sharp = (feats.face_count == 2) & (feats.dihedral
                                       >= lower_angle_threshold_rad)
    base = feats.edges[always | sharp]
    # absorption is O(M^2 / chunk) host work — above this budget the culled
    # set is the plain dihedral-filtered one (same fallback as the
    # reference's negative-threshold opt-out path, types.py:979)
    if not enable_box_absorption or int(sharp.sum()) > 16384:
        return np.ascontiguousarray(base, dtype=np.int32)
    result = find_redundant_edges(
        vertices, indices,
        half_normal=half_normal, half_lateral=half_lateral,
        lower_angle_threshold_rad=lower_angle_threshold_rad,
        upper_angle_threshold_rad=upper_angle_threshold_rad)
    res = resolve_edge_removals(result)
    if not res.to_remove.any():
        return np.ascontiguousarray(base, dtype=np.int32)
    rm = result.edge_indices[res.to_remove].astype(np.int64)
    rm_keys = (rm[:, 0] << 32) | rm[:, 1]
    bk = base.astype(np.int64)
    base_keys = (bk[:, 0] << 32) | bk[:, 1]
    return np.ascontiguousarray(base[~np.isin(base_keys, rm_keys)],
                                dtype=np.int32)
