"""Mesh, convex-hull and heightfield contacts of the collision pipeline
(port of the mesh part of ``newton_tpu/sim/collide.py``:
``_install_mesh_classes``, ``_mesh_contacts``, ``_convex_contacts``,
``_reduce_k``/``_reduce_k_hydro``, ``_sdf_of_shape``/``_sdf_of_mesh_traced``
and the mesh kinds of dynamic-pair mode).

A mesh-kind pair collides by sampling instead of by triangles: each
shape carries 32 surface samples (``sim/mesh_prep.py``), and the samples
of one side are tested against the other side's signed distance, the
analytic one of a primitive or the baked grid or texture of a mesh or
heightfield. Static mode groups the pairs into classes:

- ``ma``: a mesh (or hull or heightfield) with a primitive. Where the mesh
  has a baked SDF and the primitive is not a plane, the class is
  two-sided (the JAX package builds it as its mesh-mesh class): half the
  slots from the mesh's samples in the primitive, half from the
  primitive's samples in the mesh's SDF;
- ``mm``: two meshes, two-sided;
- ``cc``: a hull with a hull or a box, through the MPR manifold of their
  vertex clouds (``geometry/mpr.convex_manifold``), no SDF.

Each side's samples are cut to its slots by ``geometry/contact_reduction``
(a stable descending sort where there are no more samples than slots);
in-contact samples beyond the slots are counted in
``Contacts.mesh_samples_dropped``. With ``hydroelastic=True`` each sample
moves to the surface where the two bodies' pressures balance, the
pressure kh_eff penetration is integrated over the finer-sampled side's
sample areas, the reduction keeps each cluster's force, and each slot's
stiffness (force over depth) goes to ``Contacts.rigid_contact_stiffness``.

Every class runs over the leading env axis of a batched state as well as
over a flat state's pairs; shape indices, SDF ids and slot offsets are
host constants, so nothing waits on the card. The pooled SDF grids and
textures are read corner by corner (``geometry/sdf.py``), never gathered
whole per pair.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..geometry.contact_reduction import (reduce_contact_set,
                                          reduce_contact_set_hydro)
from ..geometry.narrow_phase import _plane_sdf, pair_slot_count
from ..geometry.sdf import central_difference, sample_sdf_grid
from ..geometry.sdf_texture import sample_texture_sdf
from ..geometry.types import GeoType
from ..math import quat_rotate, transform_point, transform_point_inv

__all__ = ["install_mesh_classes", "mesh_contacts", "convex_contacts",
           "MESH_TYPES"]

_P, _S, _B = int(GeoType.PLANE), int(GeoType.SPHERE), int(GeoType.BOX)
_M, _CX, _HF = int(GeoType.MESH), int(GeoType.CONVEX), int(GeoType.HFIELD)
MESH_TYPES = (_M, _CX, _HF)
_ANALYTIC = (_P, _S, _B, int(GeoType.CAPSULE), int(GeoType.CYLINDER),
             int(GeoType.CONE), int(GeoType.ELLIPSOID))


def _safe_norm(x, eps: float = 1e-9):
    return torch.sqrt(torch.clamp((x * x).sum(-1), min=eps * eps))


class _Side:
    """One side of a class's pairs as the SDF it presents: its (n,)
    shapes' analytic kinds and scales, and which use a pooled grid or
    texture (host constants and their device tensors)."""

    def __init__(self, pipe, idx: np.ndarray, analytic_only: bool):
        model, st, L = pipe.model, pipe.model.structure, pipe._L
        dev = pipe.device
        typ = pipe._types[idx]
        self.idx = L(idx)
        self.scale = model.shape_scale[self.idx][:, None, :]     # (n, 1, 3)
        self.kind = [torch.as_tensor(typ == g, device=dev)[:, None]
                     for g in (_P, _S, _B)]
        sid = np.asarray(st.shape_sdf_id)[idx]
        tid = np.asarray(st.shape_sdf_tex_id)[idx]
        self.grid = self.tex = None
        if (not analytic_only and bool((sid >= 0).any())
                and model.sdf_grids.shape[0] > 0):
            s = L(np.maximum(sid, 0))
            self.grid = (s[:, None], model.sdf_lower[s][:, None, :],
                         model.sdf_upper[s][:, None, :],
                         torch.as_tensor(sid >= 0, device=dev)[:, None])
        if (not analytic_only and bool((tid >= 0).any())
                and model.sdf_tex_block_index.shape[0] > 0):
            t = L(np.maximum(tid, 0))
            self.tex = (t[:, None], model.sdf_tex_lower[t][:, None, :],
                        model.sdf_tex_upper[t][:, None, :],
                        torch.as_tensor(tid >= 0, device=dev)[:, None])


def _overlay_baked(model, p, d, g, grid, tex):
    """(d, g) at local points p (..., n, K, 3) with each row that has a
    pooled grid or texture reading it instead: its signed distance and
    unit central-difference gradient. ``grid`` and ``tex`` are None or
    (ids (n, 1), lower (n, 1, 3), upper (n, 1, 3), use (n, 1))."""
    def overlay(f, use, d, g):
        gr = central_difference(f, p)
        gr = gr / _safe_norm(gr)[..., None]
        return torch.where(use, f(p), d), torch.where(use[..., None], gr, g)
    if grid is not None:
        gid, lo, hi, use = grid
        d, g = overlay(lambda q: sample_sdf_grid(model.sdf_grids, lo, hi, q,
                                                 gid), use, d, g)
    if tex is not None:
        tid, lo, hi, use = tex
        d, g = overlay(lambda q: sample_texture_sdf(
            model.sdf_tex_block_index, model.sdf_tex_blocks,
            model.sdf_tex_scale, model.sdf_tex_offset, model.sdf_tex_coarse,
            lo, hi, q, tid), use, d, g)
    return d, g


def _sdf_of_side(model, side: _Side, p):
    """Signed distance (W, n, K) and unit outward gradient (W, n, K, 3) of
    the side's shapes at local points p (W, n, K, 3): analytic (a shape
    that is neither a plane, a sphere nor a box takes the capsule of its
    scale, the JAX package's model), the pooled grid where the shape has
    one, the pooled texture where it has one."""
    from .collide import _shape_sdf
    d, g = _shape_sdf(side.kind, p, side.scale)
    return _overlay_baked(model, p, d, g, side.grid, side.tex)


def sdf_of_mesh_rows(pipe, idx, p):
    """Signed distance and unit gradient of baked mesh and heightfield
    SDFs at local points p (n, K, 3), with per-call shape indices idx (n,)
    (dynamic-pair mode): each row reads its shape's grid or texture; a row
    with neither reads d = 1e9 and +Z."""
    model = pipe.model
    sid, tid = pipe._sdf_ids[idx], pipe._tex_ids[idx]
    d = torch.full(p.shape[:-1], 1e9, dtype=p.dtype, device=p.device)
    g = torch.zeros_like(p)
    g[..., 2] = 1.0
    grid = tex = None
    if model.sdf_grids.shape[0] > 0:
        s = torch.clamp(sid, min=0)
        grid = (s[:, None], model.sdf_lower[s][:, None],
                model.sdf_upper[s][:, None], (sid >= 0)[:, None])
    if model.sdf_tex_block_index.shape[0] > 0:
        t = torch.clamp(tid, min=0)
        tex = (t[:, None], model.sdf_tex_lower[t][:, None],
               model.sdf_tex_upper[t][:, None], (tid >= 0)[:, None])
    return _overlay_baked(model, p, d, g, grid, tex)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------
def _top(pen, k):
    """The k largest of pen (..., K) along K, ties to the lower index
    (``lax.top_k``'s order): (values, indices)."""
    v, i = torch.sort(pen, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _take(a, idx):
    return torch.gather(a, -2, idx[..., None].expand(*idx.shape,
                                                     a.shape[-1]))


def _dropped(active, k):
    """In-contact samples beyond k per pair, summed over the pairs of each
    env: (...) int32 over all but the last two axes."""
    over = torch.clamp(active.sum(-1, dtype=torch.int32) - k, min=0)
    return over.sum(-1, dtype=torch.int32)


def reduce_k(margin, pos, nrm, pen, k, thick):
    """k representatives of each pair's samples (pos, nrm (..., K, 3),
    pen (..., K), thick (..., 1)): the k deepest where K <= k, else the
    diverse greedy set. Returns (pos, nrm, depth, dropped)."""
    active = (pen + thick) > -margin
    dropped = _dropped(active, k)
    if k == 0:
        return pos[..., :0, :], nrm[..., :0, :], pen[..., :0], dropped
    if pen.shape[-1] <= k:
        v, i = _top(pen, k)
        return _take(pos, i), _take(nrm, i), v, torch.zeros_like(dropped)
    return (*reduce_contact_set(pos, nrm, pen, k, active=active), dropped)


def reduce_k_hydro(margin, pos, nrm, pen, fmag, k, thick):
    """:func:`reduce_k` keeping each cluster's force ``fmag`` (the patch
    integral); returns (pos, nrm, depth, f, dropped)."""
    active = (pen + thick) > -margin
    dropped = _dropped(active, k)
    if pen.shape[-1] <= k:
        v, i = _top(pen, k)
        f = torch.gather(torch.where(active, fmag, 0.0), -1, i)
        return _take(pos, i), _take(nrm, i), v, f, torch.zeros_like(dropped)
    return (*reduce_contact_set_hydro(pos, nrm, pen, fmag, k,
                                      active=active), dropped)


# ---------------------------------------------------------------------------
# static mode
# ---------------------------------------------------------------------------
def install_mesh_classes(pipe, pairs: np.ndarray, sel: np.ndarray) -> list:
    """The static mesh classes of the candidate pairs ``pairs[sel]`` (each
    with a mesh, hull or heightfield side), in the JAX package's class
    order and pair order. A pair of a mesh kind with a type that has no
    SDF here (an SDF shape) gets no class (the JAX package skips it)."""
    st = pipe.model.structure
    typ = pipe._types
    slots = np.asarray(st.candidate_pair_slots, dtype=np.int64)
    a, b = pairs[sel, 0], pairs[sel, 1]
    t0, t1 = typ[a], typ[b]
    in0, in1 = np.isin(t0, MESH_TYPES), np.isin(t1, MESH_TYPES)
    k = np.asarray([pair_slot_count(x, y) for x, y in zip(t0, t1)],
                   dtype=np.int64)
    sdf_id = np.asarray(st.shape_sdf_id)
    tex_id = np.asarray(st.shape_sdf_tex_id)
    cc = np.isin(t0, [_CX, _B]) & np.isin(t1, [_CX, _B]) & \
        ((t0 == _CX) | (t1 == _CX))
    mm = ~cc & in0 & in1
    ma0 = ~cc & ~mm & in0 & np.isin(t1, _ANALYTIC)
    ma1 = ~cc & ~mm & ~in0 & in1 & np.isin(t0, _ANALYTIC)
    mesh = np.where(ma1, b, a)
    other = np.where(ma1, a, b)
    t_other = np.where(ma1, t0, t1)
    bidir = ((sdf_id[mesh] >= 0) | (tex_id[mesh] >= 0)) & (t_other != _P)
    # class code: kind (0 cc, 1 mm, 2 ma), slots, bidir
    kind = np.select([cc, mm, ma0 | ma1], [0, 1, 2], -1)
    keep = kind >= 0
    code = (kind * 1024 + k) * 2 + (bidir & (kind == 2))
    code = np.where(keep, code, -1)
    classes = []
    if not keep.any():
        return classes
    uniq, first = np.unique(code[keep], return_index=True)
    kept = np.nonzero(keep)[0]
    for u in uniq[np.argsort(first)]:
        rows = kept[code[kept] == u]
        kd, kk, bd = int(u) // 2048, int(u) // 2 % 1024, bool(u % 2)
        pc = _mesh_class(pipe, kd, kk, kd == 1 or bd, mesh[rows],
                         other[rows], ~ma1[rows], slots[sel[rows]])
        pc.sel = sel[rows]
        classes.append(pc)
    return classes


def _mesh_class(pipe, kind, k, two_sided, mi, oi, mesh_first, offs):
    model, L, dev = pipe.model, pipe._L, pipe.device
    st = model.structure
    pc = SimpleNamespace(kind="cc" if kind == 0 else "mesh", slots=k,
                         two_sided=two_sided, n=len(mi))
    pc.mi, pc.oi = L(mi), L(oi)
    pc.out = L((offs[:, None] + np.arange(k)[None]).reshape(-1))
    pc.thick = (model.shape_thickness[pc.mi]
                + model.shape_thickness[pc.oi])[:, None]
    pc.mesh_first = torch.as_tensor(mesh_first, device=dev)[:, None, None]
    if kind == 0:
        hulls = pipe._hulls()
        pc.va, pc.vb = hulls[pc.mi], hulls[pc.oi]
        return pc
    pc.other = _Side(pipe, oi, analytic_only=not two_sided)
    if two_sided:
        pc.mesh = _Side(pipe, mi, analytic_only=False)
        typ = pipe._types
        sid = np.asarray(st.shape_sdf_id)
        tid = np.asarray(st.shape_sdf_tex_id)
        for s in np.unique(np.concatenate([mi, oi])):
            if typ[s] in MESH_TYPES and sid[s] < 0 and tid[s] < 0:
                raise ValueError(
                    f"mesh, hull or heightfield shape {int(s)} is the SDF "
                    "side of a contact pair but has no baked SDF; set "
                    "sdf_max_resolution on its shape config or route the "
                    "pair through the MPR convex path")
    if pipe.hydroelastic:
        kh = model.shape_material_kh
        pc.Em, pc.Eo = kh[pc.mi][:, None], kh[pc.oi][:, None]
        cell = np.asarray(st.shape_sample_cell_area)
        pc.finerA = torch.as_tensor(cell[mi] <= cell[oi],
                                    device=dev)[:, None]
    return pc


def mesh_contacts(pipe, pc, X_ws):
    """One static mesh class's contacts for world transforms X_ws
    (W, S, 7): (pos (W, n, k, 3), nrm from shape0 to shape1, depth
    (thickness added), stiffness (W, n, k) or None, dropped (W,))."""
    model = pipe.model
    margin = pipe.rigid_contact_margin
    X_m, X_o = X_ws[:, pc.mi, None, :], X_ws[:, pc.oi, None, :]
    pts_w = transform_point(X_m, model.shape_sample_points[pc.mi])
    p_in_o = transform_point_inv(X_o, pts_w)
    thick = pc.thick
    f_slots = None
    if pc.two_sided:
        dA, gA = _sdf_of_side(model, pc.other, p_in_o)
        outA = quat_rotate(X_o[..., 3:7], gA)               # out of other
        nA = -outA                                          # mesh -> other
        pts_w_o = transform_point(X_o, model.shape_sample_points[pc.oi])
        p_in_m = transform_point_inv(X_m, pts_w_o)
        dB, gB = _sdf_of_side(model, pc.mesh, p_in_m)
        outB = quat_rotate(X_m[..., 3:7], gB)               # out of mesh
        nB = outB
        half = pc.slots // 2
        if pipe.hydroelastic:
            # samples move to the equal-pressure surface: along the other
            # side's outward normal by pen kh_other / (kh_self + kh_other)
            Em, Eo = pc.Em, pc.Eo
            den = torch.clamp(Em + Eo, min=1e-12)
            pts_w = pts_w + outA * torch.clamp(-dA, min=0.0)[..., None] \
                * (Eo / den)[..., None]
            pts_w_o = pts_w_o + outB * torch.clamp(-dB, min=0.0)[..., None] \
                * (Em / den)[..., None]
            # each sample's force keff pen (its vector area along the
            # normal); the field is integrated over the finer side only
            keff = Em * Eo / den
            aA = torch.clamp(-(quat_rotate(
                X_m[..., 3:7], model.shape_sample_areas[pc.mi]) * outA
                ).sum(-1), min=0.0)
            aB = torch.clamp(-(quat_rotate(
                X_o[..., 3:7], model.shape_sample_areas[pc.oi]) * outB
                ).sum(-1), min=0.0)
            fA = keff * torch.clamp(-dA + thick, min=0.0) * aA
            fB = keff * torch.clamp(-dB + thick, min=0.0) * aB
            fin = pc.finerA
            pos, nrm, depth, f_slots, dropped = reduce_k_hydro(
                margin, torch.where(fin[..., None], pts_w, pts_w_o),
                torch.where(fin[..., None], nA, nB),
                torch.where(fin, -dA, -dB), torch.where(fin, fA, fB),
                pc.slots, thick)
        else:
            pA, qA, dpA, drA = reduce_k(margin, pts_w, nA, -dA, half, thick)
            pB, qB, dpB, drB = reduce_k(margin, pts_w_o, nB, -dB,
                                        pc.slots - half, thick)
            dropped = drA + drB
            pos = torch.cat([pA, pB], -2)
            nrm = torch.cat([qA, qB], -2)
            depth = torch.cat([dpA, dpB], -1)
        nrm = torch.where(pc.mesh_first, nrm, -nrm)
    else:
        d, g = _sdf_of_side(model, pc.other, p_in_o)
        n_w = quat_rotate(X_o[..., 3:7], g)                 # out of other
        if pipe.hydroelastic:
            Em, Eo = pc.Em, pc.Eo
            den = torch.clamp(Em + Eo, min=1e-12)
            pts_w = pts_w + n_w * torch.clamp(-d, min=0.0)[..., None] \
                * (Eo / den)[..., None]
            a = torch.clamp(-(quat_rotate(
                X_m[..., 3:7], model.shape_sample_areas[pc.mi]) * n_w
                ).sum(-1), min=0.0)
            fmag = Em * Eo / den * torch.clamp(-d + thick, min=0.0) * a
            pos, n_out, depth, f_slots, dropped = reduce_k_hydro(
                margin, pts_w, n_w, -d, fmag, pc.slots, thick)
        else:
            pos, n_out, depth, dropped = reduce_k(margin, pts_w, n_w, -d,
                                                  pc.slots, thick)
        nrm = torch.where(pc.mesh_first, -n_out, n_out)
    depth = depth + thick
    stiff = None
    if f_slots is not None:
        # the patch integral as a stiffness: c depth reproduces each
        # slot's force at the generating penetration; a margin slot keeps
        # a small stabilizing stiffness
        kh = model.shape_material_kh
        khm, kho = kh[pc.mi][:, None], kh[pc.oi][:, None]
        keff = khm * kho / torch.clamp(khm + kho, min=1e-12)
        stiff = torch.maximum(f_slots / torch.clamp(depth, min=1e-6),
                              keff * 1e-4)
    return pos, nrm, depth, stiff, dropped


def convex_contacts(pipe, pc, X_ws):
    """A hull-hull or hull-box class: the MPR manifold of the two vertex
    clouds, its first k points. Returns (pos, nrm, depth) (W, n, k)."""
    from ..geometry.mpr import convex_manifold
    W = X_ws.shape[0]
    Xa, Xb = X_ws[:, pc.mi], X_ws[:, pc.oi]
    pos, nrm, depth = convex_manifold(pc.va.expand(W, *pc.va.shape), Xa,
                                      pc.vb.expand(W, *pc.vb.shape), Xb)
    k = min(pc.slots, pos.shape[-2])
    return pos[..., :k, :], nrm[..., :k, :], depth[..., :k] + pc.thick


# ---------------------------------------------------------------------------
# dynamic-pair mode
# ---------------------------------------------------------------------------
def dynamic_class_code(t0: np.ndarray, t1: np.ndarray, k: np.ndarray):
    """Per pair of a mesh kind or an SDF shape the JAX package's dynamic
    class key as an int code, the kind names, each pair's kind, and
    whether a class takes it: plane-mesh ("pm", side, k), mesh-mesh
    ("mm2", k), mesh-primitive ("mp", other type, mesh first, k),
    plane-hull ("pc", side), hull support pairs (t0, t1); an SDF shape's
    pair has none."""
    mt = np.isin(t0, [_M, _HF]) | np.isin(t1, [_M, _HF])
    full0, full1 = np.isin(t0, [_M, _HF, _CX]), np.isin(t1, [_M, _HF, _CX])
    plane = (t0 == _P) | (t1 == _P)
    side = (t1 == _P).astype(np.int64)
    m0 = np.isin(t0, [_M, _HF])
    other = np.where(m0, t1, t0)
    prim_t = np.isin(other, [_S, _B, int(GeoType.CAPSULE),
                             int(GeoType.CYLINDER), int(GeoType.CONE),
                             int(GeoType.ELLIPSOID)])
    cx = (t0 == _CX) | (t1 == _CX)
    conds = [mt & plane, mt & ~plane & full0 & full1,
             mt & ~plane & ~(full0 & full1) & prim_t,
             ~mt & cx & plane, ~mt & cx & ~plane]
    kinds = ["plane_mesh", "mesh_mesh", "mesh_prim", "plane_convex", "hull"]
    codes = [(1 << 40) + side * 1024 + k,
             (2 << 40) + k,
             (3 << 40) + (other * 2 + m0) * 1024 + k,
             (4 << 40) + side,
             (5 << 40) + t0 * 64 + t1]
    code = np.select(conds, codes, -1)
    kind = np.select(conds, np.arange(len(kinds)), -1)
    return code, kind, kinds, kind >= 0


def dynamic_contacts(pipe, pc, i0, i1, X_ws):
    """One dynamic mesh-kind class's contacts for its selected pairs i0,
    i1 (cap,): (pos, nrm, depth (cap, k...), dropped samples ())."""
    model = pipe.model
    margin = pipe.rigid_contact_margin
    zero = torch.zeros((), dtype=torch.int32, device=X_ws.device)
    thick = (model.shape_thickness[i0] + model.shape_thickness[i1])[:, None]
    sp = model.shape_sample_points
    if pc.kind == "plane_convex":
        hulls = pipe._hulls()
        ip, ic = (i0, i1) if pc.plane_side == 0 else (i1, i0)
        verts = transform_point(X_ws[ic][:, None, :], hulls[ic])
        d, n_pl = _plane_sdf(X_ws[ip][:, None, :], verts)
        k = min(pc.k, d.shape[1])
        negd, sel = _top(-d, k)                             # deepest verts
        p_sel, d_sel = _take(verts, sel), -negd
        # padded hulls repeat vertices: drop a pick equal to an earlier one
        d2 = ((p_sel[:, :, None] - p_sel[:, None, :]) ** 2).sum(-1)
        lower = torch.ones(k, k, dtype=torch.bool,
                           device=d2.device).tril(-1)
        dup = ((d2 < 1e-12) & lower).any(-1)
        depth = torch.where(dup, -1e9, -d_sel)
        pos = p_sel - n_pl * (d_sel[..., None] * 0.5)
        nrm = n_pl.expand_as(pos)
        return pos, (-nrm if pc.plane_side == 1 else nrm), depth, zero
    if pc.kind == "plane_mesh":
        ip, im = (i0, i1) if pc.plane_side == 0 else (i1, i0)
        pts = transform_point(X_ws[im][:, None, :], sp[im])
        d, n_pl = _plane_sdf(X_ws[ip][:, None, :], pts)
        pos, nrm, depth, dr = reduce_k(margin, pts, n_pl.expand_as(pts), -d,
                                       pc.k, thick)
        return pos, (-nrm if pc.plane_side == 1 else nrm), depth, dr
    if pc.kind == "mesh_prim":
        from .collide import _shape_sdf
        im, io = (i0, i1) if pc.m_is_0 else (i1, i0)
        pts = transform_point(X_ws[im][:, None, :], sp[im])
        p_in_o = transform_point_inv(X_ws[io][:, None, :], pts)
        d, g = _shape_sdf(pc.other_kind, p_in_o,
                          model.shape_scale[io][:, None, :])
        n_w = quat_rotate(X_ws[io][:, None, 3:7], g)        # out of other
        if pc.bidir:
            half = pc.k // 2
            pA, qA, dA, rA = reduce_k(margin, pts, n_w, -d, half, thick)
            pts_o = transform_point(X_ws[io][:, None, :], sp[io])
            p_in_m = transform_point_inv(X_ws[im][:, None, :], pts_o)
            dm, gm = sdf_of_mesh_rows(pipe, im, p_in_m)
            n_m = quat_rotate(X_ws[im][:, None, 3:7], gm)   # out of mesh
            pB, qB, dB, rB = reduce_k(margin, pts_o, -n_m, -dm, pc.k - half,
                                      thick)
            pos, n_out = torch.cat([pA, pB], 1), torch.cat([qA, qB], 1)
            depth, dr = torch.cat([dA, dB], 1), rA + rB
        else:
            pos, n_out, depth, dr = reduce_k(margin, pts, n_w, -d, pc.k,
                                             thick)
        return pos, (-n_out if pc.m_is_0 else n_out), depth, dr
    if pc.kind == "mesh_mesh":
        pts0 = transform_point(X_ws[i0][:, None, :], sp[i0])
        d01, g01 = sdf_of_mesh_rows(
            pipe, i1, transform_point_inv(X_ws[i1][:, None, :], pts0))
        out1 = quat_rotate(X_ws[i1][:, None, 3:7], g01)
        pts1 = transform_point(X_ws[i1][:, None, :], sp[i1])
        d10, g10 = sdf_of_mesh_rows(
            pipe, i0, transform_point_inv(X_ws[i0][:, None, :], pts1))
        out0 = quat_rotate(X_ws[i0][:, None, 3:7], g10)
        half = pc.k // 2
        pA, qA, dA, rA = reduce_k(margin, pts0, -out1, -d01, half, thick)
        pB, qB, dB, rB = reduce_k(margin, pts1, out0, -d10, pc.k - half,
                                  thick)
        return (torch.cat([pA, pB], 1), torch.cat([qA, qB], 1),
                torch.cat([dA, dB], 1), rA + rB)
    # hull support pairs: hull clouds for hull sides, analytic otherwise
    from ..geometry.mpr import support_manifold
    from ..geometry.support import make_support, support_center
    t0, t1 = pc.types01
    hulls = pipe._hulls()
    v0 = hulls[i0] if t0 in (_CX, _M) else None
    v1 = hulls[i1] if t1 in (_CX, _M) else None
    s0, s1 = model.shape_scale[i0], model.shape_scale[i1]
    pos, nrm, depth = support_manifold(
        make_support(t0, X_ws[i0], s0, v0), make_support(t1, X_ws[i1], s1, v1),
        support_center(t0, X_ws[i0], s0, v0),
        support_center(t1, X_ws[i1], s1, v1))
    k = min(pc.k, pos.shape[1])
    if k < pos.shape[1]:
        depth, sel = _top(depth, k)
        pos, nrm = _take(pos, sel), _take(nrm, sel)
    return pos[:, :k], nrm[:, :k], depth[:, :k], zero


def check_dynamic_sdf(pipe, a: np.ndarray, b: np.ndarray) -> None:
    """Both sides of a dynamic mesh-mesh class sample into the other's
    SDF: each needs a bake."""
    st = pipe.model.structure
    has = (np.asarray(st.shape_sdf_id) >= 0) | \
        (np.asarray(st.shape_sdf_tex_id) >= 0)
    for s in np.unique(np.concatenate([a, b])):
        if not has[s]:
            raise ValueError(
                f"dynamic-pair mode: shape {int(s)} (type "
                f"{int(pipe._types[s])}) is an SDF contact side but has no "
                "baked SDF; set sdf_max_resolution on its shape config")
