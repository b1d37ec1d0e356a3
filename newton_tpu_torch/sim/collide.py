"""Collision pipeline (port of ``newton_tpu/sim/collide.py``:
``CollisionPipeline``, ``match_contacts`` and ``collide``).

**Static mode.** Candidate pairs and their contact slots are fixed at
``finalize``; pairs are grouped by (GeoType, GeoType) class on the host,
each class runs one vectorized narrow-phase function over all its pairs
and all envs, and the results land at static slot offsets. ``collide``
takes either the flat state of a model (``body_q (B, 7)``, every world of
a replicated model at once, as the JAX package's ``collide``) and returns
``(C, ...)`` Contacts, or a batched state (``body_q (W, B, 7)``, the env
axis the JAX package vmaps over written out) and returns ``(W, C, ...)``
Contacts.

**Dynamic-pair mode** (``mode="dynamic"``, or ``"auto"`` when the
candidate pairs outnumber ``dynamic_pair_budget``, by default
max(64, 8 shapes)). Each finite type class keeps a budget of pair
entries, its share of ``dynamic_pair_budget``; every call the class's
overlapping candidates (exact world AABBs, ``geometry/broad_phase.py``)
are scored by their least overlap and the best fill the budget, selected
by one stable descending sort (``lax.top_k``'s order, ties to the lower
index). A plane class keeps every pair and culls by the shape centre's
height above the plane. The overlapping candidates that found no entry
are counted in ``Contacts.broad_phase_dropped``. ``broad_phase="sap"``
replaces the scoring of every candidate by a sweep and prune per class:
the class's shapes sorted by their AABB minimum along ``sap_axis`` (a
stable sort on the bound, then a stable sort on the world, so that each
world's shapes lie together in their own order), each tested against the
next ``sap_window`` shapes; whether a neighbour is a candidate pair of
the class is a binary search in the class's sorted pair keys. Which
shapes a slot holds changes from call to call (``Contacts.dynamic``):
``SolverXPBD`` takes such Contacts, the generalized solvers refuse them.

**Persistent manifolds** (``persistent_manifolds=True``): each slot
stores its contact's surface anchors in the two shapes' frames and the
normal in shape0's (``Contacts.custom["manifold:a0/a1/n0"]``); with the
previous call's Contacts as ``prev``, a slot that still holds the same
pair, whose anchors slid apart less than ``manifold_slide_tol`` times the
smaller collision radius, whose normal still agrees (cos > 0.98) and
whose gap stays within the margin keeps its anchored points.

Cones and ellipsoids against boxes, capsules, cylinders and cones run
through the support-map MPR of ``geometry/mpr.py``; the support pairs of
every class of a call run as one batch, each row with its own types'
support maps. Particle-shape (soft) contacts run on a flat state: one
slot per candidate of ``ModelStructure.soft_pairs``, the particle
against the shape's signed distance. Mesh, convex-hull, heightfield and
hydroelastic contacts raise (ROADMAP A.6), and so do a batched state with
dynamic mode, persistence or soft candidates.
"""

from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..geometry.broad_phase import (AABBPlan, compute_shape_aabbs,
                                    is_member)
from ..geometry.narrow_phase import (PRIMITIVE_FNS, _box_sdf_local,
                                     contact_fn_for)
from ..geometry.support import (keep_deepest, make_support_mixed,
                                support_center_mixed)
from ..geometry.types import GeoType
from ..math import (quat_rotate, quat_rotate_inv, transform_multiply,
                    transform_point, transform_point_inv)
from .contacts import Contacts
from .model import Model
from .state import State, map_tensors

__all__ = ["CollisionPipeline", "collide", "match_contacts"]

_UNPORTED = (GeoType.MESH, GeoType.SDF, GeoType.CONVEX, GeoType.HFIELD)


class CollisionPipeline:
    """Precompiled collision plan for one Model.

        pipeline = CollisionPipeline(model)
        contacts = pipeline.collide(state)      # flat state: (C,) Contacts
        contacts = pipeline.collide(state_b)    # (W, ...) state: (W, C)

        pipeline = CollisionPipeline(model, mode="dynamic",
                                     dynamic_pair_budget=8 * n_shapes,
                                     broad_phase="sap")
        pipeline = CollisionPipeline(model, persistent_manifolds=True)
        c = pipeline.contacts()
        c = pipeline.collide(state, prev=c)     # every substep
    """

    def __init__(self, model: Model, rigid_contact_margin: float = 0.01,
                 soft_contact_margin: float = 0.01,
                 hydroelastic: bool = False, mode: str = "auto",
                 dynamic_pair_budget: Optional[int] = None,
                 persistent_manifolds: bool = False,
                 manifold_slide_tol: float = 0.05,
                 broad_phase: str = "topk", sap_axis: int = 0,
                 sap_window: int = 16):
        self.model = model
        self.rigid_contact_margin = float(rigid_contact_margin)
        self.soft_contact_margin = float(soft_contact_margin)
        if hydroelastic:
            raise NotImplementedError(
                "hydroelastic contacts are not ported yet (ROADMAP A.6)")
        self.persistent_manifolds = bool(persistent_manifolds)
        self.manifold_slide_tol = float(manifold_slide_tol)
        if broad_phase not in ("topk", "sap"):
            raise ValueError(f"broad_phase must be 'topk' or 'sap', got "
                             f"{broad_phase!r}")
        self.broad_phase = broad_phase
        self.sap_axis = int(sap_axis)
        self.sap_window = int(sap_window)
        st = model.structure
        n_pairs = len(st.candidate_pairs)
        if dynamic_pair_budget is None:
            dynamic_pair_budget = max(64, 8 * st.shape_count)
        self.dynamic_pair_budget = int(dynamic_pair_budget)
        if mode == "auto":
            mode = "dynamic" if n_pairs > self.dynamic_pair_budget \
                else "static"
        if mode not in ("static", "dynamic"):
            raise ValueError(f"mode must be 'static', 'dynamic' or 'auto', "
                             f"got {mode!r}")
        self.mode = mode
        dev = self.device = model.device

        def L(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)
        self._L = L
        pairs = np.asarray(st.candidate_pairs, dtype=np.int64).reshape(-1, 2)
        typ = self._types = np.asarray(st.shape_type, dtype=np.int64)
        sb = st.shape_body
        self._aabb = AABBPlan(model)
        self._identity = self._aabb.identity

        # one class per (type, type) combination of the pairs, in order of
        # first appearance (the JAX package's class order and slot layout)
        t0, t1 = typ[pairs[:, 0]], typ[pairs[:, 1]]
        _, first, inv = np.unique(t0 * 64 + t1, return_index=True,
                                  return_inverse=True)
        self.classes = []
        for u in np.argsort(first):
            sel = np.nonzero(inv.reshape(-1) == u)[0]
            ta, tb = int(t0[sel[0]]), int(t1[sel[0]])
            for t in (ta, tb):
                if GeoType(t) in _UNPORTED:
                    raise NotImplementedError(
                        f"contacts of {GeoType(t).name} shapes are not "
                        "ported yet (mesh, convex hull, heightfield and SDF: "
                        "ROADMAP A.6)")
            fn, swapped, k = contact_fn_for(ta, tb)
            support = (ta, tb) not in PRIMITIVE_FNS and \
                (tb, ta) not in PRIMITIVE_FNS
            self.classes.append(SimpleNamespace(
                fn=fn, swapped=swapped, k=k, types01=(ta, tb),
                support=support, sel=sel, i0=pairs[sel, 0],
                i1=pairs[sel, 1], shape0=L(pairs[sel, 0]),
                shape1=L(pairs[sel, 1]), n=len(sel)))
        if mode == "dynamic":
            self._build_dynamic(model)
        else:
            self._build_static(model)

        # soft contacts: per candidate (particle, shape) the shape's frame
        # on its body and its signed-distance class
        sp = np.asarray(st.soft_pairs, dtype=np.int64).reshape(-1, 2)
        self.soft_contact_max = len(sp)
        if len(sp):
            si = sp[:, 1]
            t = typ[si]
            self.soft = SimpleNamespace(
                particle=L(sp[:, 0]),
                particle_i32=torch.as_tensor(sp[:, 0].astype(np.int32),
                                             device=dev),
                shape_i32=torch.as_tensor(si.astype(np.int32), device=dev),
                body=L(np.maximum(sb[si], 0)),
                static=torch.as_tensor(sb[si] < 0, device=dev)[:, None],
                X_local=model.shape_transform[L(si)],
                scale=model.shape_scale[L(si)],
                radius=model.particle_radius[L(sp[:, 0])],
                kind=[torch.as_tensor(t == int(g), device=dev)
                      for g in (GeoType.PLANE, GeoType.SPHERE,
                                GeoType.BOX)])

    # ------------------------------------------------------------------
    # planning
    # ------------------------------------------------------------------
    def _build_static(self, model: Model):
        """Each class's shape indices in its function's order and its
        slots (n k,) at the candidate pairs' static offsets."""
        st, L = model.structure, self._L
        self.rigid_contact_max = st.rigid_contact_max
        for pc in self.classes:
            a, b = (pc.i1, pc.i0) if pc.swapped else (pc.i0, pc.i1)
            offs = (np.asarray(st.candidate_pair_slots)[pc.sel][:, None]
                    + np.arange(pc.k)[None, :])                  # (n, K)
            pc.a, pc.b = L(a), L(b)
            pc.s0, pc.s1 = model.shape_scale[pc.a], model.shape_scale[pc.b]
            pc.r_sum = (model.shape_collision_radius[pc.a]
                        + model.shape_collision_radius[pc.b])
            pc.thick = (model.shape_thickness[L(pc.i0)]
                        + model.shape_thickness[L(pc.i1)])
            pc.slots = L(offs.reshape(-1))
        self._slot_shape0 = torch.as_tensor(
            np.asarray(st.slot_shape0, dtype=np.int32), device=self.device)
        self._slot_shape1 = torch.as_tensor(
            np.asarray(st.slot_shape1, dtype=np.int32), device=self.device)

    def _build_dynamic(self, model: Model):
        """Budgets and slot ranges of dynamic-pair mode: a plane class
        keeps all its pairs; the finite classes share the budget in
        proportion to their candidate counts (at least 8 entries each,
        at most their count)."""
        L, P = self._L, int(GeoType.PLANE)
        typ = self._types
        finite = [pc for pc in self.classes
                  if P not in pc.types01]
        n_total = sum(pc.n for pc in finite) or 1
        budget = self.dynamic_pair_budget
        offset = 0
        for pc in self.classes:
            pc.plane_side = (0 if pc.types01[0] == P else 1) \
                if P in pc.types01 else None
            pc.cap = pc.n if pc.plane_side is not None else min(
                pc.n, max(8, (budget * pc.n + n_total - 1) // n_total))
            pc.out = L(offset + np.arange(pc.cap * pc.k))        # (cap K,)
            offset += pc.cap * pc.k
            pc.sap = None
            if self.broad_phase == "sap" and pc.plane_side is None:
                pc.sap = self._build_sap(model, pc)
            if pc.plane_side is not None:
                pl, other = ((pc.i0, pc.i1) if pc.plane_side == 0
                             else (pc.i1, pc.i0))
                pc.plane, pc.other = L(pl), L(other)
                pc.r_other = model.shape_collision_radius[pc.other]
        self.rigid_contact_max = offset
        self._types_t = torch.as_tensor(typ, device=self.device)

    def _build_sap(self, model: Model, pc):
        """A class's SAP plan: its member shapes (sorted), their worlds,
        whether one is global (world -1: then one sort of every world, as
        the JAX package), and the sorted keys a S + b of its candidate
        pairs in both orders (the membership test; no (S, S) table)."""
        S = model.structure.shape_count
        world = np.asarray(model.structure.shape_world, dtype=np.int64)
        u = np.unique(np.concatenate([pc.i0, pc.i1]))
        keys = np.unique(np.concatenate([pc.i0 * S + pc.i1,
                                         pc.i1 * S + pc.i0]))
        L = self._L
        return SimpleNamespace(u=L(u), world=L(world[u]),
                               segment=not bool((world[u] < 0).any()),
                               keys=L(keys), m=len(u))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def contacts(self) -> Contacts:
        """A zeroed Contacts of this pipeline's capacity; with persistent
        manifolds its anchor buffers too (the ``prev`` of the first
        ``collide``)."""
        C, dev = self.rigid_contact_max, self.device
        out = Contacts.zeros(C, dtype=torch.float32, device=dev)
        self._stamp(out)
        if self.persistent_manifolds:
            z3 = torch.zeros(C, 3, dtype=torch.float32, device=dev)
            out.custom = {"manifold:a0": z3, "manifold:a1": z3.clone(),
                          "manifold:n0": z3.clone()}
        return out

    def collide(self, state: State, contacts: Optional[Contacts] = None,
                prev: Optional[Contacts] = None) -> Contacts:
        """Contacts of a flat State (``body_q (B, 7)``: ``(C,)`` Contacts,
        with the soft contacts) or of a batched one (``body_q (W, B, 7)``:
        ``(W, C)``; static mode without persistence or soft candidates).
        ``contacts`` is taken for the JAX package's signature and must
        have this pipeline's capacity; ``prev`` is the previous call's
        Contacts for persistent manifolds."""
        if contacts is not None and \
                contacts.rigid_contact_max != self.rigid_contact_max:
            raise ValueError(
                f"contacts hold {contacts.rigid_contact_max} rigid slots; "
                f"this pipeline fills {self.rigid_contact_max}")
        if state.body_q.dim() != 2:
            if self.mode != "static" or self.persistent_manifolds:
                raise NotImplementedError(
                    "dynamic-pair mode and persistent manifolds take a flat "
                    "State (the JAX package's collide is flat-only); "
                    "collide the flat state")
            if self.soft_contact_max:
                raise NotImplementedError(
                    "soft contacts of a batched (W, ...) state are not "
                    "ported; collide the flat state")
            return self._collide_static(state.body_q)
        if self.mode == "dynamic":
            out = self._collide_dynamic(state)
        else:
            out = map_tensors(self._collide_static(state.body_q[None]),
                              lambda t: t[0])
        if self.soft_contact_max:
            out = self._collide_soft(state, out)
        if self.persistent_manifolds:
            out = self._apply_persistence(state, out, prev)
        return out

    def _stamp(self, out: Contacts) -> Contacts:
        if self.mode == "dynamic":
            out.dynamic = True
        else:
            out.slots = self.model.structure
        return out

    # ------------------------------------------------------------------
    # narrow phase
    # ------------------------------------------------------------------
    def _narrow(self, X_ws, jobs):
        """Manifolds of several classes' pairs: ``jobs`` a list of (class,
        i0, i1) with i0/i1 (n,) shape indices in the class's type order.
        Returns per job (pos, nrm, depth) (..., n, K) with the normal from
        i0 to i1. The support classes' pairs run as one batch."""
        scale = self.model.shape_scale
        out = [None] * len(jobs)
        sup = []
        for j, (pc, i0, i1) in enumerate(jobs):
            a, b = (i1, i0) if pc.swapped else (i0, i1)
            if pc.support:
                sup.append((j, pc, a, b))
                continue
            pos, nrm, depth = pc.fn(X_ws[..., a, :], X_ws[..., b, :],
                                    scale[a], scale[b])
            out[j] = (pos, -nrm if pc.swapped else nrm, depth)
        if sup:
            a = torch.cat([x[2] for x in sup])
            b = torch.cat([x[3] for x in sup])
            ta = torch.cat([torch.full_like(x[2], min(x[1].types01))
                            for x in sup])
            tb = torch.cat([torch.full_like(x[3], max(x[1].types01))
                            for x in sup])
            lo = {min(x[1].types01) for x in sup}
            hi = {max(x[1].types01) for x in sup}
            Xa, Xb = X_ws[..., a, :], X_ws[..., b, :]
            sa = scale[a].expand(*Xa.shape[:-1], 3)
            sb = scale[b].expand(*Xb.shape[:-1], 3)
            from ..geometry.mpr import support_manifold
            pos, nrm, dep = support_manifold(
                make_support_mixed(ta, lo, Xa, sa),
                make_support_mixed(tb, hi, Xb, sb),
                support_center_mixed(ta, lo, Xa, sa),
                support_center_mixed(tb, hi, Xb, sb))
            kmax = max(x[1].k for x in sup)
            pos, nrm, dep = keep_deepest(pos, nrm, dep, kmax)
            r = 0
            for j, pc, a_, _ in sup:
                n = a_.shape[0]
                p, q, d = (pos[..., r:r + n, :pc.k, :],
                           nrm[..., r:r + n, :pc.k, :],
                           dep[..., r:r + n, :pc.k])
                out[j] = (p, -q if pc.swapped else q, d)
                r += n
        return out

    def _collide_static(self, body_q: torch.Tensor) -> Contacts:
        model = self.model
        W = body_q.shape[0]
        C = self.rigid_contact_max
        out = Contacts.zeros(C, (W,), dtype=body_q.dtype,
                             device=body_q.device)
        self._stamp(out)
        out.rigid_contact_shape0 = self._slot_shape0.expand(W, C).clone()
        out.rigid_contact_shape1 = self._slot_shape1.expand(W, C).clone()
        if C == 0 or not self.classes:
            return out
        X_ws = self._aabb.world_transforms(body_q)              # (W, S, 7)
        margin = self.rigid_contact_margin
        res = self._narrow(X_ws, [(pc, pc.shape0, pc.shape1)
                                  for pc in self.classes])
        for pc, (pos, nrm, depth) in zip(self.classes, res):
            depth = depth + pc.thick[:, None]
            center_d = torch.linalg.vector_norm(
                X_ws[:, pc.b, 0:3] - X_ws[:, pc.a, 0:3], dim=-1)
            near = center_d < (pc.r_sum + margin)
            active = (depth > -margin) & near[..., None]
            nk = pc.n * pc.k
            out.rigid_contact_mask[:, pc.slots] = active.reshape(W, nk)
            out.rigid_contact_position[:, pc.slots] = pos.reshape(W, nk, 3)
            out.rigid_contact_normal[:, pc.slots] = nrm.reshape(W, nk, 3)
            out.rigid_contact_depth[:, pc.slots] = torch.where(
                active, depth, 0.0).reshape(W, nk)
        return out

    # ------------------------------------------------------------------
    # dynamic-pair mode
    # ------------------------------------------------------------------
    def _select(self, pc, lo, hi, X_ws):
        """The class's selected pairs (i0, i1, near) (cap,) and the
        overlapping candidates beyond its budget."""
        if pc.sap is not None:
            return self._sap_candidates(pc, lo, hi)
        if pc.plane_side is not None:
            # the finite shape's centre height above the plane (its +Z),
            # not AABB overlap: an infinite plane's origin is arbitrary
            Xp = X_ws[pc.plane]
            ez = torch.zeros_like(Xp[:, 0:3])
            ez[:, 2] = 1.0
            h = (quat_rotate(Xp[:, 3:7], ez)
                 * (X_ws[pc.other, 0:3] - Xp[:, 0:3])).sum(-1)
            rsum = pc.r_other + self.rigid_contact_margin
            near = h < rsum
            score = torch.where(near, rsum - h, -torch.inf)
        else:
            a, b = pc.shape0, pc.shape1
            sep = (torch.minimum(hi[b], hi[a])
                   - torch.maximum(lo[b], lo[a])).min(-1).values
            near = sep > 0.0
            score = torch.where(near, sep, -torch.inf)
        dropped = torch.clamp(near.sum(dtype=torch.int32) - pc.cap, min=0)
        sel = _top(score, pc.cap)
        return pc.shape0[sel], pc.shape1[sel], near[sel], dropped

    def _sap_candidates(self, pc, lo, hi):
        """Windowed sweep and prune over the class's member shapes, each
        world's shapes sorted among themselves; the pairs oriented to the
        class's (t0, t1) types, as the JAX package's ``_sap_candidates``
        (the earlier of a same-type pair in the sweep first)."""
        sp, ax = pc.sap, self.sap_axis
        m = sp.m
        w = max(1, min(self.sap_window, m - 1))
        x = lo[sp.u, ax]
        order = torch.sort(x, stable=True).indices
        if sp.segment:
            order = order[torch.sort(sp.world[order], stable=True).indices]
        us = sp.u[order]
        idx = torch.arange(m, device=x.device)[:, None] + torch.arange(
            1, w + 1, device=x.device)                          # (m, w)
        inb = idx < m
        idxc = torch.clamp(idx, max=m - 1)
        a = us[:, None].expand(m, w)
        b = us[idxc]
        sweep = lo[b, ax] <= hi[a, ax]           # neighbour min <= my max
        sep = (torch.minimum(hi[b], hi[a])
               - torch.maximum(lo[b], lo[a])).min(-1).values      # (m, w)
        S = self.model.structure.shape_count
        mem = is_member(sp.keys, a * S + b)
        valid = inb & sweep & mem & (sep > 0.0)
        score = torch.where(valid, sep, -torch.inf).reshape(-1)
        n_near = valid.sum(dtype=torch.int32)
        k = min(pc.cap, m * w)
        sel = _top(score, k)
        af, bf = a.reshape(-1)[sel], b.reshape(-1)[sel]
        near = valid.reshape(-1)[sel]
        if k < pc.cap:
            pad = pc.cap - k
            af = torch.cat([af, af.new_zeros(pad)])
            bf = torch.cat([bf, bf.new_zeros(pad)])
            near = torch.cat([near, near.new_zeros(pad)])
        t0, t1 = pc.types01
        if t0 != t1:
            swap = self._types_t[af] != t0
            af, bf = torch.where(swap, bf, af), torch.where(swap, af, bf)
        return af, bf, near, torch.clamp(n_near - pc.cap, min=0)

    def _collide_dynamic(self, state: State) -> Contacts:
        model = self.model
        margin = self.rigid_contact_margin
        C = self.rigid_contact_max
        out = Contacts.zeros(C, dtype=state.body_q.dtype,
                             device=state.body_q.device)
        self._stamp(out)
        if C == 0:
            return out
        lo, hi, X_ws = compute_shape_aabbs(model, state, margin, self._aabb)
        picks = [self._select(pc, lo, hi, X_ws) for pc in self.classes]
        dropped = torch.stack([p[3] for p in picks]).sum(dtype=torch.int32)
        res = self._narrow(X_ws, [(pc, p[0], p[1])
                                  for pc, p in zip(self.classes, picks)])
        thick = model.shape_thickness
        for pc, (i0, i1, near, _), (pos, nrm, depth) in zip(
                self.classes, picks, res):
            depth = depth + (thick[i0] + thick[i1])[:, None]
            active = (depth > -margin) & near[:, None]
            idx = pc.out
            out.rigid_contact_mask[idx] = active.reshape(-1)
            out.rigid_contact_position[idx] = pos.reshape(-1, 3)
            out.rigid_contact_normal[idx] = nrm.reshape(-1, 3)
            out.rigid_contact_depth[idx] = torch.where(
                active, depth, 0.0).reshape(-1)
            out.rigid_contact_shape0[idx] = torch.where(
                active, i0[:, None].to(torch.int32), -1).reshape(-1)
            out.rigid_contact_shape1[idx] = torch.where(
                active, i1[:, None].to(torch.int32), -1).reshape(-1)
        out.broad_phase_dropped = dropped
        return out

    # ------------------------------------------------------------------
    # persistent manifolds
    # ------------------------------------------------------------------
    def _apply_persistence(self, state: State, out: Contacts,
                           prev: Optional[Contacts]) -> Contacts:
        """Anchor each slot's contact in its shapes' frames, and keep the
        previous call's anchored geometry where the slot holds the same
        pair, was active then and is now, the anchors slid less than
        tol = manifold_slide_tol min(r0, r1) along the fresh contact plane
        (slide^2 < tol^2), the normals agree (cos > 0.98), the gap along
        the fresh normal moved less than 2 margin + 0.1 tol, and it stays
        above -margin. A kept slot's point is its anchors' midpoint and
        its depth the gap; its normal stays the fresh one."""
        X_ws = self._aabb.world_transforms(state.body_q)
        s0 = torch.clamp(out.rigid_contact_shape0.long(), min=0)
        s1 = torch.clamp(out.rigid_contact_shape1.long(), min=0)
        X0, X1 = X_ws[s0], X_ws[s1]
        pos = out.rigid_contact_position
        nrm = out.rigid_contact_normal
        dep = out.rigid_contact_depth
        half = nrm * (dep * 0.5)[:, None]
        a0 = transform_point_inv(X0, pos + half)
        a1 = transform_point_inv(X1, pos - half)
        n0 = quat_rotate_inv(X0[:, 3:7], nrm)
        if prev is not None and "manifold:a0" in prev.custom:
            pa0 = transform_point(X0, prev.custom["manifold:a0"])
            pa1 = transform_point(X1, prev.custom["manifold:a1"])
            pn = quat_rotate(X0[:, 3:7], prev.custom["manifold:n0"])
            g = pa1 - pa0
            gn = (g * nrm).sum(-1)                 # signed gap (< 0 overlap)
            slide = g - nrm * gn[:, None]
            slide2 = (slide * slide).sum(-1)
            r = self.model.shape_collision_radius
            tol = self.manifold_slide_tol * torch.minimum(r[s0], r[s1])
            align = (pn * nrm).sum(-1)
            new_dep = -gn
            margin = self.rigid_contact_margin
            keep = (prev.rigid_contact_mask & out.rigid_contact_mask
                    & (prev.rigid_contact_shape0 == out.rigid_contact_shape0)
                    & (prev.rigid_contact_shape1 == out.rigid_contact_shape1)
                    & (slide2 < tol * tol) & (align > 0.98)
                    & ((new_dep - dep).abs() < 2.0 * margin + 0.1 * tol)
                    & (new_dep > -margin))
            k3 = keep[:, None]
            pos = torch.where(k3, (pa0 + pa1) * 0.5, pos)
            dep = torch.where(keep, new_dep, dep)
            a0 = torch.where(k3, prev.custom["manifold:a0"], a0)
            a1 = torch.where(k3, prev.custom["manifold:a1"], a1)
            n0 = torch.where(k3, prev.custom["manifold:n0"], n0)
        custom = dict(out.custom)
        custom.update({"manifold:a0": a0, "manifold:a1": a1,
                       "manifold:n0": n0})
        return replace(out, rigid_contact_position=pos,
                       rigid_contact_depth=dep, custom=custom)

    # ------------------------------------------------------------------
    # soft contacts
    # ------------------------------------------------------------------
    def _collide_soft(self, state: State, out: Contacts) -> Contacts:
        """Particle-shape contacts of a flat state: the particle's centre
        in the shape frame, the shape's signed distance d and outward
        gradient; depth = radius - d, active within the soft margin."""
        sc = self.soft
        if self.model.body_count == 0:
            X_body = self._identity.expand(len(sc.body), 7)
        else:
            X_body = torch.where(sc.static, self._identity,
                                 state.body_q[sc.body])
        X_ws = transform_multiply(X_body, sc.X_local)
        p = state.particle_q[sc.particle]
        d, g = _shape_sdf(sc.kind, transform_point_inv(X_ws, p), sc.scale)
        n_world = quat_rotate(X_ws[:, 3:7], g)
        depth = sc.radius - d
        active = depth > -self.soft_contact_margin
        return replace(
            out, soft_contact_mask=active,
            soft_contact_particle=sc.particle_i32,
            soft_contact_shape=sc.shape_i32,
            soft_contact_position=p - n_world * d[:, None],
            soft_contact_normal=n_world,
            soft_contact_depth=torch.where(active, depth, 0.0))


def _top(score, k: int):
    """Indices of the k largest scores, largest first and ties to the
    lower index (``lax.top_k``'s order): a stable descending sort."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def match_contacts(prev: Contacts, curr: Contacts):
    """Frame-to-frame contact correspondence and events, ``(matched, new,
    broken)`` slot masks: every contact of a static pipeline lives at a
    fixed slot, so correspondence is the identity."""
    matched = prev.rigid_contact_mask & curr.rigid_contact_mask
    new = curr.rigid_contact_mask & ~prev.rigid_contact_mask
    broken = prev.rigid_contact_mask & ~curr.rigid_contact_mask
    return matched, new, broken


def collide(model: Model, state: State,
            pipeline: Optional[CollisionPipeline] = None,
            contacts: Optional[Contacts] = None) -> Contacts:
    """One-shot collide: ``pipeline.collide(state, contacts)``, the
    pipeline built for the model when none is given."""
    if pipeline is None:
        pipeline = CollisionPipeline(model)
    return pipeline.collide(state, contacts)


def _safe_norm(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return torch.sqrt(torch.clamp((x * x).sum(-1), min=eps * eps))


def _shape_sdf(kind, p_local: torch.Tensor, scale: torch.Tensor):
    """Signed distance and outward gradient at local points (P, 3) of a
    plane (+Z), a sphere, a box, or else the capsule of the scale (radius
    s0, half-height s1 along Z); ``kind`` holds the (P,) plane, sphere and
    box masks. Every form is evaluated and one selected per point."""
    is_plane, is_sphere, is_box = kind
    r = _safe_norm(p_local)
    d_box, g_box = _box_sdf_local(p_local, scale)
    z = torch.minimum(torch.maximum(p_local[:, 2], -scale[:, 1]),
                      scale[:, 1])
    dc = p_local - torch.stack([torch.zeros_like(z), torch.zeros_like(z),
                                z], -1)
    dist_c = _safe_norm(dc)
    g_plane = torch.zeros_like(p_local)
    g_plane[:, 2] = 1.0
    d = torch.where(is_plane, p_local[:, 2],
                    torch.where(is_sphere, r - scale[:, 0],
                                torch.where(is_box, d_box,
                                            dist_c - scale[:, 0])))
    g = torch.where(is_plane[:, None], g_plane,
                    torch.where(is_sphere[:, None], p_local / r[:, None],
                                torch.where(is_box[:, None], g_box,
                                            dc / dist_c[:, None])))
    return d, g
