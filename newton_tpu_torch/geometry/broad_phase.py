"""Runtime broad phases: shape AABBs, all pairs, sweep and prune (port of
``newton_tpu/geometry/broad_phase.py``).

The default pipeline takes its candidate pairs from ``finalize``; these
classes serve dynamic scenes: from the current AABBs they give a
fixed-capacity pair list every step, in a fixed order (stable sorts, no
atomics). Their collidability rule is the JAX broad phases' own
(``_should_collide_static``, which reads no contype/conaffinity), so the
pair sets are the JAX package's. SAP answers "may (a, b) collide?" by a
binary search in the sorted keys a S + b of the collidable pairs: no
(S, S) table.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..math import quat_to_matrix, transform_multiply
from .types import GeoType

__all__ = ["compute_shape_aabbs", "BroadPhaseAllPairs", "BroadPhaseSAP",
           "BroadPhaseExplicit"]


class AABBPlan:
    """What a model's shape AABBs and world transforms need, on its
    device, made once: each shape's body (0 where static), the static
    mask, and the per-type masks of ``compute_shape_aabbs``'s
    branch-free selection."""

    def __init__(self, model):
        st = model.structure
        t = np.asarray(st.shape_type)
        sb = np.asarray(st.shape_body, dtype=np.int64)
        dev = model.shape_transform.device
        self.model = model
        self.body = torch.as_tensor(np.maximum(sb, 0), device=dev)
        self.static = torch.as_tensor(sb < 0, device=dev)[:, None]
        self.identity = torch.tensor([0.0, 0, 0, 0, 0, 0, 1], device=dev)

        def m(*gts):
            return torch.as_tensor(np.isin(t, [int(g) for g in gts]),
                                   device=dev)[:, None]
        self.masks = [(k, v) for k, v in (
            ("sphere", m(GeoType.SPHERE)), ("box", m(GeoType.BOX)),
            ("capsule", m(GeoType.CAPSULE)),
            ("cyl", m(GeoType.CYLINDER, GeoType.CONE)),
            ("ell", m(GeoType.ELLIPSOID))) if bool(v.any())]

    def world_transforms(self, body_q):
        """World transform (..., S, 7) of every shape frame: its body's
        pose times its local offset (a static shape's authored transform);
        leading batch dims of body_q kept."""
        if self.model.body_count == 0:
            X_body = self.identity.expand(len(self.body), 7)
        else:
            X_body = torch.where(self.static, self.identity,
                                 body_q[..., self.body, :])
        return transform_multiply(X_body, self.model.shape_transform)


def compute_shape_aabbs(model, state, margin: float = 0.0, plan=None,
                        X_ws=None):
    """World AABBs (lo, hi) (S, 3) of every shape and the shapes' world
    transforms: exact extents for primitives (box |R| half; capsule,
    cylinder and cone the axis-projected half-height plus the radius
    across; ellipsoid the row norms of R diag(radii)), the collision
    radius for the other types and planes; ``margin`` added."""
    plan = plan or AABBPlan(model)
    if X_ws is None:
        X_ws = plan.world_transforms(state.body_q)
    center = X_ws[:, 0:3]
    s = model.shape_scale
    R = quat_to_matrix(X_ws[:, 3:7])                          # (S, 3, 3)
    az = R[:, :, 2].abs()
    r0, hh = s[:, 0:1], s[:, 1:2]
    ext = model.shape_collision_radius[:, None].expand_as(center)
    for kind, m in plan.masks:
        if kind == "sphere":
            e = r0.expand_as(center)
        elif kind == "box":
            e = (R.abs() * s[:, None, :]).sum(-1)
        elif kind == "capsule":
            e = az * hh + r0
        elif kind == "cyl":
            e = az * hh + torch.sqrt(torch.clamp(1.0 - az * az, min=0.0)) \
                * r0
        else:
            e = torch.sqrt((R * R * (s * s)[:, None, :]).sum(-1))
        ext = torch.where(m, e, ext)
    ext = ext + margin
    return center - ext, center + ext, X_ws


def _collidable_pairs(model, a, b):
    """The JAX broad phases' static collidability rule over index arrays
    (``_should_collide_static``): different bodies, not both static, both
    colliding with shapes, the same world or a global one, the collision
    groups' rule, and no filter pair."""
    from .types import ShapeFlags
    st = model.structure
    body = np.asarray(st.shape_body, dtype=np.int64)
    flags = np.asarray(st.shape_flags, dtype=np.int64)
    world = np.asarray(st.shape_world, dtype=np.int64)
    grp = np.asarray(st.shape_collision_group, dtype=np.int64)
    COLL = int(ShapeFlags.COLLIDE_SHAPES)
    ba, bb, wa, wb, ga, gb = body[a], body[b], world[a], world[b], grp[a], \
        grp[b]
    m = (ba != bb) & ~((ba < 0) & (bb < 0))
    m &= ((flags[a] & COLL) != 0) & ((flags[b] & COLL) != 0)
    m &= (wa == -1) | (wb == -1) | (wa == wb)
    m &= (ga != 0) & (gb != 0)
    m &= ~((ga > 0) & ~((ga == gb) | (gb < 0)))
    m &= ~((ga < 0) & (ga == gb))
    pairs = getattr(st, "shape_filter_pairs", set())
    if pairs:
        S = max(st.shape_count, 1)
        keys = np.fromiter((p * S + q for p, q in pairs), dtype=np.int64,
                           count=len(pairs))
        m &= ~np.isin(np.minimum(a, b) * S + np.maximum(a, b), keys)
    return m


class BroadPhaseAllPairs:
    """All-pairs AABB overlap among the collidable pairs: ``launch(state)``
    returns (pairs (k, 2) int32, mask): the overlapping pairs first, in
    candidate order (a stable sort), k = min(max_pairs, candidates)."""

    def __init__(self, model, max_pairs: Optional[int] = None,
                 margin: float = 0.01):
        self.model = model
        S = model.structure.shape_count
        self.max_pairs = max_pairs or max(4 * S, 64)
        self.margin = float(margin)
        iu = np.triu_indices(S, k=1)
        keep = _collidable_pairs(model, iu[0], iu[1])
        dev = model.shape_transform.device
        self.cand_a = torch.as_tensor(iu[0][keep], device=dev)
        self.cand_b = torch.as_tensor(iu[1][keep], device=dev)
        self._aabb = AABBPlan(model)

    def launch(self, state):
        lo, hi, _ = compute_shape_aabbs(self.model, state, self.margin,
                                        self._aabb)
        a, b = self.cand_a, self.cand_b
        overlap = ((lo[a] <= hi[b]) & (lo[b] <= hi[a])).all(-1)
        k = min(self.max_pairs, len(a))
        order = torch.sort((~overlap).to(torch.uint8), stable=True
                           ).indices[:k]
        pairs = torch.stack([a[order], b[order]], -1)
        return pairs.to(torch.int32), overlap[order]


class BroadPhaseSAP:
    """Sweep and prune along one axis: AABB minima sorted along ``axis``,
    each shape tested against its next ``window`` neighbours in that
    order. ``launch`` returns (pairs (S window, 2) int32 as (lower,
    higher) index, valid mask)."""

    def __init__(self, model, axis: int = 0, window: int = 16,
                 margin: float = 0.01):
        self.model = model
        self.axis = int(axis)
        self.window = int(window)
        self.margin = float(margin)
        S = model.structure.shape_count
        self.max_pairs = S * self.window
        iu = np.triu_indices(S, k=1)
        keep = _collidable_pairs(model, iu[0], iu[1])
        dev = model.shape_transform.device
        # the collidable pairs' keys a S + b (a < b), sorted: membership by
        # binary search instead of an (S, S) table
        self._keys = torch.as_tensor(iu[0][keep] * S + iu[1][keep],
                                     device=dev)
        self._aabb = AABBPlan(model)

    def launch(self, state):
        S = self.model.structure.shape_count
        lo, hi, _ = compute_shape_aabbs(self.model, state, self.margin,
                                        self._aabb)
        order = torch.sort(lo[:, self.axis], stable=True).indices
        k = torch.arange(1, self.window + 1, device=lo.device)
        j = torch.clamp(torch.arange(S, device=lo.device)[:, None] + k,
                        max=S - 1)                                # (S, w)
        a = order[:, None].expand(S, self.window)
        b = order[j]
        sweep = lo[b, self.axis] <= hi[a, self.axis]
        box = ((lo[a] <= hi[b]) & (lo[b] <= hi[a])).all(-1)
        lo_i, hi_i = torch.minimum(a, b), torch.maximum(a, b)
        ok = is_member(self._keys, lo_i * S + hi_i)
        valid = sweep & box & ok & (a != b)
        pairs = torch.stack([lo_i, hi_i], -1).reshape(-1, 2)
        return pairs.to(torch.int32), valid.reshape(-1)


class BroadPhaseExplicit:
    """The model's finalize-time candidate pairs, masked by AABB
    overlap."""

    def __init__(self, model, margin: float = 0.01):
        self.model = model
        dev = model.shape_transform.device
        p = np.asarray(model.structure.candidate_pairs,
                       dtype=np.int64).reshape(-1, 2)
        self.pairs = torch.as_tensor(p, device=dev)
        self.margin = float(margin)
        self._aabb = AABBPlan(model)

    def launch(self, state):
        lo, hi, _ = compute_shape_aabbs(self.model, state, self.margin,
                                        self._aabb)
        a, b = self.pairs[:, 0], self.pairs[:, 1]
        overlap = ((lo[a] <= hi[b]) & (lo[b] <= hi[a])).all(-1)
        return self.pairs.to(torch.int32), overlap


def is_member(sorted_keys, keys):
    """Whether each of ``keys`` occurs in the sorted 1-D ``sorted_keys``
    (int64), by binary search."""
    if sorted_keys.numel() == 0:
        return torch.zeros_like(keys, dtype=torch.bool)
    i = torch.clamp(torch.searchsorted(sorted_keys, keys),
                    max=sorted_keys.numel() - 1)
    return sorted_keys[i] == keys
