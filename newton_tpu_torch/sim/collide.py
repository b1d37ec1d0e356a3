"""Static-mode collision pipeline, batched over envs (port of
``newton_tpu/sim/collide.py``: ``CollisionPipeline.__init__`` and
``collide``).

Candidate pairs and their contact slots are fixed at ``finalize``; pairs
are grouped by (GeoType, GeoType) class on the host, each class runs one
vectorized narrow-phase function over all its pairs and all envs, and the
results land at static slot offsets. ``collide`` takes either the flat
state of a model (``body_q (B, 7)``, every world of a replicated model at
once, as the JAX package's ``collide``) and returns ``(C, ...)`` Contacts,
or a batched state (``body_q (W, B, 7)``, the env axis the JAX package
vmaps over written out) and returns ``(W, C, ...)`` Contacts. The plan is
built with array operations, so that a model of thousands of worlds
plans in well under a second. Particle-shape (soft) contacts run on a
flat state: one slot per candidate of ``ModelStructure.soft_pairs``, the
particle against the shape's signed distance (plane, sphere and box
exactly; every other type as the capsule of its scale, as the JAX
package does). Only static mode with primitive pairs is ported: dynamic
pair budgets, mesh/SDF and persistent-manifold modes raise, and so does a
batched state of a model with soft candidates.
"""

from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace
import numpy as np
import torch

from ..geometry.narrow_phase import _box_sdf_local, contact_fn_for
from ..geometry.types import GeoType
from ..math import quat_rotate, transform_multiply, transform_point_inv
from .contacts import Contacts
from .model import Model
from .state import State, map_tensors

__all__ = ["CollisionPipeline"]


class CollisionPipeline:
    """Precompiled static collision plan for one Model.

        pipeline = CollisionPipeline(model)
        contacts = pipeline.collide(state)      # flat state: (C,) Contacts
        contacts = pipeline.collide(state_b)    # (W, ...) state: (W, C)
    """

    def __init__(self, model: Model, rigid_contact_margin: float = 0.01,
                 soft_contact_margin: float = 0.01, mode: str = "auto",
                 dynamic_pair_budget=None,
                 persistent_manifolds: bool = False):
        self.model = model
        self.rigid_contact_margin = float(rigid_contact_margin)
        self.soft_contact_margin = float(soft_contact_margin)
        if persistent_manifolds:
            raise NotImplementedError(
                "persistent manifolds are not ported yet")
        st = model.structure
        self.rigid_contact_max = st.rigid_contact_max
        n_pairs = len(st.candidate_pairs)
        if dynamic_pair_budget is None:
            dynamic_pair_budget = max(64, 8 * st.shape_count)
        if mode == "auto":
            mode = "dynamic" if n_pairs > dynamic_pair_budget else "static"
        if mode != "static":
            raise NotImplementedError(
                f"collision mode {mode!r} is not ported yet (static only)")
        self.mode = mode

        dev = model.device

        def L(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)

        # one class per (type, type) combination of the pairs, in order of
        # first appearance; each runs its narrow phase on all its pairs
        pairs = np.asarray(st.candidate_pairs, dtype=np.int64).reshape(-1, 2)
        typ = np.asarray(st.shape_type, dtype=np.int64)
        t0, t1 = typ[pairs[:, 0]], typ[pairs[:, 1]]
        _, first, inv = np.unique(t0 * 64 + t1, return_index=True,
                                  return_inverse=True)
        self.classes = []
        for u in np.argsort(first):
            sel = np.nonzero(inv == u)[0]
            fn, swapped, k = contact_fn_for(int(t0[sel[0]]), int(t1[sel[0]]))
            i0, i1 = pairs[sel, 0], pairs[sel, 1]
            a, b = (i1, i0) if swapped else (i0, i1)
            offs = (np.asarray(st.candidate_pair_slots)[sel][:, None]
                    + np.arange(k)[None, :])                 # (n, K)
            self.classes.append(SimpleNamespace(
                fn=fn, swapped=swapped, a=L(a), b=L(b),
                s0=model.shape_scale[L(a)], s1=model.shape_scale[L(b)],
                r_sum=(model.shape_collision_radius[L(a)]
                       + model.shape_collision_radius[L(b)]),
                thick=(model.shape_thickness[L(i0)]
                       + model.shape_thickness[L(i1)]),
                slots=L(offs.reshape(-1)), n=len(sel), k=k))

        self._slot_shape0 = torch.as_tensor(
            np.asarray(st.slot_shape0, dtype=np.int32), device=dev)
        self._slot_shape1 = torch.as_tensor(
            np.asarray(st.slot_shape1, dtype=np.int32), device=dev)
        sb = st.shape_body
        self._shape_body = L(np.maximum(sb, 0))
        self._shape_static = torch.as_tensor(sb < 0, device=dev)[:, None]
        self._identity = torch.as_tensor(
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=torch.float32,
            device=dev)

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

    def collide(self, state: State) -> Contacts:
        """Contacts of a flat State (``body_q (B, 7)``: ``(C,)`` Contacts,
        with the soft contacts) or of a batched one (``body_q (W, B, 7)``:
        ``(W, C)``)."""
        if state.body_q.dim() == 2:
            out = map_tensors(self._collide(state.body_q[None]),
                              lambda t: t[0])
            if self.soft_contact_max:
                out = self._collide_soft(state, out)
            return out
        if self.soft_contact_max:
            raise NotImplementedError(
                "soft contacts of a batched (W, ...) state are not ported; "
                "collide the flat state")
        return self._collide(state.body_q)

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

    def _collide(self, body_q: torch.Tensor) -> Contacts:
        model = self.model
        W = body_q.shape[0]
        C = self.rigid_contact_max
        out = Contacts.zeros(C, (W,), dtype=body_q.dtype,
                             device=body_q.device)
        out.slots = model.structure
        out.rigid_contact_shape0 = self._slot_shape0.expand(W, C).clone()
        out.rigid_contact_shape1 = self._slot_shape1.expand(W, C).clone()
        if C == 0 or not self.classes:
            return out
        # world transform of every shape frame: body pose * local offset
        X_body = torch.where(self._shape_static, self._identity,
                             body_q[:, self._shape_body])
        X_ws = transform_multiply(X_body, model.shape_transform)  # (W, S, 7)
        margin = self.rigid_contact_margin
        for pc in self.classes:
            X0, X1 = X_ws[:, pc.a], X_ws[:, pc.b]
            pos, nrm, depth = pc.fn(X0, X1, pc.s0, pc.s1)   # (W, n, K, ...)
            if pc.swapped:
                nrm = -nrm          # restore shape0 -> shape1 orientation
            depth = depth + pc.thick[:, None]
            center_d = torch.linalg.vector_norm(
                X1[..., 0:3] - X0[..., 0:3], dim=-1)
            near = center_d < (pc.r_sum + margin)
            active = (depth > -margin) & near[..., None]
            nk = pc.n * pc.k
            out.rigid_contact_mask[:, pc.slots] = active.reshape(W, nk)
            out.rigid_contact_position[:, pc.slots] = pos.reshape(W, nk, 3)
            out.rigid_contact_normal[:, pc.slots] = nrm.reshape(W, nk, 3)
            out.rigid_contact_depth[:, pc.slots] = torch.where(
                active, depth, 0.0).reshape(W, nk)
        return out


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
