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
plans in well under a second. Only static mode with primitive pairs is
ported: dynamic pair budgets, mesh/SDF, soft and persistent-manifold modes
raise.
"""

from __future__ import annotations

from types import SimpleNamespace
import numpy as np
import torch

from ..geometry.narrow_phase import contact_fn_for
from ..math import transform_multiply
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
                 mode: str = "auto", dynamic_pair_budget=None,
                 persistent_manifolds: bool = False):
        self.model = model
        self.rigid_contact_margin = float(rigid_contact_margin)
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

    def collide(self, state: State) -> Contacts:
        """Contacts of a flat State (``body_q (B, 7)``: ``(C,)`` Contacts)
        or of a batched one (``body_q (W, B, 7)``: ``(W, C)``)."""
        if state.body_q.dim() == 2:
            return map_tensors(self._collide(state.body_q[None]),
                               lambda t: t[0])
        return self._collide(state.body_q)

    def _collide(self, body_q: torch.Tensor) -> Contacts:
        model = self.model
        W = body_q.shape[0]
        C = self.rigid_contact_max
        out = Contacts.zeros(C, (W,), dtype=body_q.dtype,
                             device=body_q.device)
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
