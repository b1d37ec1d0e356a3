"""Static-mode collision pipeline, batched over envs (port of
``newton_tpu/sim/collide.py``: ``CollisionPipeline.__init__`` and
``collide``).

Candidate pairs and their contact slots are fixed at ``finalize``; pairs
are grouped by (GeoType, GeoType) class on the host, each class runs one
vectorized narrow-phase function over all its pairs and all envs, and the
results land at static slot offsets. The JAX package vmaps ``collide``
over the env axis; here the env axis W is written out: ``collide`` takes a
State with ``body_q (W, B, 7)`` and returns ``(W, C, ...)`` Contacts.
Only static mode with primitive pairs is ported: dynamic pair budgets,
mesh/SDF, soft and persistent-manifold modes raise.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Tuple

import numpy as np
import torch

from ..geometry.narrow_phase import contact_fn_for
from ..math import transform_multiply
from .contacts import Contacts
from .model import Model
from .state import State

__all__ = ["CollisionPipeline"]


class CollisionPipeline:
    """Precompiled static collision plan for one Model.

        pipeline = CollisionPipeline(model)
        contacts = pipeline.collide(state_b)        # state_b: (W, ...) State
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
        groups: Dict[Tuple[int, int, bool], dict] = {}
        for i, (a, b) in enumerate(st.candidate_pairs):
            t0, t1 = int(st.shape_type[a]), int(st.shape_type[b])
            fn, swapped, k = contact_fn_for(t0, t1)
            g = groups.setdefault((min(t0, t1), max(t0, t1), swapped),
                                  dict(fn=fn, swapped=swapped, slots=k,
                                       shape0=[], shape1=[], offsets=[]))
            g["shape0"].append(int(a))
            g["shape1"].append(int(b))
            g["offsets"].append(int(st.candidate_pair_slots[i]))

        def L(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int64), device=dev)

        self.classes = []
        for g in groups.values():
            i0, i1 = np.asarray(g["shape0"]), np.asarray(g["shape1"])
            a, b = (i1, i0) if g["swapped"] else (i0, i1)
            offs = (np.asarray(g["offsets"])[:, None]
                    + np.arange(g["slots"])[None, :])      # (n, K)
            self.classes.append(SimpleNamespace(
                fn=g["fn"], swapped=g["swapped"], a=L(a), b=L(b),
                s0=model.shape_scale[L(a)], s1=model.shape_scale[L(b)],
                r_sum=(model.shape_collision_radius[L(a)]
                       + model.shape_collision_radius[L(b)]),
                thick=(model.shape_thickness[L(i0)]
                       + model.shape_thickness[L(i1)]),
                slots=L(offs.reshape(-1)), n=len(i0), k=g["slots"]))

        C = self.rigid_contact_max
        slot_s0 = np.full(C, -1, np.int32)
        slot_s1 = np.full(C, -1, np.int32)
        for g in groups.values():
            for s0, s1, off in zip(g["shape0"], g["shape1"], g["offsets"]):
                slot_s0[off:off + g["slots"]] = s0
                slot_s1[off:off + g["slots"]] = s1
        self._slot_shape0 = torch.as_tensor(slot_s0, device=dev)
        self._slot_shape1 = torch.as_tensor(slot_s1, device=dev)
        sb = st.shape_body
        self._shape_body = L(np.maximum(sb, 0))
        self._shape_static = torch.as_tensor(sb < 0, device=dev)[:, None]
        self._identity = torch.as_tensor(
            [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=torch.float32,
            device=dev)

    def collide(self, state: State) -> Contacts:
        """Contacts for a batched State (``body_q (W, B, 7)``)."""
        model = self.model
        body_q = state.body_q
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
