"""Generalized-coordinate solver (port of the constructor and batched entry
of ``newton_tpu/solvers/generalized/solver.py``: ``SolverFeatherstone``,
``SolverMuJoCo``).

Per substep: FK-derived dof subspaces, RNEA bias, applied and MJCF
actuator forces, CRBA, one factor/solve/invert of ``M + dt*Kd`` (kernel),
the contact/limit rows and one projected-Jacobi solve (kernel), semi-
implicit Euler on the coordinates, FK. The constructor turns every static
plan (dof tables, contact slots, limit rows, accumulation orders) into
index tensors on the model's device, so the substep builds nothing from
numpy and makes no host sync.

The port covers the single-articulation, static-contact, Euler path the
gymnasium ant runs; everything else raises ``NotImplementedError``.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ...core.types import MAXVAL
from ...sim.articulation import kinematic_tables
from ...sim.model import Model
from .actuation import ActuationTables
from .dynamics import get_generalized_cache

__all__ = ["SolverFeatherstone", "SolverMuJoCo"]


class _GroupContacts:
    """Static contact-slot plan of one articulation group row: slot
    indices (c,), local body indices lb0/lb1 (-1 = static shape)."""

    def __init__(self, slots, lb0, lb1):
        self.slots, self.lb0, self.lb1 = slots, lb0, lb1
        self.c = len(slots)


def _plan_group_contacts(st, groups):
    """Assign contact slots to the (single) articulation group. Slots whose
    bodies both belong to no group, cross-group and cross-env contacts and
    multi-articulation groups raise (not ported)."""
    S = len(st.slot_body0)
    if S == 0:
        return [None] * len(groups)
    g = groups[0]
    local = -np.ones(st.body_count, dtype=np.int32)
    local[g.body_idx[0]] = np.arange(g.b, dtype=np.int32)

    def look(b):
        return np.where(b >= 0, local[np.maximum(b, 0)], -1)

    lb0, lb1 = look(st.slot_body0), look(st.slot_body1)
    moving = (st.slot_body0 >= 0) | (st.slot_body1 >= 0)
    if not moving.all() or ((st.slot_body0 >= 0) & (lb0 < 0)).any() \
            or ((st.slot_body1 >= 0) & (lb1 < 0)).any():
        raise NotImplementedError(
            "contact slots outside the single articulation are not ported "
            "yet")
    return [_GroupContacts(np.arange(S, dtype=np.int32), lb0, lb1)]


def _accumulation_rounds(st, levels):
    """Child-to-parent accumulation order (deepest level first) split into
    rounds in which every parent appears at most once, so an indexed add
    needs no atomics and sums in the reference's sequential order."""
    rounds = []
    for level in reversed(levels):
        pb, cb = st.joint_parent[level], st.joint_child[level]
        has = pb >= 0
        src, dst = cb[has], pb[has]
        seen = {}
        rank = np.zeros(len(dst), dtype=np.int64)
        for i, p in enumerate(dst):
            rank[i] = seen.get(int(p), 0)
            seen[int(p)] = rank[i] + 1
        for k in range(int(rank.max()) + 1 if len(rank) else 0):
            rounds.append((src[rank == k], dst[rank == k]))
    return rounds


class SolverFeatherstone:
    """Batched generalized-coordinate dynamics with a projected-Jacobi
    contact solve (same defaults as the JAX package's)."""

    def __init__(self, model: Model,
                 contact_iterations: int = 16,
                 contact_relaxation: float = 0.85,
                 contact_reg: float = 1e-6,
                 impratio: float = 0.9,
                 baumgarte: float = 0.2,
                 contact_slop: float = 1e-4,
                 depenetration_velocity: float = 10.0,
                 friction_cone: str = "pyramid",
                 max_velocity: float = 1.0e3,
                 contact_cap: Optional[int] = None,
                 integrator: str = "euler",
                 warm_start: bool = False,
                 sleep_threshold: float = 0.0):
        integrator = str(integrator).lower()
        if integrator not in ("euler", "implicitfast", "implicit", "rk4"):
            raise ValueError(f"unknown integrator {integrator!r}")
        if integrator != "euler":
            raise NotImplementedError(
                f"integrator {integrator!r} is not ported yet (euler only); "
                "pass integrator='euler'")
        if warm_start:
            raise NotImplementedError("contact warm start is not ported yet")
        if sleep_threshold > 0.0:
            raise NotImplementedError("sleeping is not ported yet")
        if friction_cone not in ("pyramid", "cone"):
            raise ValueError(f"unknown friction_cone {friction_cone!r}")
        st = model.structure
        for what, n in (("equality constraints", st.eq_count),
                        ("tendons", st.tendon_count + st.sten_count)):
            if n:
                raise NotImplementedError(f"{what} are not ported yet")

        self.model = model
        self.integrator = integrator
        self.contact_iterations = int(contact_iterations)
        self.contact_relaxation = float(contact_relaxation)
        self.contact_reg = float(contact_reg)
        self.impratio = float(impratio)
        self.baumgarte = float(baumgarte)
        self.contact_slop = float(contact_slop)
        self.depenetration_velocity = float(depenetration_velocity)
        self.friction_cone = friction_cone
        self.max_velocity = float(max_velocity)
        self.contact_cap = contact_cap

        self.gc = gc = get_generalized_cache(st)
        if len(gc.groups) != 1 or gc.groups[0].n != 1:
            raise NotImplementedError(
                "multi-articulation worlds are not ported yet")
        if (gc.dof_ang_slot > 0).any():
            raise NotImplementedError(
                "multi-axis (D6) joints are not ported yet")
        self.contact_plans = _plan_group_contacts(st, gc.groups)
        g = gc.groups[0]
        ld, lc = [], []
        lim_lo = model.joint_limit_lower.cpu().numpy()
        lim_hi = model.joint_limit_upper.cpu().numpy()
        lin = dict(zip(gc.lin_coord_dof.tolist(), gc.lin_coord_idx.tolist()))
        for k, dglob in enumerate(g.dof_idx[0]):
            cglob = lin.get(int(dglob))
            if cglob is None:
                continue
            if lim_lo[dglob] > -0.5 * MAXVAL or lim_hi[dglob] < 0.5 * MAXVAL:
                ld.append(k)
                lc.append(int(cglob) - int(g.coord_idx[0][0]))
        self.limit_plans = [(np.asarray(ld, dtype=np.int32),
                             np.asarray(lc, dtype=np.int32))]
        plan = self.contact_plans[0]
        if plan is not None and self._plan_cap(plan.c) < plan.c:
            raise NotImplementedError(
                f"contact compaction (top-{self._plan_cap(plan.c)} of "
                f"{plan.c} slots) is not ported yet")
        au = getattr(st, "mjc_actuation", None)
        self.actuation = (ActuationTables(au, model.device)
                          if au is not None and au.n > 0 else None)
        self.tables = self._build_tables()

    def _plan_cap(self, c: int) -> int:
        """Resolved per-env contact cap for a plan with ``c`` slots."""
        cap = self.contact_cap
        if cap is None:
            return min(c, 32)
        if cap <= 0:
            return c
        return min(c, int(cap))

    def _build_tables(self) -> SimpleNamespace:
        """Every static index and per-model constant of the substep, on the
        model's device."""
        model = self.model
        st = model.structure
        gc = self.gc
        dev = model.device
        kin = kinematic_tables(model)

        def L(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        def B(a):
            return torch.as_tensor(np.asarray(a, dtype=bool), device=dev)

        def F(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32),
                                   device=dev)

        t = SimpleNamespace(identity=kin.identity)
        # dof subspace
        dj = gc.dof_joint
        t.dof_parent = L(np.maximum(st.joint_parent[dj], 0))
        t.dof_hasp = B(st.joint_parent[dj] >= 0)[:, None]
        t.dof_X_p = model.joint_X_p[L(dj)]
        t.model_axis = model.joint_axis      # single-axis joints: untransported
        t.dof_body = L(gc.dof_body)
        t.dof_com = model.body_com[t.dof_body]
        t.dof_is_com = B(gc.dof_anchor_is_com)[:, None]
        t.dof_is_lin = B(gc.dof_is_linear)[:, None]
        # bias forces: forward levels and backward accumulation rounds
        t.levels = []
        for level in gc.kc.levels:
            pb, cb = st.joint_parent[level], st.joint_child[level]
            t.levels.append((L(np.maximum(pb, 0)), L(cb),
                             B(pb >= 0)[:, None]))
        t.rounds = [(L(s), L(d)) for s, d in
                    _accumulation_rounds(st, gc.kc.levels)]
        # gravity as the base acceleration [-g, 0] of every body (one world)
        g = model.gravity[L(np.zeros(st.body_count))]          # (B, 3)
        t.base_acc = torch.cat([-g, torch.zeros_like(g)], -1)
        # applied forces (PD drives on linear coordinates)
        t.lin_idx, t.lin_dof = L(gc.lin_coord_idx), L(gc.lin_coord_dof)
        t.pd_ke = model.joint_target_ke[t.lin_dof]
        t.pd_kd = model.joint_target_kd[t.lin_dof]
        # group row
        g = gc.groups[0]
        t.di, t.bi = L(g.dof_idx[0]), L(g.body_idx[0])
        t.anc = F(g.anc)                                   # (b, d)
        t.armature = model.joint_armature[t.di]
        # contact rows
        plan = self.contact_plans[0]
        if plan is not None:
            anc = np.asarray(g.anc, dtype=np.float32)
            zero = np.zeros((g.d,), dtype=np.float32)
            anc1 = np.where((plan.lb1 >= 0)[:, None],
                            anc[np.maximum(plan.lb1, 0)], zero)
            anc0 = np.where((plan.lb0 >= 0)[:, None],
                            anc[np.maximum(plan.lb0, 0)], zero)
            t.slots = L(plan.slots)
            t.sign = F(anc1 - anc0)                        # (c, d)
            t.gb0 = L(g.body_idx[0][np.maximum(plan.lb0, 0)])
            t.gb1 = L(g.body_idx[0][np.maximum(plan.lb1, 0)])
            t.on0 = B(plan.lb0 >= 0)[:, None]
            t.on1 = B(plan.lb1 >= 0)[:, None]
            s0 = L(np.maximum(st.slot_shape0, 0))
            s1 = L(np.maximum(st.slot_shape1, 0))
            t.mu = (0.5 * (model.shape_material_mu[s0]
                           + model.shape_material_mu[s1]))[t.slots]
            t.e_rest = (0.5 * (model.shape_material_restitution[s0]
                               + model.shape_material_restitution[s1])
                        )[t.slots]
        # limit rows
        ld, lc = self.limit_plans[0]
        t.nl = len(ld)
        t.ld = L(ld)
        t.ld_i32 = torch.as_tensor(ld.astype(np.int32), device=dev)
        t.lim_coord = L(g.coord_idx[0][lc]) if len(ld) else L([])
        t.lim_lo = model.joint_limit_lower[t.di[t.ld]]
        t.lim_hi = model.joint_limit_upper[t.di[t.ld]]
        # integration
        fj = gc.free_joints
        t.free_p = L(fj[:, 0:1] + np.arange(3)[None])
        t.free_q = L(fj[:, 0:1] + np.arange(3, 7)[None])
        t.free_v = L(fj[:, 1:2] + np.arange(3)[None])
        t.free_w = L(fj[:, 1:2] + np.arange(3, 6)[None])
        t.free_com = model.body_com[L(fj[:, 2])]
        t.vel_limit = model.joint_velocity_limit
        return t

    def step_batched(self, state_b, state_out=None, control_b=None,
                     contacts_b=None, dt: float = 1e-3, kernels: bool = True,
                     record: Optional[dict] = None):
        """One substep over a leading env axis (see batched.step_batched)."""
        from .batched import step_batched
        return step_batched(self, state_b, control_b, contacts_b, dt,
                            kernels=kernels, record=record)


class SolverMuJoCo(SolverFeatherstone):
    """The reference's MuJoCo-flavoured front end: ``iterations`` sets the
    contact iterations and ``integrator="auto"`` reads the MJCF
    ``<option integrator=...>`` captured at import (RK4 for gymnasium's
    ant, which raises here: only euler is ported)."""

    def __init__(self, model: Model, iterations: int = 16,
                 integrator: str = "auto", **kwargs):
        integ = str(integrator).lower()
        if integ == "auto":
            integ = model.structure.mjc_options.get("integrator", "euler")
        super().__init__(model, contact_iterations=iterations,
                         integrator=integ, **kwargs)
