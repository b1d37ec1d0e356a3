"""Generalized-coordinate solver (port of the constructor and the two
entries of ``newton_tpu/solvers/generalized/solver.py``:
``SolverFeatherstone``, ``SolverMuJoCo``).

Per substep: FK-derived dof subspaces, RNEA bias, applied and MJCF
actuator forces, CRBA, one factor/solve/invert of ``M + dt*Kd`` (kernel),
the contact/limit rows and one projected-Jacobi solve (kernel), semi-
implicit Euler on the coordinates, FK. The constructor turns every static
plan (dof tables, contact slots, limit rows, accumulation orders) into
index tensors on the model's device, so the substep builds nothing from
numpy and makes no host sync.

The row view: the model's articulations form one group of identical rows
(one row per world of a replicated model, one row for a one-world model).
The substep tables describe one row in local indices (``row_model``), so
building them costs the same at 8192 worlds as at one; ``step`` gathers
every row of a flat multi-world state into the env-major layout through
the group's row tables, runs the substep with one env per row, and
scatters back; ``step_batched`` runs the same substep on a one-world
model's ``(W, ...)`` envs. The port covers the static-contact, Euler path
of the gymnasium ant, humanoid and cartpole (D6 hinge and prismatic
joints, fixed tendons, top-K contact compaction); more than one group,
rows that differ in their constants, heterogeneous contact plans,
contacts across rows and everything else raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import fields, replace
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ...core.types import MAXVAL
from ...sim.articulation import kinematic_tables
from ...sim.model import Model, ModelStructure
from .actuation import MJCActuation, ActuationTables
from .dynamics import get_generalized_cache

__all__ = ["SolverFeatherstone", "SolverMuJoCo", "row_model"]


class _GroupContacts:
    """Static contact-slot plan of an articulation group: slot indices
    (n, c), one row per group row, and the local body indices lb0/lb1
    (c,) that every row shares (-1 = static shape)."""

    def __init__(self, slots, lb0, lb1):
        self.slots, self.lb0, self.lb1 = slots, lb0, lb1
        self.c = slots.shape[1]


def _body_env_tables(groups, n_body):
    """Flat body -> (group, row, local body) lookup arrays, vectorized over
    the rows (the JAX package's ``_body_env_tables``)."""
    gi_of = -np.ones(n_body, dtype=np.int32)
    e_of = -np.ones(n_body, dtype=np.int32)
    lb_of = -np.ones(n_body, dtype=np.int32)
    for gi, g in enumerate(groups):
        bi = np.asarray(g.body_idx)                            # (n, b)
        gi_of[bi] = gi
        e_of[bi] = np.arange(g.n, dtype=np.int32)[:, None]
        lb_of[bi] = np.arange(bi.shape[1], dtype=np.int32)[None, :]
    return gi_of, e_of, lb_of


def _plan_group_contacts(st, groups):
    """Assign contact slots to the rows of the (single) group, as the JAX
    package's ``_plan_group_contacts`` does (solver.py:125-220): a slot
    belongs to the row of its body1, else of its body0, and each row takes
    its slots in ascending order. Only the homogeneous plan is ported: the
    same number of slots in every row with the same local bodies. Slots
    that no articulation owns, slots between two rows (the reference's
    two-sided "ob" entries) and heterogeneous plans raise."""
    S = len(st.slot_body0)
    if S == 0:
        return [None] * len(groups)
    g = groups[0]
    gi_of, e_of, lb_of = _body_env_tables(groups, st.body_count)

    def look(b):
        bc = np.maximum(b, 0)
        return tuple(np.where(b >= 0, t[bc], -1)
                     for t in (gi_of, e_of, lb_of))
    b0 = np.asarray(st.slot_body0)
    b1 = np.asarray(st.slot_body1)
    g0, e0, l0 = look(b0)
    g1, e1, l1 = look(b1)
    owner_g = np.where(g1 >= 0, g1, g0)
    owner_e = np.where(g1 >= 0, e1, e0)
    if (owner_g < 0).any() or ((b0 >= 0) & (g0 < 0)).any():
        raise NotImplementedError(
            "contact slots of bodies outside the articulations are not "
            "ported yet")
    if ((g0 >= 0) & ((g0 != owner_g) | (e0 != owner_e))).any():
        raise NotImplementedError(
            "contacts between two articulations or two worlds (two-sided "
            "contact rows) are not ported yet")
    order = np.argsort(owner_e, kind="stable")
    counts = np.bincount(owner_e, minlength=g.n)
    c = int(counts[0])
    if counts.min() != counts.max():
        raise NotImplementedError(
            "heterogeneous contact plans (rows with different slot counts) "
            "are not ported yet")
    slots = order.reshape(g.n, c).astype(np.int32)
    lb0 = np.where(g0 >= 0, l0, -1)[slots]
    lb1 = np.where(g1 >= 0, l1, -1)[slots]
    if not ((lb0 == lb0[0]).all() and (lb1 == lb1[0]).all()):
        raise NotImplementedError(
            "heterogeneous contact plans (rows whose slots join different "
            "bodies) are not ported yet")
    return [_GroupContacts(slots, lb0[0].astype(np.int32),
                           lb1[0].astype(np.int32))]


def _entity_rows(owner_row, n, what):
    """(n, k) entity indices per row, in ascending order, for entities
    whose row is ``owner_row`` (-1: in no row, which raises)."""
    if (owner_row < 0).any():
        raise NotImplementedError(f"{what} outside the articulations are "
                                  "not ported yet")
    counts = np.bincount(owner_row, minlength=n)
    if counts.min() != counts.max():
        raise NotImplementedError(f"rows with different numbers of {what} "
                                  "are not ported yet")
    return np.argsort(owner_row, kind="stable").reshape(n, -1)


def _check_rows(name, a):
    """Raise unless every row of (n, ...) equals row 0."""
    if len(a) and not (a == a[:1]).all():
        raise NotImplementedError(
            f"worlds whose articulations differ in {name} are not ported "
            "yet (heterogeneous worlds)")


def row_model(model: Model, g, tendon_rows, act_rows) -> Model:
    """Row 0 of articulation group ``g`` as a one-world Model in local
    indices: its bodies, joints, dofs and coordinates, the tendons and
    actuators of ``tendon_rows[0]``/``act_rows[0]``, no shapes and no
    particles. The substep's tables are built on it."""
    st = model.structure
    a0 = int(g.arts[0])
    j0, j1 = int(st.articulation_start[a0]), int(st.articulation_start[a0 + 1])
    js = np.arange(j0, j1)
    bi, di, ci = g.body_idx[0], g.dof_idx[0], g.coord_idx[0]
    local_body = -np.ones(st.body_count, dtype=np.int64)
    local_body[bi] = np.arange(len(bi))
    parent = st.joint_parent[js]
    if ((parent >= 0) & (local_body[np.maximum(parent, 0)] < 0)).any():
        raise NotImplementedError(
            "articulations attached to a body of another articulation are "
            "not ported yet")
    rst = ModelStructure()
    rst.body_count, rst.joint_count = len(bi), len(js)
    rst.joint_coord_count, rst.joint_dof_count = len(ci), len(di)
    rst.articulation_count = 1
    i32 = np.int32
    rst.joint_type = st.joint_type[js].astype(i32)
    rst.joint_parent = np.where(parent >= 0,
                                local_body[np.maximum(parent, 0)],
                                -1).astype(i32)
    rst.joint_child = local_body[st.joint_child[js]].astype(i32)
    rst.joint_q_start = (st.joint_q_start[j0:j1 + 1] - ci[0]).astype(i32)
    rst.joint_qd_start = (st.joint_qd_start[j0:j1 + 1] - di[0]).astype(i32)
    rst.joint_dof_dim = st.joint_dof_dim[js].astype(i32)
    pj = st.joint_parent_joint[js]
    rst.joint_parent_joint = np.where(pj >= 0, pj - j0, -1).astype(i32)
    rst.joint_world = np.full(len(js), -1, i32)
    rst.articulation_start = np.asarray([0, len(js)], i32)
    rst.articulation_world = np.full(1, -1, i32)
    rst.body_world = np.full(len(bi), -1, i32)
    # fixed tendons of the row: local coordinates and dofs (a padding
    # entry, coef 0, keeps index 0)
    tr = tendon_rows[0]
    coef = st.tendon_coef[tr]
    rst.tendon_count = len(tr)
    rst.tendon_coef = coef
    rst.tendon_coord = np.where(coef != 0, st.tendon_coord[tr] - ci[0],
                                0).astype(i32)
    rst.tendon_dof = np.where(coef != 0, st.tendon_dof[tr] - di[0],
                              0).astype(i32)
    au = st.mjc_actuation
    if au is not None and au.n:
        ar = act_rows[0]
        rau = MJCActuation(len(ar))
        for name in MJCActuation.__slots__:
            v = getattr(au, name)
            if isinstance(v, np.ndarray):
                setattr(rau, name, v[ar].copy())
        rau.dof = (au.dof[ar] - di[0]).astype(i32)
        rau.coord = (au.coord[ar] - ci[0]).astype(i32)
        rst.mjc_actuation = rau.finish()
    rst.mjc_options = dict(st.mjc_options)

    def L(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=model.device)
    w = max(int(st.articulation_world[a0]), 0)
    # each tensor field by the entities it is per: bodies, joints, dofs,
    # coordinates, tendons, the row's world; no shapes and no particles
    take = {"joint_X_p": L(js), "joint_X_c": L(js), "joint_q0": L(ci),
            "joint_target_q0": L(ci), "tendon_params": L(tr),
            "gravity": L([w])}
    kw = {}
    for f in fields(model):
        v = getattr(model, f.name)
        if not isinstance(v, torch.Tensor):
            continue
        if f.name in ("joint_type_arr", "joint_parent", "joint_child"):
            v = torch.as_tensor(getattr(rst, f.name.replace("_arr", "")),
                                device=v.device)
        elif f.name in take:
            v = v[take[f.name]]
        elif f.name.startswith("body_"):
            v = v[L(bi)]
        elif f.name.startswith("joint_"):
            v = v[L(di)]
        else:
            v = v[:0]
        kw[f.name] = v
    return Model(custom={}, structure=rst, **kw)


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
                        ("spatial tendons", st.sten_count)):
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

        gc = get_generalized_cache(st)
        if len(gc.groups) != 1:
            raise NotImplementedError(
                "multi-articulation worlds (more than one articulation "
                "group) are not ported yet")
        self.group = g = gc.groups[0]
        if g.n * g.d != st.joint_dof_count:
            raise NotImplementedError(
                "joints outside the articulations are not ported yet")
        self.contact_plans = _plan_group_contacts(st, gc.groups)
        # the tendons and actuators of each row, (n, T) and (n, A)
        coord_row = -np.ones(st.joint_coord_count, dtype=np.int64)
        coord_row[g.coord_idx] = np.arange(g.n)[:, None]
        dof_row = -np.ones(st.joint_dof_count, dtype=np.int64)
        dof_row[g.dof_idx] = np.arange(g.n)[:, None]
        self.tendon_rows = (
            _entity_rows(coord_row[st.tendon_coord[:, 0]], g.n,
                         "fixed tendons") if st.tendon_count
            else np.zeros((g.n, 0), dtype=np.int64))
        au = st.mjc_actuation
        self.act_rows = (_entity_rows(dof_row[au.dof], g.n, "actuators")
                         if au is not None and au.n
                         else np.zeros((g.n, 0), dtype=np.int64))
        self._check_homogeneous()
        self.row_model = rm = row_model(model, g, self.tendon_rows,
                                        self.act_rows)
        # step_batched takes a one-world model that is its row: every body
        # and coordinate in its articulation, in order
        self._model_is_row = g.n == 1 and all(
            np.array_equal(idx[0], np.arange(total)) for idx, total in (
                (g.body_idx, st.body_count), (g.dof_idx, st.joint_dof_count),
                (g.coord_idx, st.joint_coord_count)))
        rgc = get_generalized_cache(rm.structure)
        rg = rgc.groups[0]
        ld, lc = [], []
        lim_lo = rm.joint_limit_lower.cpu().numpy()
        lim_hi = rm.joint_limit_upper.cpu().numpy()
        lin = dict(zip(rgc.lin_coord_dof.tolist(),
                       rgc.lin_coord_idx.tolist()))
        for k in range(rg.d):
            c = lin.get(k)
            if c is not None and (lim_lo[k] > -0.5 * MAXVAL
                                  or lim_hi[k] < 0.5 * MAXVAL):
                ld.append(k)
                lc.append(c)
        self.limit_plans = [(np.asarray(ld, dtype=np.int32),
                             np.asarray(lc, dtype=np.int32))]
        rau = rm.structure.mjc_actuation
        self.actuation = (ActuationTables(rau, model.device)
                          if rau is not None and rau.n > 0 else None)
        self.gc = rgc
        self.tables = self._build_tables()

    def _check_homogeneous(self):
        """Every row must share row 0's constants: the substep's tables
        hold one row."""
        model, st, g = self.model, self.model.structure, self.group

        def rows(t, idx):
            return t.detach().cpu().numpy()[idx]
        a0 = st.articulation_start[g.arts]
        jrows = a0[:, None] + np.arange(st.articulation_start[g.arts[0] + 1]
                                        - a0[0])[None]
        for name, idx in (("body_com", g.body_idx), ("body_mass", g.body_idx),
                          ("body_inertia", g.body_idx),
                          ("joint_X_p", jrows), ("joint_X_c", jrows),
                          ("joint_axis", g.dof_idx),
                          ("joint_armature", g.dof_idx),
                          ("joint_target_ke", g.dof_idx),
                          ("joint_target_kd", g.dof_idx),
                          ("joint_limit_lower", g.dof_idx),
                          ("joint_limit_upper", g.dof_idx),
                          ("joint_velocity_limit", g.dof_idx),
                          ("tendon_params", self.tendon_rows)):
            _check_rows(name, rows(getattr(model, name), idx))
        tr = self.tendon_rows
        if tr.size:
            coef = st.tendon_coef[tr]
            _check_rows("fixed tendons", coef)
            for idx, base in ((st.tendon_coord, g.coord_idx),
                              (st.tendon_dof, g.dof_idx)):
                _check_rows("fixed tendons", np.where(
                    coef != 0, idx[tr] - base[:, :1, None], 0))
        au = st.mjc_actuation
        if self.act_rows.size:
            ar = self.act_rows
            _check_rows("actuators", au.dof[ar] - g.dof_idx[:, :1])
            _check_rows("actuators", au.coord[ar] - g.coord_idx[:, :1])
            for name in ("gear", "gaintype", "gainprm", "biastype",
                         "biasprm", "dyntype", "ctrlrange", "ctrllimited",
                         "forcerange", "forcelimited"):
                _check_rows("actuators", np.asarray(getattr(au, name))[ar])
        plan = self.contact_plans[0]
        if plan is not None:
            for name in ("shape_material_mu", "shape_material_restitution"):
                v = getattr(model, name).cpu().numpy()
                per_slot = 0.5 * (v[np.maximum(st.slot_shape0, 0)]
                                  + v[np.maximum(st.slot_shape1, 0)])
                _check_rows(name, per_slot[plan.slots])

    def _plan_cap(self, c: int) -> int:
        """Resolved per-env contact cap for a plan with ``c`` slots."""
        cap = self.contact_cap
        if cap is None:
            return min(c, 32)
        if cap <= 0:
            return c
        return min(c, int(cap))

    def _build_tables(self) -> SimpleNamespace:
        """Every static index and per-row constant of the substep, on the
        model's device, in the row model's local indices."""
        model = self.row_model
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
        t.model_axis = model.joint_axis
        # multi-axis joints: each angular dof takes its transported axis
        # (slot 0-2 of its joint, sim/articulation.py:angular_axes)
        t.ang_kin = None
        if (gc.dof_ang_slot > 0).any():
            t.ang_kin = kin
            t.dof_joint = L(dj)
            t.dof_ang_slot = L(np.maximum(gc.dof_ang_slot, 0))
            t.dof_is_ang = B(gc.dof_ang_slot >= 0)[:, None]
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
        # gravity of each row's world as the base acceleration [-g, 0] of
        # its bodies, (n, b, 6)
        full, rows = self.model, self.group
        worlds = np.maximum(full.structure.articulation_world[rows.arts], 0)
        grav = full.gravity[L(worlds)][:, None, :].expand(
            -1, st.body_count, 3)
        t.base_acc = torch.cat([-grav, torch.zeros_like(grav)],
                               -1).contiguous()
        # each row's entries in the model's flat layout, (n, k): what step
        # gathers into the env-major rows and scatters back
        t.row_body, t.row_dof = L(rows.body_idx), L(rows.dof_idx)
        t.row_coord = L(rows.coord_idx)
        t.row_tendon, t.row_act = L(self.tendon_rows), L(self.act_rows)
        # applied forces (PD drives on linear coordinates)
        t.lin_idx, t.lin_dof = L(gc.lin_coord_idx), L(gc.lin_coord_dof)
        t.pd_ke = model.joint_target_ke[t.lin_dof]
        t.pd_kd = model.joint_target_kd[t.lin_dof]
        # fixed tendons as dense maps: L = q C_q^T, Ldot = qd C_d^T,
        # tau += f C_d (the padding entries carry coef 0)
        T = st.tendon_count
        t.tendons = T > 0
        if T:
            Cq = np.zeros((T, st.joint_coord_count))
            Cd = np.zeros((T, st.joint_dof_count))
            for i in range(T):
                np.add.at(Cq[i], st.tendon_coord[i], st.tendon_coef[i])
                np.add.at(Cd[i], st.tendon_dof[i], st.tendon_coef[i])
            t.tendon_Cq, t.tendon_Cd = F(Cq), F(Cd)
            t.tendon_ke, t.tendon_kd, t.tendon_L0 = \
                model.tendon_params.unbind(1)
        # group row
        g = gc.groups[0]
        t.di, t.bi = L(g.dof_idx[0]), L(g.body_idx[0])
        t.anc = F(g.anc)                                   # (b, d)
        t.armature = model.joint_armature[t.di]
        # contact rows: per-slot tables over the c slots of a row (the
        # entries gather each row's slots first); with K < c the step
        # gathers the top-K slots of each env from them
        plan = self.contact_plans[0]
        t.cap = None if plan is None else self._plan_cap(plan.c)
        if plan is not None:
            anc = np.asarray(g.anc, dtype=np.float32)
            zero = np.zeros((g.d,), dtype=np.float32)
            anc1 = np.where((plan.lb1 >= 0)[:, None],
                            anc[np.maximum(plan.lb1, 0)], zero)
            anc0 = np.where((plan.lb0 >= 0)[:, None],
                            anc[np.maximum(plan.lb0, 0)], zero)
            t.sign = F(anc1 - anc0)                        # (c, d)
            t.gb0 = L(np.maximum(plan.lb0, 0))
            t.gb1 = L(np.maximum(plan.lb1, 0))
            t.on0 = B(plan.lb0 >= 0)[:, None]
            t.on1 = B(plan.lb1 >= 0)[:, None]
            fst = full.structure
            t.row_slots = L(plan.slots)
            t.slots_are_all = bool(np.array_equal(
                plan.slots[0], np.arange(fst.rigid_contact_max)))
            slots0 = L(plan.slots[0])
            s0 = L(np.maximum(fst.slot_shape0, 0))[slots0]
            s1 = L(np.maximum(fst.slot_shape1, 0))[slots0]
            t.mu = 0.5 * (full.shape_material_mu[s0]
                          + full.shape_material_mu[s1])
            t.e_rest = 0.5 * (full.shape_material_restitution[s0]
                              + full.shape_material_restitution[s1])
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

    def init_state(self, state):
        """The State with the solver's entries of ``State.custom``: for the
        Euler path, ``contact:overflow:0`` (int32 per row), the number of
        active contacts that top-K compaction dropped in the last step,
        when the cap is below the row's slot count (the JAX package's
        ``init_state`` without sleeping and warm start)."""
        plan = self.contact_plans[0]
        custom = dict(state.custom)
        if plan is not None and self._plan_cap(plan.c) < plan.c:
            custom.setdefault("contact:overflow:0", torch.zeros(
                (self.group.n,), dtype=torch.int32,
                device=state.joint_q.device))
        return replace(state, custom=custom)

    def step(self, state_in, state_out=None, control=None, contacts=None,
             dt: float = 1e-3, kernels: bool = True,
             record: Optional[dict] = None):
        """One substep of a flat State of the model (every world at once),
        the reference's entry; returns the new State (``state_out`` is not
        written, as in the reference). ``contacts`` are the flat ``(C,)``
        Contacts of ``CollisionPipeline.collide``. See batched.step."""
        from .batched import step
        return step(self, state_in, control, contacts, dt, kernels=kernels,
                    record=record)

    def step_batched(self, state_b, state_out=None, control_b=None,
                     contacts_b=None, dt: float = 1e-3, kernels: bool = True,
                     record: Optional[dict] = None):
        """One substep of a one-world model over a leading env axis (see
        batched.step_batched)."""
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
