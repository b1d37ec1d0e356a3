"""Generalized-coordinate solver (port of the constructor and the two
entries of ``newton_tpu/solvers/generalized/solver.py``:
``SolverFeatherstone``, ``SolverMuJoCo``).

Per substep: FK-derived dof subspaces, RNEA bias, applied forces (PD drives,
the ball joints' quaternion-error drives, fixed tendons) and MJCF actuator
forces, CRBA, one factor/solve/invert of ``M + dt*Kd`` (kernel; under RK4
four stages of ``M a = tau``, one kernel call each), the contact/limit rows
and one projected-Jacobi solve (kernel), semi-implicit Euler (or the RK4
stage velocities) on the coordinates, FK. The constructor turns every
static plan (dof tables, contact slots, limit rows, accumulation orders)
into index tensors on the model's device, so the substep builds nothing
from numpy and makes no host sync.

The row view: the model's articulations form groups of rows with one
topology (one row per world of a replicated model; a world may hold
several articulations, each in its group). The substep tables of a group
describe one row in local indices (``row_model``); a per-row constant
(mass, inertia, joint frame, axis, armature, gains, limits, tendon and
actuator parameters, a contact slot's friction and restitution) carries a
leading row axis where the rows differ and stays one row where they all
equal row 0, so building the tables of a homogeneous fleet costs the same
at 8192 worlds as at one and its substep runs the same operations.
``notify_model_changed`` rebuilds them from the model's current tensors
(per-world randomization at reset). ``step`` gathers the rows of each group
from the flat multi-world state into the env-major layout, runs the substep
of each group with one env per row, and scatters back (the groups' indices
are disjoint); ``step_batched`` runs the same substep on a one-world
model's ``(W, ...)`` envs. A group's contact plan may be ragged (padded to
its largest row, with per-row local bodies and a mask) and may hold
two-sided contacts: a contact between bodies of two (group, row) cells is
solved in both cells, each with the other body's point inverse mass on its
Delassus diagonal and the other body's pre-step velocity as a moving
support. The port covers the static-contact path of the gymnasium robots,
ball-jointed rods and scenes of several articulations per world, under
the four integrators (euler, implicitfast, implicit, rk4), with the PGS
kernel or the Newton QP (``contact_solver``), constraint or penalty
joint limits (``limit_mode``), spatial tendons (each within one row),
MJCF actuation with activation dynamics and muscles (acc0 solved per row
at construction), rows of a group that differ in their fixed tendons,
actuators and spatial tendons (tables padded to the largest row: a pad
has coefficient 0, gear 0 or no path; per-row maps only where the rows
differ), fixed tendons between articulations and the actuators on them
(summed on the flat dofs before the groups step, explicitly, as the JAX
package sums them), contact warm start (``warm_start``), sleeping
(``sleep_threshold``, ``sleep_steps``) and equality constraints (CONNECT,
WELD and JOINT rows, planned per group as the JAX package plans them).

Bodies outside every articulation (a kinematic conveyor belt, a body
without a joint) keep their pose and velocity; a contact with one is an
entry of the articulation side's cell whose other body is that body (its
point inverse mass, zero for a kinematic body, on B2's diagonal, its
velocity as a moving support), and a contact between two such bodies is
dropped, as in the JAX package. An articulation mounted on a body of
another (its root joint's parent) carries that body in its row model:
its dof subspace and FK start from the mount's pose, its RNEA from the
mount's twist and acceleration, and the wrench of its subtree enters the
carrying articulation's bias forces; neither mass matrix sees the other
(ROADMAP C.24, the JAX package's coupling). ``step_with_contacts``
reports each slot's contact force (impulse / dt, summed over the entries
of a slot in a fixed order). Equality constraints between two
articulations or that not every row of a group carries raise
``NotImplementedError`` (ROADMAP C.18), and so do cable joints (no
coordinates: ``SolverXPBD`` steps them) and a mounted articulation under
RK4, the implicit integrator or sleeping.
"""

from __future__ import annotations

from dataclasses import fields, replace
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ...core.segment_sum import FixedOrderSum
from ...core.types import MAXVAL
from ...sim.articulation import kinematic_tables
from ...sim.enums import JointType
from ...sim.model import Model, ModelStructure
from ..solver import SolverBase
from .actuation import MJCActuation, ActuationTables
from .dynamics import get_generalized_cache

__all__ = ["SolverFeatherstone", "SolverMuJoCo", "row_model"]

# MJCActuation tables that hold parameters (one row per actuator), as
# opposed to the dof, coordinate and tendon maps
_ACT_PARAMS = ("gear", "dyntype", "dynprm", "gaintype", "gainprm",
               "biastype", "biasprm", "ctrlrange", "forcerange", "actrange",
               "ctrllimited", "forcelimited", "actlimited", "lengthrange",
               "acc0")


class _GroupContacts:
    """Static contact-slot plan of an articulation group (the JAX package's
    ``_GroupContacts``): slot indices (n, c), one row per group row (a pad
    entry is ``rigid_contact_max``, one past the end); the local body
    indices lb0/lb1 (-1: static or in another cell), (c,) when every row
    shares them, else (n, c); ``valid`` (n, c), the mask of a ragged plan's
    real entries, or None; ``ob`` (n, c), the global body on the other side
    of a two-sided contact (-1: none); ``w`` the force-report weight (0.5 on
    each half of a two-sided contact)."""

    def __init__(self, slots, lb0, lb1, valid=None, ob=None, w=None):
        self.slots, self.lb0, self.lb1 = slots, lb0, lb1
        self.c = slots.shape[1]
        self.valid = valid
        self.ob = ob if ob is not None else -np.ones(slots.shape, np.int32)
        self.w = w if w is not None else np.ones(lb0.shape, np.float32)

    @property
    def uniform(self) -> bool:
        return self.lb0.ndim == 1


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
    """Assign contact slots to (group, row) cells, the JAX package's
    ``_plan_group_contacts`` (solver.py:125-220): a slot belongs to the
    cell of its body1, else of its body0, and each row takes its slots in
    ascending order. A slot whose two bodies lie in two cells is also
    entered in body0's cell (two-sided: ``ob`` names the other body, each
    half weighs 0.5). A slot whose other side is a body outside every
    articulation names it in ``ob`` (weight 1: that body takes no
    impulse); a slot with no side in an articulation is dropped. A group
    whose rows differ in their slot count or local bodies gets a ragged
    plan, padded to its largest row."""
    plans = [None] * len(groups)
    b0 = np.asarray(st.slot_body0)
    b1 = np.asarray(st.slot_body1)
    S = len(b0)
    if S == 0:
        return plans
    gi_of, e_of, lb_of = _body_env_tables(groups, st.body_count)

    def look(b):
        bc = np.maximum(b, 0)
        return tuple(np.where(b >= 0, t[bc], -1)
                     for t in (gi_of, e_of, lb_of))
    g0, e0, l0 = look(b0)
    g1, e1, l1 = look(b1)
    owner_g = np.where(g1 >= 0, g1, g0)
    owner_e = np.where(g1 >= 0, e1, e0)
    lb0 = np.where((g0 == owner_g) & (e0 == owner_e), l0, -1)
    lb1 = np.where((g1 >= 0) & (g1 == owner_g) & (e1 == owner_e), l1, -1)
    ob_own = np.where((lb0 < 0) & (b0 >= 0), b0,
                      np.where((lb1 < 0) & (b1 >= 0), b1, -1))
    dup = (g0 >= 0) & ((g0 != owner_g) | (e0 != owner_e))
    slot_ids = np.arange(S, dtype=np.int32)
    nd = int(dup.sum())
    ent_g = np.concatenate([owner_g, g0[dup]])
    ent_e = np.concatenate([owner_e, e0[dup]])
    ent_s = np.concatenate([slot_ids, slot_ids[dup]])
    ent_l0 = np.concatenate([lb0, l0[dup]])
    ent_l1 = np.concatenate([lb1, -np.ones(nd, np.int32)])
    ent_ob = np.concatenate([ob_own, b1[dup]])
    ent_w = np.concatenate([np.where(dup, 0.5, 1.0),
                            np.full(nd, 0.5)]).astype(np.float32)
    pad = int(st.rigid_contact_max)
    for gi, g in enumerate(groups):
        m = ent_g == gi
        if not m.any():
            continue
        order = np.argsort(ent_e[m], kind="stable")
        e, s = ent_e[m][order], ent_s[m][order]
        l0a, l1a = ent_l0[m][order], ent_l1[m][order]
        oba, wa = ent_ob[m][order], ent_w[m][order]
        counts = np.bincount(e, minlength=g.n)
        if counts.min() == counts.max():
            c = int(counts[0])
            l0m, l1m = l0a.reshape(g.n, c), l1a.reshape(g.n, c)
            obm, wm = oba.reshape(g.n, c), wa.reshape(g.n, c)
            if ((l0m == l0m[0]).all() and (l1m == l1m[0]).all()
                    and (wm == wm[0]).all()
                    and ((obm >= 0) == (obm[0] >= 0)).all()):
                plans[gi] = _GroupContacts(
                    s.reshape(g.n, c).astype(np.int32),
                    l0m[0].astype(np.int32), l1m[0].astype(np.int32),
                    ob=obm.astype(np.int32), w=wm[0])
                continue
        # ragged: pad every row to the largest; pad entries read one past
        # the end (clamped on read, masked by valid, dropped on scatter)
        cmax = int(counts.max())
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        k = np.arange(len(e)) - starts[e]

        def fill(v, x, dtype):
            out = np.full((g.n, cmax), v, dtype=dtype)
            out[e, k] = x
            return out
        plans[gi] = _GroupContacts(
            fill(pad, s, np.int32), fill(-1, l0a, np.int32),
            fill(-1, l1a, np.int32), valid=fill(False, True, bool),
            ob=fill(-1, oba, np.int32), w=fill(1.0, wa, np.float32))
    return plans


def _dof_env_tables(groups, n_dof):
    """Flat dof -> (group, row, local dof) lookup arrays."""
    gi_of = -np.ones(n_dof, dtype=np.int32)
    e_of = -np.ones(n_dof, dtype=np.int32)
    ld_of = -np.ones(n_dof, dtype=np.int32)
    for gi, g in enumerate(groups):
        di = np.asarray(g.dof_idx)                             # (n, d)
        gi_of[di] = gi
        e_of[di] = np.arange(g.n, dtype=np.int32)[:, None]
        ld_of[di] = np.arange(di.shape[1], dtype=np.int32)[None, :]
    return gi_of, e_of, ld_of


class _GroupEquality:
    """Static equality plan of an articulation group (the JAX package's
    ``_GroupEquality``): m constraints per row, in ascending constraint
    order, each row with the same kinds and local indices. ``kinds`` (m,)
    0 CONNECT, 1 WELD, 2 JOINT; ``lb1``/``lb2`` local bodies (-1 the
    world); ``dof1``/``dof2``/``coord1``/``coord2`` the JOINT rows' local
    dofs and coordinates (dof2 -1: q1 = c0); ``anchor1``/``anchor2``
    (m, 3) in each body's frame (body2's from the initial poses),
    ``relpose`` (m, 4) and ``polycoef`` (m, 5), each row 0's where every
    row equals it, else (n, m, ...); ``rows`` the impulse rows (3 per
    CONNECT, 6 per WELD, 1 per JOINT)."""

    def __init__(self, eq_idx, kinds, lb1, lb2, dof1, dof2, coord1, coord2,
                 anchor1, anchor2, relpose, polycoef):
        self.eq_idx, self.kinds = eq_idx, kinds
        self.lb1, self.lb2 = lb1, lb2
        self.dof1, self.dof2, self.coord1, self.coord2 = \
            dof1, dof2, coord1, coord2
        self.anchor1, self.anchor2 = anchor1, anchor2
        self.relpose, self.polycoef = relpose, polycoef
        self.rows = int(sum(3 if k == 0 else (6 if k == 1 else 1)
                            for k in kinds))


def _plan_group_equality(model, groups):
    """Assign the model's equality constraints to (group, row) cells, the
    JAX package's ``_plan_group_equality`` (solver.py:1664-1762): a
    CONNECT/WELD constraint belongs to the cell of body1 (body2 where
    body1 is the world), a JOINT constraint to the cell of joint1's dof.
    Where the JAX planner would drop constraints or mix up indices
    without a word, the port raises naming the case: rows of a group
    that carry different constraints (ROADMAP C.18), constraints between
    two cells (C.18), constraints on bodies or joints outside the
    articulations or with no dof, and disabled constraints (the JAX
    solver applies them all)."""
    st = model.structure
    plans = [None] * len(groups)
    E = int(st.eq_count)
    if E == 0:
        return plans
    from ...core.host_math import np_transform_inverse, np_transform_point
    if not bool(model.eq_enabled.all()):
        raise NotImplementedError(
            "disabled equality constraints are not ported (the JAX "
            "package's solver applies every constraint)")
    bgi, be, blb = _body_env_tables(groups, st.body_count)
    dgi, de, dld = _dof_env_tables(groups, st.joint_dof_count)
    bq0 = model.body_q.detach().cpu().double().numpy()
    obj1 = model.eq_obj1.cpu().numpy().astype(np.int64)
    obj2 = model.eq_obj2.cpu().numpy().astype(np.int64)
    anchors = model.eq_anchor.detach().cpu().double().numpy()
    relposes = model.eq_relpose.detach().cpu().double().numpy()
    polys = model.eq_polycoef.detach().cpu().double().numpy()
    qs = np.asarray(st.joint_q_start, dtype=np.int64)
    ds = np.asarray(st.joint_qd_start, dtype=np.int64)
    per_cell = {}
    for e in range(E):
        kind, o1, o2 = int(st.eq_type[e]), int(obj1[e]), int(obj2[e])
        if kind == 2:
            if o1 < 0 or ds[o1 + 1] == ds[o1]:
                raise NotImplementedError(
                    f"equality constraint {e}: a JOINT constraint on joint "
                    f"{o1}, which has no dof, is not ported")
            d1 = ds[o1]
            if dgi[d1] < 0:
                raise NotImplementedError(
                    f"equality constraint {e}: joint {o1} lies outside the "
                    "articulations")
            cell = (int(dgi[d1]), int(de[d1]))
            ld2 = lc2 = -1
            if o2 >= 0:
                d2 = ds[o2]
                if ds[o2 + 1] == d2 or (int(dgi[d2]), int(de[d2])) != cell:
                    raise NotImplementedError(
                        f"equality constraint {e}: a JOINT constraint "
                        "between joints of two articulations or worlds is "
                        "not ported (ROADMAP C.18)")
                ld2 = int(dld[d2])
            g = groups[cell[0]]
            c_base = int(g.coord_idx[cell[1]][0])
            lc2 = int(qs[o2]) - c_base if o2 >= 0 else -1
            per_cell.setdefault(cell, []).append(
                (e, 2, -1, -1, int(dld[d1]), ld2, int(qs[o1]) - c_base, lc2,
                 np.zeros(3), np.zeros(3), np.array([0.0, 0, 0, 1]),
                 polys[e]))
            continue
        cells = {(int(bgi[b]), int(be[b])) for b in (o1, o2) if b >= 0}
        if any(b >= 0 and bgi[b] < 0 for b in (o1, o2)) or not cells:
            raise NotImplementedError(
                f"equality constraint {e}: bodies outside the "
                "articulations are not ported")
        if len(cells) > 1:
            raise NotImplementedError(
                f"equality constraint {e}: a constraint between bodies of "
                "two articulations or worlds is not ported (ROADMAP C.18)")
        a1 = anchors[e]
        p_w = np_transform_point(bq0[o1], a1) if o1 >= 0 else a1
        a2 = (np_transform_point(np_transform_inverse(bq0[o2]), p_w)
              if o2 >= 0 else p_w)
        per_cell.setdefault(cells.pop(), []).append(
            (e, kind, int(blb[o1]) if o1 >= 0 else -1,
             int(blb[o2]) if o2 >= 0 else -1, -1, -1, -1, -1, a1, a2,
             relposes[e][3:7], polys[e]))
    for gi, g in enumerate(groups):
        rows = [per_cell.get((gi, r), []) for r in range(g.n)]
        if not any(rows):
            continue
        if len({len(r) for r in rows}) != 1:
            raise NotImplementedError(
                f"articulation group {gi}: rows with different numbers of "
                "equality constraints are not ported (the JAX planner drops "
                "them: ROADMAP C.18)")
        key = [tuple(x[1:8]) for x in rows[0]]
        if any([tuple(x[1:8]) for x in r] != key for r in rows[1:]):
            raise NotImplementedError(
                f"articulation group {gi}: rows whose equality constraints "
                "differ in kind or local bodies and joints are not ported "
                "(the JAX planner applies row 0's: ROADMAP C.18)")
        idx = np.asarray([[x[0] for x in r] for r in rows], dtype=np.int32)
        col = [np.asarray([x[k] for x in rows[0]], dtype=np.int32)
               for k in range(1, 8)]
        per_row = [np.asarray([[x[k] for x in r] for r in rows])
                   for k in range(8, 12)]
        plans[gi] = _GroupEquality(idx, *col, *[
            a[0] if (a == a[:1]).all() else a for a in per_row])
    return plans


def _local_index(idx, rows):
    """Global entity indices ``idx`` (n, k) (-1: none) as positions in each
    row's entity list ``rows`` (n, m): (n, k), -1 kept."""
    idx = np.asarray(idx)
    rows = np.asarray(rows)
    out = -np.ones(idx.shape, dtype=np.int32)
    for r in range(idx.shape[0] if idx.ndim == 2 else 0):
        pos = {int(x): i for i, x in enumerate(rows[r])}
        out[r] = [pos.get(int(x), -1) if x >= 0 else -1 for x in idx[r]]
    return out


def _plan_spatial_tendons(st, groups):
    """Each spatial tendon's (group, row) cell, (2, Ts), and its path in
    that row's local bodies. A tendon's bodies must lie in one cell (or the
    world); one spanning two articulations or worlds raises."""
    paths = list(getattr(st, "sten_paths", []) or [])
    own = -np.ones((2, len(paths)), dtype=np.int64)
    local = []
    if not paths:
        return own, local
    gi_of, e_of, lb_of = _body_env_tables(groups, st.body_count)
    for k, p in enumerate(paths):
        bodies = {int(e[1]) for e in p.elems if e[1] >= 0}
        cells = {(int(gi_of[b]), int(e_of[b])) for b in bodies}
        if not bodies or any(gi_of[b] < 0 for b in bodies) or len(cells) != 1:
            raise NotImplementedError(
                f"spatial tendon {k}: a tendon whose bodies are not all in "
                "one articulation of one world is not ported")
        own[:, k] = cells.pop()
        local.append(p.remapped(lambda b: int(lb_of[b])))
    return own, local


def _entity_rows(sel, owner_row, n):
    """The (n, k) global indices of the entities ``sel`` of a group, each
    row's in ascending order (``owner_row`` their rows); a row with fewer
    entities than the largest is padded with -1. A padding fixed tendon
    has coefficient 0, a padding actuator gear 0 and a padding spatial
    tendon no path, so a pad acts on nothing."""
    counts = np.bincount(owner_row, minlength=n)
    order = np.argsort(owner_row, kind="stable")
    out = -np.ones((n, int(counts.max()) if counts.size else 0), np.int64)
    col = np.arange(order.size) - np.repeat(np.cumsum(counts) - counts,
                                            counts)
    out[owner_row[order], col] = np.asarray(sel)[order]
    return out


def _one_row(a: np.ndarray) -> np.ndarray:
    """(n, ...) as row 0 where every row equals it."""
    return a[0] if a.shape[0] <= 1 or (a == a[:1]).all() else a


def _group_rows(v: torch.Tensor, idx) -> torch.Tensor:
    """``v`` gathered on the (n, k) entity rows ``idx`` (-1: a padding
    entry, zero): (k, ...) when every row equals row 0, else
    (n, k, ...)."""
    idx = np.asarray(idx, dtype=np.int64)
    r = v[torch.as_tensor(np.maximum(idx, 0), device=v.device)]
    if (idx < 0).any():
        pad = torch.as_tensor(idx < 0, device=v.device)
        r = torch.where(pad.view(*pad.shape, *(1,) * (r.dim() - pad.dim())),
                        torch.zeros((), dtype=r.dtype, device=r.device), r)
    if r.shape[0] <= 1 or bool((r == r[:1]).all()):
        return r[0]
    return r


def _param_rows(a: np.ndarray, idx) -> np.ndarray:
    """The numpy counterpart of ``_group_rows``."""
    idx = np.asarray(idx, dtype=np.int64)
    r = np.asarray(a)[np.maximum(idx, 0)]
    pad = (idx < 0).reshape(idx.shape + (1,) * (r.ndim - idx.ndim))
    return _one_row(np.where(pad, np.zeros((), r.dtype), r))


def _joint_rows(st, g):
    """(n, nj) joint indices of the group's rows."""
    a0 = np.asarray(st.articulation_start)[g.arts]
    nj = int(st.articulation_start[g.arts[0] + 1] - a0[0])
    return a0[:, None] + np.arange(nj)[None]


def _group_mounts(st, g):
    """The bodies outside a group that its rows are mounted on (a root
    joint's parent that is not a body of the row): (n, m) global body
    indices, each row's in the order of its joints, or None. Every row
    must mount the same local joints."""
    J = _joint_rows(st, g)                                    # (n, nj)
    parent = np.asarray(st.joint_parent, dtype=np.int64)[J]
    bi = np.asarray(g.body_idx)
    ext = (parent >= 0) & ~(parent[..., None] == bi[:, None, :]).any(-1)
    if not ext.any():
        return None
    if not (ext == ext[:1]).all():
        raise NotImplementedError(
            "rows of an articulation group mounted on other bodies at "
            "different joints are not ported")
    m = parent[:, ext[0]]                                     # (n, k)
    _, first = np.unique(m[0], return_index=True)
    keep = np.sort(first)
    mounts = m[:, keep]
    # two joints of a row on one mount body share its entry in every row
    if not all(len(np.unique(r)) == len(keep) for r in mounts):
        raise NotImplementedError(
            "rows of an articulation group mounted on different numbers of "
            "bodies are not ported")
    return mounts.astype(np.int64)


def row_model(model: Model, g, tendon_rows, act_rows,
              sten_rows=None, mounts=None) -> Model:
    """Articulation group ``g`` as a one-world Model in local indices: the
    bodies, joints, dofs and coordinates of a row, the tendons and
    actuators of ``tendon_rows``/``act_rows`` (n, k), no shapes and no
    particles. Each per-entity tensor is row 0's where every row equals it,
    else carries a leading row axis (n, ...). ``mounts`` (n, m): bodies
    outside the group that its root joints hang from, appended after the
    row's own bodies as bodies without a joint (the substep reads their
    pose and twist and never moves them). The substep's tables are built
    on it."""
    st = model.structure
    if sten_rows is None:
        sten_rows = np.zeros((g.n, 0), np.int64)
    a0 = int(g.arts[0])
    j0, j1 = int(st.articulation_start[a0]), int(st.articulation_start[a0 + 1])
    js = np.arange(j0, j1)
    bi, di, ci = g.body_idx[0], g.dof_idx[0], g.coord_idx[0]
    q0, d0 = int(st.joint_q_start[j0]), int(st.joint_qd_start[j0])
    body_rows = np.asarray(g.body_idx)
    if mounts is not None:
        body_rows = np.concatenate([body_rows, mounts], 1)
    local_body = -np.ones(st.body_count, dtype=np.int64)
    local_body[body_rows[0]] = np.arange(body_rows.shape[1])
    parent = st.joint_parent[js]
    if ((parent >= 0) & (local_body[np.maximum(parent, 0)] < 0)).any():
        raise NotImplementedError(
            "a joint whose parent lies outside the row and its mounts")
    rst = ModelStructure()
    rst.body_count, rst.joint_count = body_rows.shape[1], len(js)
    rst.joint_coord_count, rst.joint_dof_count = len(ci), len(di)
    rst.articulation_count = 1
    i32 = np.int32
    rst.joint_type = st.joint_type[js].astype(i32)
    rst.joint_parent = np.where(parent >= 0,
                                local_body[np.maximum(parent, 0)],
                                -1).astype(i32)
    rst.joint_child = local_body[st.joint_child[js]].astype(i32)
    rst.joint_q_start = (st.joint_q_start[j0:j1 + 1] - q0).astype(i32)
    rst.joint_qd_start = (st.joint_qd_start[j0:j1 + 1] - d0).astype(i32)
    rst.joint_dof_dim = st.joint_dof_dim[js].astype(i32)
    pj = st.joint_parent_joint[js]
    # a mounted root's parent joint lies in another articulation: a root
    # of the row
    rst.joint_parent_joint = np.where((pj >= j0) & (pj < j1), pj - j0,
                                      -1).astype(i32)
    rst.joint_world = np.full(len(js), -1, i32)
    rst.articulation_start = np.asarray([0, len(js)], i32)
    rst.articulation_world = np.full(1, -1, i32)
    rst.body_world = np.full(body_rows.shape[1], -1, i32)
    # fixed tendons of the rows: local coordinates and dofs, (T, K) where
    # every row's equal row 0's, else (n, T, K) (a padding entry or
    # tendon, coef 0, keeps index 0)
    tr = np.asarray(tendon_rows, dtype=np.int64)
    coef = np.where((tr < 0)[..., None], 0.0,
                    st.tendon_coef[np.maximum(tr, 0)])
    rst.tendon_count = tr.shape[1]
    rst.tendon_coef = _one_row(coef)
    for name, base in (("tendon_coord", g.coord_idx),
                       ("tendon_dof", g.dof_idx)):
        idx = getattr(st, name)[np.maximum(tr, 0)]
        setattr(rst, name, _one_row(np.where(
            coef != 0, idx - np.asarray(base)[:, :1, None], 0)).astype(i32))
    au = st.mjc_actuation
    ar = np.asarray(act_rows, dtype=np.int64)
    if au is not None and au.n and ar.size:
        # each row's transmissions in its local indices, (A,) or, where the
        # rows differ, (n, A); a padding actuator drives dof 0 at gear 0
        pad, arc = ar < 0, np.maximum(ar, 0)
        rau = MJCActuation(ar.shape[1])
        for name, base in (("dof", g.dof_idx), ("coord", g.coord_idx)):
            v = getattr(au, name)[arc]
            setattr(rau, name, _one_row(np.where(
                pad, 0, np.where(v >= 0, v - np.asarray(base)[:, :1], -1)))
                .astype(i32))
        # tendon transmissions index the row's fixed and spatial tendons
        for name, rows_ in (("tendon", tendon_rows), ("sten", sten_rows)):
            v = np.where(pad, -1, getattr(au, name)[arc])
            setattr(rau, name, _one_row(_local_index(v, rows_)))
        for name in _ACT_PARAMS:
            setattr(rau, name, _param_rows(getattr(au, name), ar))
        rst.mjc_actuation = rau.finish()
    rst.mjc_options = dict(st.mjc_options)

    w = max(int(st.articulation_world[a0]), 0)
    # each tensor field by the entities it is per: bodies, joints, dofs,
    # coordinates, tendons, the row's world; no shapes and no particles
    # (the 0-d material scalars stay as they are)
    rows = {"joint_X_p": _joint_rows(st, g), "joint_X_c": _joint_rows(st, g),
            "joint_q0": g.coord_idx, "joint_target_q0": g.coord_idx,
            "tendon_params": tendon_rows, "sten_params": sten_rows,
            "gravity": np.asarray([[w]])}
    kw = {}
    for f in fields(model):
        v = getattr(model, f.name)
        if not isinstance(v, torch.Tensor):
            continue
        if f.name in ("joint_type_arr", "joint_parent", "joint_child"):
            v = torch.as_tensor(getattr(rst, f.name.replace("_arr", "")),
                                device=v.device)
        elif f.name in rows:
            v = _group_rows(v, rows[f.name])
        elif f.name.startswith("muscle_"):
            v = v[:0]
        elif f.name.startswith("body_"):
            v = _group_rows(v, body_rows)
        elif f.name.startswith("joint_"):
            v = _group_rows(v, g.dof_idx)
        elif v.dim():
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


class SolverFeatherstone(SolverBase):
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
                 angular_damping: float = 0.0,
                 friction_cone: str = "pyramid",
                 limit_mode: str = "constraint",
                 sleep_threshold: float = 0.0,
                 sleep_steps: int = 16,
                 warm_start: bool = False,
                 max_velocity: float = 1.0e3,
                 update_mass_matrix_interval: int = 1,
                 contact_cap: Optional[int] = None,
                 contact_solver: str = "pgs",
                 newton_iterations: int = 8,
                 integrator: str = "euler",
                 apply_body_forces: bool = True):
        integrator = str(integrator).lower()
        if integrator not in ("euler", "implicitfast", "implicit", "rk4"):
            raise ValueError(f"unknown integrator {integrator!r}")
        if friction_cone not in ("pyramid", "cone"):
            raise ValueError(f"unknown friction_cone {friction_cone!r}")
        if limit_mode not in ("constraint", "penalty"):
            raise ValueError(f"unknown limit_mode {limit_mode!r}")
        if contact_solver not in ("pgs", "newton"):
            raise ValueError(f"unknown contact_solver {contact_solver!r}")
        st = model.structure

        self.model = model
        self.integrator = integrator
        # "constraint": limit rows in the impulse solve; "penalty": one-sided
        # springs (joint_limit_ke/kd) into tau, no limit rows
        self.limit_mode = limit_mode
        # False skips the projection of State.body_f into tau
        self.apply_body_forces = bool(apply_body_forces)
        # "pgs" (B2) or "newton": the active-set Newton QP on pyramid
        # facets (newton_qp.py), newton_iterations masked solves
        self.contact_solver = contact_solver
        self.newton_iterations = int(newton_iterations)
        # accepted and stored for the reference's signature; the JAX
        # package reads neither
        self.angular_damping = float(angular_damping)
        self.update_mass_matrix_interval = int(update_mass_matrix_interval)
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
        # contact impulses carried from substep to substep in full slot
        # space (State.custom["contact:lam:<gi>"]), the start of B2's sweep
        self.warm_start = bool(warm_start)
        # a row whose dofs all stay below sleep_threshold, with no
        # joint_f on them, for sleep_steps substeps freezes (counters in
        # State.custom["sleep:count:<gi>"])
        self.sleep_threshold = float(sleep_threshold)
        self.sleep_steps = int(sleep_steps)

        a_start = np.asarray(st.articulation_start, dtype=np.int64)
        if st.joint_count and (len(a_start) < 2 or a_start[0] != 0
                               or a_start[-1] != st.joint_count):
            # unreachable from ModelBuilder: add_joint puts every joint in
            # the current articulation, opening one when there is none
            raise NotImplementedError(
                "joints outside the articulations (a ModelStructure whose "
                "articulation_start does not cover every joint; no "
                "ModelBuilder call makes one) are not ported")
        gc = get_generalized_cache(st)
        groups = gc.groups
        if (np.asarray(st.joint_type) == int(JointType.CABLE)).any():
            raise NotImplementedError(
                "cable joints carry no coordinates: SolverXPBD steps them")
        self.contact_plans = _plan_group_contacts(st, groups)
        self.equality_plans = _plan_group_equality(model, groups)
        # each group's static plan: its tendons and actuators per row
        # (n, T) and (n, A), and its limit rows (decided on row 0's limits,
        # as the JAX package does)
        coord_grp = -np.ones((2, st.joint_coord_count), dtype=np.int64)
        dof_grp = -np.ones((2, st.joint_dof_count), dtype=np.int64)
        for gi, g in enumerate(groups):
            coord_grp[:, g.coord_idx] = np.stack(np.broadcast_arrays(
                gi, np.arange(g.n)[:, None]))
            dof_grp[:, g.dof_idx] = np.stack(np.broadcast_arrays(
                gi, np.arange(g.n)[:, None]))
        # a fixed tendon's cell: its coordinates' (-1: they lie in two
        # cells, a tendon between articulations)
        tend = np.zeros((2, 0), np.int64)
        if st.tendon_count:
            cells = coord_grp[:, st.tendon_coord]              # (2, T, K)
            one = ((cells == cells[..., :1]) | (st.tendon_coef == 0)).all(
                axis=(0, 2))
            tend = np.where(one, cells[..., 0], -1)
        sten, self._sten_local = _plan_spatial_tendons(st, groups)
        au = st.mjc_actuation
        acts = np.zeros((2, 0), np.int64)
        if au is not None and au.n:
            # an actuator's cell: its dof's, or its tendon's
            acts = np.where(au.dof >= 0, dof_grp[:, np.maximum(au.dof, 0)],
                            -1)
            for idx, own in ((au.tendon, tend), (au.sten, sten)):
                if (idx >= 0).any():
                    acts = np.where(idx >= 0, own[:, np.maximum(idx, 0)],
                                    acts)
        self.cross = self._plan_cross(tend, acts)
        lim_lo = model.joint_limit_lower.cpu().numpy()
        lim_hi = model.joint_limit_upper.cpu().numpy()
        lin = dict(zip(gc.lin_coord_dof.tolist(), gc.lin_coord_idx.tolist()))
        self.groups = []
        self.limit_plans = []
        for gi, g in enumerate(groups):
            grp = SimpleNamespace(index=gi, g=g, plan=self.contact_plans[gi],
                                  eplan=self.equality_plans[gi],
                                  mounts=_group_mounts(st, g))
            for name, own in (("tendon_rows", tend), ("act_rows", acts),
                              ("sten_rows", sten)):
                sel = np.nonzero(own[0] == gi)[0]
                setattr(grp, name, _entity_rows(sel, own[1][sel], g.n))
            ld, lc = [], []
            for k, dg in enumerate(g.dof_idx[0]):
                cg = lin.get(int(dg))
                if cg is not None and (lim_lo[dg] > -0.5 * MAXVAL
                                       or lim_hi[dg] < 0.5 * MAXVAL):
                    ld.append(k)
                    lc.append(cg - int(g.coord_idx[0][0]))
            grp.limit_plan = (np.asarray(ld, dtype=np.int32),
                              np.asarray(lc, dtype=np.int32))
            self.limit_plans.append(grp.limit_plan)
            self.groups.append(grp)
        self._plan_mounts(groups)
        self._force_sums = {}               # step_with_contacts' tables
        # step_batched takes a one-world model that is its row: one group,
        # every body and coordinate in its articulation, in order
        g = groups[0] if groups else None
        self._model_is_row = len(groups) == 1 and g.n == 1 and all(
            np.array_equal(idx[0], np.arange(total)) for idx, total in (
                (g.body_idx, st.body_count), (g.dof_idx, st.joint_dof_count),
                (g.coord_idx, st.joint_coord_count)))
        self.notify_model_changed()
        au = st.mjc_actuation
        if au is not None and au.n and au.has_muscle:
            self._compute_muscle_acc0(au)
            self.notify_model_changed()

    def _plan_cross(self, tend, acts):
        """The fixed tendons whose coordinates lie in two cells (between
        articulations or worlds) and the actuators that drive them: summed
        on the flat dofs before the groups step, as the JAX package sums
        every tendon, and explicit under every integrator (the JAX
        package keeps such a tendon's damping explicit too). None when
        every tendon and actuator lies in one cell."""
        xt = np.nonzero(tend[0] < 0)[0]
        xa = np.nonzero(acts[0] < 0)[0]
        if not xt.size and not xa.size:
            return None
        if self.integrator == "rk4" or self.sleep_threshold > 0:
            raise NotImplementedError(
                "a fixed tendon between articulations under RK4 or "
                "sleeping is not ported (its force is summed once a "
                "substep, before the groups step)")
        st, dev = self.model.structure, self.model.device
        Cq = np.zeros((len(xt), st.joint_coord_count), np.float32)
        Cd = np.zeros((len(xt), st.joint_dof_count), np.float32)
        for k, i in enumerate(xt):
            np.add.at(Cq[k], st.tendon_coord[i], st.tendon_coef[i])
            np.add.at(Cd[k], st.tendon_dof[i], st.tendon_coef[i])
        x = SimpleNamespace(
            tendons=torch.as_tensor(xt, device=dev),
            Cq=torch.as_tensor(Cq, device=dev),
            Cd=torch.as_tensor(Cd, device=dev), acts=None, actuation=None)
        if xa.size:
            au = st.mjc_actuation
            pos = {int(i): k for k, i in enumerate(xt)}
            rau = MJCActuation(len(xa))
            rau.tendon = np.asarray([pos.get(int(au.tendon[a]), -1)
                                     for a in xa], np.int32)
            for name in _ACT_PARAMS:
                setattr(rau, name, np.asarray(getattr(au, name))[xa])
            if (rau.tendon < 0).any():
                raise NotImplementedError(
                    "an actuator whose transmission lies in no "
                    "articulation is not ported")
            if rau.finish().has_muscle:
                raise NotImplementedError(
                    "a muscle on a fixed tendon between articulations is "
                    "not ported (its acc0 is solved per row)")
            x.acts = torch.as_tensor(xa, device=dev)
            x.actuation = ActuationTables(rau, dev, st.joint_dof_count,
                                          tendon_Cd=x.Cd)
        return x

    def _plan_mounts(self, groups):
        """The order of the mount coupling: ``mount_order`` lists the
        mounted groups, carriers before the groups they carry (the
        accelerations go down this order, the wrenches up it);
        ``acc_groups`` the groups whose accelerations a mounted group
        reads. Mounted groups raise under RK4, the implicit integrator
        and sleeping (their stages and freezes are per group)."""
        st = self.model.structure
        gi_of, _, _ = _body_env_tables(groups, st.body_count)
        parents = {}
        for grp in self.groups:
            if grp.mounts is not None:
                parents[grp.index] = {int(x) for x in
                                      np.unique(gi_of[grp.mounts]) if x >= 0}
        self.mount_order, self.acc_groups = [], set()
        if not parents:
            return
        if self.integrator in ("rk4", "implicit") or self.sleep_threshold > 0:
            raise NotImplementedError(
                "an articulation mounted on another's body under RK4, the "
                "implicit integrator or sleeping is not ported")
        done = set()
        while len(done) < len(parents):
            ready = [g for g in parents if g not in done
                     and not (parents[g] - done) & set(parents)]
            if not ready:
                raise ValueError("articulation mounts form a cycle")
            self.mount_order += sorted(ready)
            done |= set(ready)
        # every carrier of a mounted group, transitively, and each group's
        # depth in the mount tree (carriers first)
        stack = list(parents)
        while stack:
            for p in parents.get(stack.pop(), ()):
                if p not in self.acc_groups:
                    self.acc_groups.add(p)
                    stack.append(p)
        self.mount_depth = {g.index: 0 for g in self.groups}
        for gi in self.mount_order:
            self.mount_depth[gi] = 1 + max(
                (self.mount_depth[p] for p in parents[gi]), default=0)
        dev = self.model.device
        self.mount_world = torch.as_tensor(np.maximum(np.asarray(
            st.body_world, dtype=np.int64), 0), device=dev)
        # each mounted group's subtree wrenches into its mount bodies, in a
        # fixed order (several rows may hang from one body)
        self.mount_sums = {
            gi: FixedOrderSum(self.groups[gi].mounts.reshape(-1),
                              st.body_count, dev)
            for gi in self.mount_order}

    def group_mass_matrices(self, state):
        """Each group's joint-space mass matrices (n, d, d) at ``state`` (a
        flat State of the model), from the substep's CRBA."""
        from .batched import _crba, _dof_subspace, _gather_rows, \
            _spatial_inertia
        out = []
        for grp in self.groups:
            t = grp.tables
            if t.d == 0:
                out.append(None)
                continue
            rows, _, _ = _gather_rows(grp, state, None, None)
            v_o, w_o = _dof_subspace(t, rows.body_q, rows.joint_q)
            x_b, Iw = _spatial_inertia(grp.row_model, rows.body_q)
            out.append(_crba(t, v_o, w_o, x_b, Iw, grp.row_model.body_mass))
        return out

    def _compute_muscle_acc0(self, au):
        """acc0_a = |M(q0)^-1 moment_a| per actuator (MuJoCo's actuator
        acc0, which resolves a muscle's force < 0 as scale / acc0): one
        float64 host solve per group at the model's default pose, each
        actuator with its own row's M (the JAX package takes row 0 of the
        first group the actuator moves)."""
        from .batched import _dof_subspace, _gather_rows, _spatial_tendons
        state = self.model.state()
        Ms = self.group_mass_matrices(state)
        for grp, M in zip(self.groups, Ms):
            if M is None or not grp.act_rows.size:
                continue
            t = grp.tables
            rau = grp.row_model.structure.mjc_actuation
            n, A, d = grp.g.n, grp.act_rows.shape[1], grp.g.d
            ar = grp.act_rows
            gear = np.where(ar < 0, 0.0, np.asarray(au.gear, np.float64)[
                np.maximum(ar, 0)])                              # (n, A)
            # each row's own transmissions (a padding actuator: gear 0)
            dof, ten, stn = (np.broadcast_to(np.asarray(x), (n, A))
                             for x in (rau.dof, rau.tendon, rau.sten))
            mom = np.zeros((n, A, d))
            r, a = np.nonzero(dof >= 0)
            mom[r, a, dof[r, a]] = gear[r, a]
            r, a = np.nonzero(ten >= 0)
            if r.size:
                Cd = t.tendon_Cd.double().cpu().numpy()
                Cd = np.broadcast_to(Cd, (n,) + Cd.shape[-2:])
                mom[r, a] = Cd[r, ten[r, a]] * gear[r, a, None]
            r, a = np.nonzero(stn >= 0)
            if r.size:
                rows, _, _ = _gather_rows(grp, state, None, None)
                v_o, w_o = _dof_subspace(t, rows.body_q, rows.joint_q)
                _, _, J = _spatial_tendons(t, rows.body_q, rows.joint_qd,
                                           v_o, w_o)
                J = J.double().cpu().numpy()                  # (n, Ts, d)
                mom[r, a] = J[r, stn[r, a]] * gear[r, a, None]
            qacc = np.linalg.solve(M.double().cpu().numpy(),
                                   mom.transpose(0, 2, 1))    # (n, d, A)
            acc0 = np.maximum(np.linalg.norm(qacc, axis=1), 1e-12)
            has = np.abs(mom).sum(-1) > 0
            au.acc0[grp.act_rows[has]] = acc0[has]

    # the first group's tables, for one-group models
    @property
    def group(self):
        return self.groups[0].g

    @property
    def tables(self):
        return self.groups[0].tables

    @property
    def row_model(self):
        return self.groups[0].row_model

    def notify_model_changed(self, flags: int = 0):
        """Rebuild every group's per-row tables from the model's current
        tensors: after an edit of ``body_mass``, ``body_inertia``,
        ``shape_material_mu``, joint gains or limits, ... (per-world
        randomization), the next substep uses the new values. The static
        plans (groups, contact slots, which dofs have limit rows) stay.
        ``flags`` is accepted for the reference's signature and ignored:
        every table is rebuilt. A two-sided contact reads the other body's
        ``body_inv_mass`` and ``body_inv_inertia``: keep them consistent
        with ``body_mass`` and ``body_inertia`` when editing those."""
        for grp in self.groups:
            if grp.g.d == 0:
                # no dofs (fixed joints only): nothing to step, its bodies
                # keep their poses
                grp.row_model = grp.gc = grp.actuation = None
                grp.tables = SimpleNamespace(d=0)
                continue
            grp.row_model = rm = row_model(self.model, grp.g,
                                           grp.tendon_rows, grp.act_rows,
                                           grp.sten_rows, grp.mounts)
            grp.gc = get_generalized_cache(rm.structure)
            grp.tables = self._build_tables(grp)
            rau = rm.structure.mjc_actuation
            grp.actuation = (ActuationTables(
                rau, self.model.device, rm.structure.joint_dof_count,
                tendon_Cd=getattr(grp.tables, "tendon_Cd", None),
                n_sten=grp.sten_rows.shape[1])
                if rau is not None and rau.n > 0 else None)

    def _plan_cap(self, c: int, grp=None) -> int:
        """Resolved per-env contact cap for a plan with ``c`` slots (of
        group ``grp``)."""
        cap = self.contact_cap
        if cap is None:
            return min(c, 32)
        if cap <= 0:
            return c
        return min(c, int(cap))

    def _build_tables(self, grp) -> SimpleNamespace:
        """Every static index and per-row constant of a group's substep, on
        the model's device, in the row model's local indices; a constant
        is (k, ...) or, where the rows differ, (n, k, ...)."""
        model = grp.row_model
        st = model.structure
        gc = grp.gc
        dev = model.device
        kin = kinematic_tables(model)

        def L(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        def B(a):
            return torch.as_tensor(np.asarray(a, dtype=bool), device=dev)

        def F(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32),
                                   device=dev)

        g = gc.groups[0]
        t = SimpleNamespace(identity=kin.identity, d=g.d)
        # dof subspace
        dj = gc.dof_joint
        t.dof_parent = L(np.maximum(st.joint_parent[dj], 0))
        t.dof_hasp = B(st.joint_parent[dj] >= 0)[:, None]
        t.dof_X_p = model.joint_X_p[..., L(dj), :]
        t.model_axis = model.joint_axis
        # multi-axis joints: each angular dof takes its transported axis
        # (slot 0-2 of its joint, sim/articulation.py:angular_axes); a ball
        # joint's dofs keep their canonical axes
        t.ang_kin = None
        if (gc.dof_ang_slot > 0).any():
            t.ang_kin = kin
            t.dof_joint = L(dj)
            t.dof_ang_slot = L(np.maximum(gc.dof_ang_slot, 0))
            t.dof_is_ang = B(gc.dof_ang_slot >= 0)[:, None]
        # D6 joints with linear axes: their angular dofs rotate about the
        # anchor moved by the joint's translation (FK's pivot), not about
        # the joint origin as in the JAX package (ROADMAP C)
        dim = np.asarray(st.joint_dof_dim, dtype=np.int64).reshape(-1, 2)
        shifted = (dim[dj, 0] > 0) & ~gc.dof_is_linear & ~gc.dof_anchor_is_com
        t.slide_pivot = None
        if shifted.any():
            t.slide_pivot = SimpleNamespace(
                lin_q_idx=kin.lin_q_idx, lin_mask=kin.lin_mask,
                A_lin=kin.A_lin, dof_joint=L(dj),
                dof_shift=B(shifted)[:, None])
        t.dof_body = L(gc.dof_body)
        t.dof_com = model.body_com[..., t.dof_body, :]
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
        full, rows = self.model, grp.g
        worlds = np.maximum(full.structure.articulation_world[rows.arts], 0)
        grav = full.gravity[L(worlds)][:, None, :].expand(
            -1, st.body_count, 3)
        t.base_acc = torch.cat([-grav, torch.zeros_like(grav)],
                               -1).contiguous()
        # each row's entries in the model's flat layout, (n, k): what step
        # gathers into the env-major rows and scatters back
        t.row_body, t.row_dof = L(rows.body_idx), L(rows.dof_idx)
        # the bodies a row reads: its own, then its mounts (never written)
        t.nb = rows.body_idx.shape[1]
        t.row_read = t.row_body if grp.mounts is None else L(
            np.concatenate([rows.body_idx, grp.mounts], 1))
        t.mount_local = (None if grp.mounts is None else
                         L(t.nb + np.arange(grp.mounts.shape[1])))
        t.row_coord = L(rows.coord_idx)
        # the rows' tendons and actuators in the flat layout; a ragged
        # group reads index 0 for a pad and masks it (``*_pad``), and
        # writes its activations back only to real entries
        for name, rows_ in (("tendon", grp.tendon_rows),
                            ("act", grp.act_rows)):
            pad = rows_ < 0
            setattr(t, f"row_{name}", L(np.maximum(rows_, 0)))
            setattr(t, f"{name}_pad", B(pad) if pad.any() else None)
        r, a = np.nonzero(grp.act_rows >= 0)
        t.act_put = (None if t.act_pad is None else
                     (L(grp.act_rows[r, a]), L(r), L(a)))
        # applied forces: PD drives on linear coordinates and on ball
        # joints (the quaternion error as an axis-angle torque)
        t.lin_idx, t.lin_dof = L(gc.lin_coord_idx), L(gc.lin_coord_dof)
        t.pd_ke = model.joint_target_ke[..., t.lin_dof]
        t.pd_kd = model.joint_target_kd[..., t.lin_dof]
        t.penalty = None
        if self.limit_mode == "penalty" and len(gc.lin_coord_dof):
            t.penalty = tuple(getattr(model, f"joint_limit_{k}")[..., t.lin_dof]
                              for k in ("lower", "upper", "ke", "kd"))
        bq = gc.quat_coord_starts
        t.ball_q = L(bq[:, 0:1] + np.arange(4)[None])          # (nb, 4)
        t.ball_d = L(bq[:, 1:2] + np.arange(3)[None])          # (nb, 3)
        t.ball_ke = model.joint_target_ke[..., t.ball_d]
        t.ball_kd = model.joint_target_kd[..., t.ball_d]
        # fixed tendons as dense maps: L = q C_q^T, Ldot = qd C_d^T,
        # tau += f C_d, (T, nq) and (T, d), or (n, T, ...) where the rows'
        # tendons differ (the padding entries carry coef 0)
        T = st.tendon_count
        t.tendons = T > 0
        if T:
            coef = np.asarray(st.tendon_coef)
            lead = coef.shape[:-2]
            Cq = np.zeros(lead + (T, st.joint_coord_count))
            Cd = np.zeros(lead + (T, st.joint_dof_count))
            for i in np.ndindex(*lead, T):
                np.add.at(Cq[i], st.tendon_coord[i], coef[i])
                np.add.at(Cd[i], st.tendon_dof[i], coef[i])
            t.tendon_Cq, t.tendon_Cd = F(Cq), F(Cd)
            t.tendon_ke, t.tendon_kd, t.tendon_L0 = \
                model.tendon_params.unbind(-1)
        # the implicit integrators' constant part of the damping matrix D:
        # the fixed tendons' kd c c^T, (d, d) or (n, d, d) (the actuators'
        # velocity gains and the spatial tendons' kd enter per substep)
        t.D_tendon = None
        if T and self.integrator in ("implicitfast", "implicit"):
            t.D_tendon = torch.einsum(
                "...t,td,te->...de" if t.tendon_Cd.dim() == 2 else
                "...t,...td,...te->...de", t.tendon_kd, t.tendon_Cd,
                t.tendon_Cd)
        # group row
        t.di, t.bi = L(g.dof_idx[0]), L(g.body_idx[0])
        t.anc = F(g.anc)                                   # (b, d)
        # every local body's dof ancestry (B, d)
        anc_all = np.zeros((st.body_count, g.d), dtype=np.float32)
        anc_all[g.body_idx[0]] = g.anc
        t.anc_bd = F(anc_all)
        # spatial tendons: paths in the row's local bodies, (ke, kd, L0)
        # per tendon ((Ts,) or (n, Ts)); where the rows' paths differ,
        # ``paths`` lists each distinct one and ``sel`` (n, Ts) picks a
        # row's (-1: a padding tendon, no path)
        t.sten = None
        if grp.sten_rows.size:
            ke, kd, L0 = model.sten_params.unbind(-1)
            sr = grp.sten_rows
            keys = [[self._sten_local[k].key() if k >= 0 else None
                     for k in r] for r in sr]
            paths, sel = [self._sten_local[k] for k in sr[0]], None
            if any(r != keys[0] for r in keys[1:]):
                uniq, paths = {}, []
                sel = -np.ones(sr.shape, np.int64)
                for r, row in enumerate(keys):
                    for j, key in enumerate(row):
                        if key is not None:
                            if key not in uniq:
                                uniq[key] = len(paths)
                                paths.append(self._sten_local[sr[r, j]])
                            sel[r, j] = uniq[key]
                sel = L(sel)
            t.sten = SimpleNamespace(paths=paths, sel=sel, ke=ke, kd=kd,
                                     L0=L0)
        t.armature = model.joint_armature[..., t.di]
        # contact rows
        t.cap = None
        if grp.plan is not None:
            self._contact_tables(t, grp, L, B, F)
        # limit rows (none under penalty limits)
        ld, lc = grp.limit_plan
        if self.limit_mode == "penalty":
            ld, lc = ld[:0], lc[:0]
        t.nl = len(ld)
        t.ld = L(ld)
        t.ld_i32 = torch.as_tensor(ld.astype(np.int32), device=dev)
        # the limit rows' one-hots (nl, d), the rows the Newton QP and
        # Kamino's PADMM materialize (B2 reads Minv[:, ld] instead)
        E = np.zeros((len(ld), g.d), dtype=np.float32)
        E[np.arange(len(ld)), ld] = 1.0
        t.lim_E = F(E)
        t.lim_coord = L(g.coord_idx[0][lc]) if len(ld) else L([])
        t.lim_lo = model.joint_limit_lower[..., t.di[t.ld]]
        t.lim_hi = model.joint_limit_upper[..., t.di[t.ld]]
        # equality rows
        t.eq = None
        if grp.eplan is not None:
            t.eq = self._equality_tables(grp.eplan, L, F)
        # integration
        fj = gc.free_joints
        t.free_p = L(fj[:, 0:1] + np.arange(3)[None])
        t.free_q = L(fj[:, 0:1] + np.arange(3, 7)[None])
        t.free_v = L(fj[:, 1:2] + np.arange(3)[None])
        t.free_w = L(fj[:, 1:2] + np.arange(3, 6)[None])
        t.free_com = model.body_com[..., L(fj[:, 2]), :]
        t.vel_limit = model.joint_velocity_limit
        return t

    def _contact_tables(self, t, grp, L, B, F):
        """Per-slot tables over the c entries of a row (the entries gather
        each row's slots first; with K < c the step gathers the top-K of
        each env from them): signs of the dof columns, local bodies, the
        ragged mask, friction and restitution, and the other body of each
        two-sided entry (its constants; its state is read each step)."""
        plan, g, full = grp.plan, grp.gc.groups[0], self.model
        fst = full.structure
        t.cap = self._plan_cap(plan.c, grp)
        anc = np.asarray(g.anc, dtype=np.float32)
        zero = np.zeros((g.d,), dtype=np.float32)

        def side(lb):
            return np.where((lb >= 0)[..., None], anc[np.maximum(lb, 0)],
                            zero)
        t.sign = F(side(plan.lb1) - side(plan.lb0))        # (c|n c, d)
        t.gb0 = L(np.maximum(plan.lb0, 0))
        t.gb1 = L(np.maximum(plan.lb1, 0))
        t.on0 = B(plan.lb0 >= 0)[..., None]
        t.on1 = B(plan.lb1 >= 0)[..., None]
        # ragged plans index the bodies of each row: (n, 1) row numbers
        t.row_col = None if plan.uniform else L(np.arange(g.n)[:, None])
        C = fst.rigid_contact_max
        read = np.minimum(plan.slots, C - 1)
        t.row_slots = L(read)
        t.valid = None if plan.valid is None else B(plan.valid)
        t.slots_are_all = bool(np.array_equal(read[0], np.arange(C)))
        s0 = L(np.maximum(fst.slot_shape0, 0))
        s1 = L(np.maximum(fst.slot_shape1, 0))
        for name, attr in (("mu", "shape_material_mu"),
                           ("e_rest", "shape_material_restitution")):
            v = getattr(full, attr)
            setattr(t, name, _group_rows(0.5 * (v[s0] + v[s1]), read))
        ob = plan.ob
        t.other = None
        if (ob >= 0).any():
            obc = L(np.maximum(ob, 0))                     # (n, c)
            lb1 = np.broadcast_to(plan.lb1, ob.shape)
            t.other = SimpleNamespace(
                body=obc, on=B(ob >= 0)[..., None],
                sgn=F(np.where(lb1 < 0, 1.0, -1.0) * (ob >= 0)),
                inv_mass=full.body_inv_mass[obc],
                inv_inertia=full.body_inv_inertia[obc],
                com=full.body_com[obc])

    def _equality_tables(self, ep, L, F):
        """The equality plan on the device: per constraint its kind and
        local indices (host ints: the rows are built by a loop over the
        constraints, as in the JAX package) and its constants, (3,) or,
        where the rows differ, (n, 3)."""
        return SimpleNamespace(
            rows=ep.rows, kinds=ep.kinds.tolist(), lb1=ep.lb1.tolist(),
            lb2=ep.lb2.tolist(), dof1=ep.dof1.tolist(),
            dof2=ep.dof2.tolist(), coord1=ep.coord1.tolist(),
            coord2=ep.coord2.tolist(),
            anchor1=F(ep.anchor1).unbind(-2), anchor2=F(ep.anchor2).unbind(-2),
            relpose=F(ep.relpose).unbind(-2),
            polycoef=F(ep.polycoef).unbind(-2), identity=F([0, 0, 0, 1]))

    def init_state(self, state):
        """The State with the solver's entries of ``State.custom`` (the JAX
        package's ``init_state``), for each group ``gi``: with sleeping,
        ``sleep:count:<gi>`` (int32 per row), the substeps each row has
        been quiet; with warm start and a contact plan,
        ``contact:lam:<gi>`` (float32 (rows, 3 c)), the last impulses in
        full slot space, block order [n | t1 | t2]; and where the contact
        cap is below the slot count, ``contact:overflow:<gi>`` (int32 per
        row), the number of active contacts that top-K compaction dropped
        in the last step."""
        custom = dict(state.custom)
        dev = state.joint_q.device
        for grp in self.groups:
            gi, n, plan = grp.index, grp.g.n, grp.plan
            if self.sleep_threshold > 0.0:
                custom.setdefault(f"sleep:count:{gi}",
                                  torch.zeros((n,), dtype=torch.int32,
                                              device=dev))
            if self.warm_start and plan is not None and grp.g.d:
                custom.setdefault(f"contact:lam:{gi}",
                                  torch.zeros((n, 3 * plan.c),
                                              dtype=torch.float32,
                                              device=dev))
            if (plan is not None and grp.g.d
                    and self._plan_cap(plan.c, grp) < plan.c):
                custom.setdefault(f"contact:overflow:{gi}",
                                  torch.zeros((n,), dtype=torch.int32,
                                              device=dev))
        return replace(state, custom=custom)

    def step(self, state_in, state_out=None, control=None, contacts=None,
             dt: float = 1e-3, kernels: bool = True,
             record: Optional[dict] = None, report: Optional[dict] = None):
        """One substep of a flat State of the model (every world at once),
        the reference's entry; returns the new State (``state_out`` is not
        written, as in the reference). ``contacts`` are the flat ``(C,)``
        Contacts of ``CollisionPipeline.collide``. See batched.step."""
        from .batched import step
        return step(self, state_in, control, contacts, dt, kernels=kernels,
                    record=record, report=report)

    def step_batched(self, state_b, state_out=None, control_b=None,
                     contacts_b=None, dt: float = 1e-3, kernels: bool = True,
                     record: Optional[dict] = None,
                     report: Optional[dict] = None):
        """One substep of a one-world model over a leading env axis (see
        batched.step_batched)."""
        from .batched import step_batched
        return step_batched(self, state_b, control_b, contacts_b, dt,
                            kernels=kernels, record=record, report=report)

    def step_with_contacts(self, state_in, state_out, control, contacts,
                           dt: float, kernels: bool = True):
        """``step`` (``step_batched`` for a batched ``(W, ...)`` state) and
        the Contacts with ``rigid_contact_force`` filled: each entry's
        impulses along the normal and the two tangents over dt, times its
        plan weight (0.5 on each half of a two-sided contact), added into
        its slot (the JAX package's ``step_with_contacts``). The entries
        of a slot add in a fixed order (a table built once), so two runs
        give the same bits. Returns (State, Contacts)."""
        report = {}
        batched = state_in.joint_q.dim() == 2
        run = self.step_batched if batched else self.step
        out = run(state_in, state_out, control, contacts, dt,
                  kernels=kernels, report=report)
        if contacts is None or contacts.rigid_contact_max == 0:
            return out, contacts
        total, weights = self._force_sum(batched)
        terms = []
        for grp in self.groups:
            if grp.index not in weights:
                continue
            w = weights[grp.index]
            f = report.get("force") if batched else \
                report.get(grp.index, {}).get("force")
            if f is None:
                f = contacts.rigid_contact_force.new_zeros(
                    (contacts.rigid_contact_mask.shape[0] if batched
                     else grp.plan.slots.shape[0]), grp.plan.c, 3)
            f = f * w
            terms.append(f.reshape(f.shape[0], -1, 3) if batched
                         else f.reshape(-1, 3))
        force = total(torch.cat(terms, dim=1 if batched else 0),
                      dim=1 if batched else 0)
        return out, replace(contacts, rigid_contact_force=(
            contacts.rigid_contact_force + force))

    def update_contacts(self, contacts, state_in, state_out=None,
                        dt: float = 1e-3):
        """The contact force report of a step from ``state_in`` with no
        control (the JAX package's ``update_contacts``)."""
        return self.step_with_contacts(state_in, None, None, contacts,
                                       dt)[1]

    def _force_sum(self, batched: bool):
        """The fixed-order sum of every group's contact entries (rows x
        entries, in group order) into the C slots, a ragged plan's pad
        entries dropped, and each group's entry weights ((c, 1) or
        (n, c, 1)) on the device; built once."""
        key = "batched" if batched else "flat"
        sums = self._force_sums
        if key not in sums:
            st = self.model.structure
            C = int(st.rigid_contact_max)
            dst, weights = [], {}
            for grp in self.groups:
                plan = grp.plan
                if plan is None or not grp.g.d:
                    continue
                slots = np.asarray(plan.slots[:1] if batched else plan.slots,
                                   dtype=np.int64)
                if plan.valid is not None:
                    valid = plan.valid[:1] if batched else plan.valid
                    slots = np.where(valid, slots, -1)
                dst.append(np.where(slots < C, slots, -1).reshape(-1))
                weights[grp.index] = torch.as_tensor(
                    np.asarray(plan.w, dtype=np.float32)[..., None],
                    device=self.model.device)
            sums[key] = (FixedOrderSum(
                np.concatenate(dst) if dst else np.zeros(0, np.int64), C,
                self.model.device), weights)
        return sums[key]


class SolverMuJoCo(SolverFeatherstone):
    """The reference's MuJoCo-flavoured front end: ``iterations`` sets the
    contact iterations and ``integrator="auto"`` reads the MJCF
    ``<option integrator=...>`` captured at import (RK4 for gymnasium's
    ant, hopper and walker2d; euler where the asset names none).
    ``solver="newton"`` or ``"cg"`` selects the Newton QP contact solve
    (``contact_solver="newton"``) with ``newton_iterations = max(8,
    ls_iterations)`` when ``ls_iterations`` is given, as in the JAX
    package. Every other keyword goes to ``SolverFeatherstone``: unknown
    keywords raise ``TypeError`` (the JAX package warns and drops them, a
    deliberate difference: a dropped keyword is different physics)."""

    def __init__(self, model: Model, iterations: int = 16,
                 ls_iterations: int = 0, solver: str = "pgs",
                 integrator: str = "auto", **kwargs):
        integ = str(integrator).lower()
        if integ == "auto":
            integ = model.structure.mjc_options.get("integrator", "euler")
        if solver not in ("pgs", "newton", "cg"):
            raise ValueError(f"unknown solver {solver!r}")
        if solver in ("newton", "cg"):
            kwargs["contact_solver"] = "newton"
            if ls_iterations:
                kwargs["newton_iterations"] = max(8, int(ls_iterations))
        super().__init__(model, contact_iterations=iterations,
                         integrator=integ, **kwargs)
