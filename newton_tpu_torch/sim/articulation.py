"""Level-parallel forward kinematics (port of ``newton_tpu/sim/articulation.py``).

Joints are grouped by depth in the kinematic tree on the host; every level
is processed for all its joints at once, over any leading batch dims
(``(W, ...)`` in the batched step). Per-joint motion is branch-free: one
axis-composition path covers revolute/prismatic/fixed/D6 joints, and static
masks select the free-joint path and the ball-joint path (the quaternion
coordinate as the rotation, the three dofs as the angular velocity in the
joint-parent frame).

``KinematicCache`` holds the host numpy plans; ``kinematic_tables`` turns
them into index tensors on a device once and caches them, so FK in the
substep builds nothing from numpy. ``eval_ik`` inverts maximal coordinates
to generalized ones for every joint at once and writes them with one
indexed copy per array, through a scatter plan built once per structure.
A model's per-joint and per-body constants may carry a leading row axis
(the solver's row models of worlds whose constants differ): every
constant is indexed along its entity axis counted from the end, so
``(J, ...)`` and ``(n, J, ...)`` tables both broadcast against ``(n, ...)``
coordinates.
"""

from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from ..math import (
    cross,
    quat_from_axis_angle,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inv,
    quat_to_axis_angle,
    transform_inverse,
    transform_multiply,
    transform_point,
)
from .enums import JointType
from .model import Model, ModelStructure
from .state import State

__all__ = ["KinematicCache", "get_kinematic_cache", "kinematic_tables",
           "angular_axes", "joint_motion", "eval_fk", "fk_bodies", "eval_ik"]


class KinematicCache:
    """Host-precomputed gather plans (same tables as the JAX package's),
    built with array operations: a model of thousands of worlds has one
    joint per body of every world."""

    def __init__(self, st: ModelStructure):
        J = st.joint_count
        self.joint_count = J
        jq = np.asarray(st.joint_q_start, dtype=np.int64)
        jqd = np.asarray(st.joint_qd_start, dtype=np.int64)
        Q = int(jq[-1]) if J else 0
        D = int(jqd[-1]) if J else 0
        jt = np.asarray(st.joint_type, dtype=np.int64)

        def gather_plan(starts, widths, maxw, total):
            k = np.arange(maxw)[None, :]
            inside = k < widths[:, None]
            fill = np.minimum(starts, max(total - 1, 0))[:, None]
            idx = np.where(inside, starts[:, None] + k, fill)
            return idx.astype(np.int32), inside.astype(np.float32)

        self.q_idx, self.q_mask = gather_plan(jq[:-1], np.diff(jq), 7, Q)
        self.qd_idx, self.qd_mask = gather_plan(jqd[:-1], np.diff(jqd), 6, D)

        excl = np.isin(jt, [int(JointType.BALL), int(JointType.FREE),
                            int(JointType.DISTANCE), int(JointType.CABLE)])
        dim = np.asarray(st.joint_dof_dim, dtype=np.int64).reshape(-1, 2)
        ln = np.where(excl, 0, dim[:, 0])[:, None]
        an = np.where(excl, 0, dim[:, 1])[:, None]
        k = np.arange(3)[None, :]
        lin_k = np.minimum(k, np.maximum(ln - 1, 0))
        ang_k = ln + np.minimum(k, np.maximum(an - 1, 0))
        self.lin_axis_idx = (jqd[:-1, None] + lin_k).astype(np.int32)
        self.ang_axis_idx = (jqd[:-1, None] + ang_k).astype(np.int32)
        self.lin_q_idx = (jq[:-1, None] + lin_k).astype(np.int32)
        self.ang_q_idx = (jq[:-1, None] + ang_k).astype(np.int32)
        self.lin_mask = (k < ln).astype(np.float32)
        self.ang_mask = (k < an).astype(np.float32)
        if Q:
            self.lin_q_idx = np.clip(self.lin_q_idx, 0, Q - 1)
            self.ang_q_idx = np.clip(self.ang_q_idx, 0, Q - 1)
        if D:
            np.clip(self.lin_axis_idx, 0, D - 1, out=self.lin_axis_idx)
            np.clip(self.ang_axis_idx, 0, D - 1, out=self.ang_axis_idx)

        self.is_ball = jt == int(JointType.BALL)
        self.is_free = np.isin(jt, [int(JointType.FREE),
                                    int(JointType.DISTANCE)])

        # depth in the tree: one pass per level over all joints at once
        pj = np.asarray(st.joint_parent_joint, dtype=np.int64)
        depth = np.zeros(J, dtype=np.int32)
        known = pj < 0
        while not known.all():
            step = ~known & known[np.maximum(pj, 0)]
            if not step.any():
                raise ValueError("joint_parent_joint has a cycle")
            depth[step] = depth[pj[step]] + 1
            known |= step
        self.max_depth = int(depth.max()) + 1 if J else 0
        self.levels: List[np.ndarray] = [
            np.nonzero(depth == d)[0].astype(np.int32)
            for d in range(self.max_depth)]
        self.depth = depth
        self._tables = {}


def get_kinematic_cache(st: ModelStructure) -> KinematicCache:
    cache = getattr(st, "_kin_cache", None)
    if cache is None:
        cache = KinematicCache(st)
        st._kin_cache = cache
    return cache


def kinematic_tables(model: Model) -> SimpleNamespace:
    """Device index tensors and per-joint constants for FK, built once per
    (structure, device)."""
    st = model.structure
    kc = get_kinematic_cache(st)
    dev = model.device
    tab = kc._tables.get(dev)
    if tab is not None:
        return tab

    def L(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    def F(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)

    tab = SimpleNamespace()
    tab.q_idx, tab.q_mask = L(kc.q_idx), F(kc.q_mask)
    tab.qd_idx, tab.qd_mask = L(kc.qd_idx), F(kc.qd_mask)
    tab.lin_q_idx, tab.ang_q_idx = L(kc.lin_q_idx), L(kc.ang_q_idx)
    tab.lin_qd_idx, tab.ang_qd_idx = L(kc.lin_axis_idx), L(kc.ang_axis_idx)
    tab.lin_mask, tab.ang_mask = F(kc.lin_mask), F(kc.ang_mask)
    A_lin = model.joint_axis[..., tab.lin_qd_idx, :] * tab.lin_mask[..., None]
    A_raw = model.joint_axis[..., tab.ang_qd_idx, :]
    pad = torch.zeros_like(A_raw)
    pad[..., 0] = 1.0
    # unused angular axes padded with unit X so axis-angle stays finite
    tab.A_lin = A_lin
    tab.A_ang = torch.where(tab.ang_mask[..., None] > 0, A_raw, pad)
    tab.is_free = torch.as_tensor(kc.is_free, device=dev)
    tab.is_ball = torch.as_tensor(kc.is_ball, device=dev)
    tab.any_ball = bool(kc.is_ball.any())
    tab.identity = F([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    tab.levels = []
    for level in kc.levels:
        parent = st.joint_parent[level]
        child = st.joint_child[level]
        pc = np.maximum(parent, 0)
        jX_c_inv = transform_inverse(model.joint_X_c[..., L(level), :])
        tab.levels.append(SimpleNamespace(
            j=L(level), parent=L(pc), child=L(child),
            has_parent=torch.as_tensor(parent >= 0, device=dev)[:, None],
            X_p=model.joint_X_p[..., L(level), :], X_c_inv=jX_c_inv,
            com_p=model.body_com[..., L(pc), :],
            com_c=model.body_com[..., L(child), :],
            free=tab.is_free[L(level)][:, None]))
    kc._tables[dev] = tab
    return tab


def angular_axes(tab, joint_q: torch.Tensor):
    """Intrinsic axis transport of every joint's angular axes: the axes
    a0, a1, a2 ``(..., J, 3)`` in the parent-anchor frame, each rotated by
    the coordinates before it (``r10 = qfromaa(a1, q1) r0``, the JAX
    package's order), and the joint rotation ``(..., J, 4)``."""
    q_ang = joint_q[..., tab.ang_q_idx] * tab.ang_mask        # (..., J, 3)
    A_ang = tab.A_ang                                   # ([n,] J, 3, 3)
    a0 = A_ang[..., 0, :].expand(q_ang.shape)
    r0 = quat_from_axis_angle(a0, q_ang[..., 0])
    a1 = quat_rotate(r0, A_ang[..., 1, :])
    r10 = quat_mul(quat_from_axis_angle(a1, q_ang[..., 1]), r0)
    a2 = quat_rotate(r10, A_ang[..., 2, :])
    rot = quat_mul(quat_from_axis_angle(a2, q_ang[..., 2]), r10)
    return (a0, a1, a2), rot


def joint_motion(tab, joint_q: torch.Tensor, joint_qd: torch.Tensor):
    """Local joint transforms ``(..., J, 7)`` and twists ``(..., J, 6)`` in
    the parent-anchor frame, for all joints at once. A model whose joints
    have no coordinates (or no dofs: fixed and cable chains) reads zeros."""
    if joint_q.shape[-1] == 0:
        joint_q = joint_q.new_zeros(*joint_q.shape[:-1], 1)
    if joint_qd.shape[-1] == 0:
        joint_qd = joint_qd.new_zeros(*joint_qd.shape[:-1], 1)
    qj = joint_q[..., tab.q_idx] * tab.q_mask                 # (..., J, 7)
    qdj = joint_qd[..., tab.qd_idx] * tab.qd_mask             # (..., J, 6)
    q_lin = joint_q[..., tab.lin_q_idx] * tab.lin_mask        # (..., J, 3)
    qd_lin = joint_qd[..., tab.lin_qd_idx] * tab.lin_mask
    qd_ang = joint_qd[..., tab.ang_qd_idx] * tab.ang_mask
    A_lin = tab.A_lin                                          # (J, 3, 3)

    pos = (q_lin[..., None] * A_lin).sum(-2)
    vel_v = (qd_lin[..., None] * A_lin).sum(-2)
    (a0, a1, a2), rot = angular_axes(tab, joint_q)
    vel_w = (a0 * qd_ang[..., 0:1] + a1 * qd_ang[..., 1:2]
             + a2 * qd_ang[..., 2:3])

    free = tab.is_free[:, None]
    pos = torch.where(free, qj[..., 0:3], pos)
    rot = torch.where(free, quat_normalize(qj[..., 3:7]), rot)
    vel_v = torch.where(free, qdj[..., 0:3], vel_v)
    vel_w = torch.where(free, qdj[..., 3:6], vel_w)
    if tab.any_ball:
        # ball: the quaternion coordinate, the dofs as the angular velocity
        ball = tab.is_ball[:, None]
        rot = torch.where(ball, quat_normalize(qj[..., 0:4]), rot)
        vel_w = torch.where(ball, qdj[..., 0:3], vel_w)
    return torch.cat([pos, rot], -1), torch.cat([vel_v, vel_w], -1)


def fk_bodies(model: Model, joint_q, joint_qd, body_q0, body_qd0):
    """Body transforms and twists ``[v_com, w]`` from generalized coords."""
    tab = kinematic_tables(model)
    X_j, v_j = joint_motion(tab, joint_q, joint_qd)
    body_q = body_q0.clone()
    body_qd = body_qd0.clone()
    for lv in tab.levels:
        X_wp = torch.where(lv.has_parent, body_q[..., lv.parent, :],
                           tab.identity)
        X_wpj = transform_multiply(X_wp, lv.X_p)
        X_wcj = transform_multiply(X_wpj, X_j[..., lv.j, :])
        X_wc = transform_multiply(X_wcj, lv.X_c_inv)

        x_child = X_wc[..., 0:3]
        qd_p = torch.where(lv.has_parent, body_qd[..., lv.parent, :], 0.0)
        w_parent = qd_p[..., 3:6]
        com_p_world = transform_point(X_wp, lv.com_p)
        v_parent_origin = qd_p[..., 0:3] + cross(w_parent,
                                                 x_child - com_p_world)
        vj = v_j[..., lv.j, :]
        lin_w = quat_rotate(X_wpj[..., 3:7], vj[..., 0:3])
        ang_w = quat_rotate(X_wpj[..., 3:7], vj[..., 3:6])
        com_c_vec = quat_rotate(X_wc[..., 3:7], lv.com_c)
        # free joints define their linear dof at the child COM, others at
        # the child joint anchor
        lin_origin = torch.where(
            lv.free, lin_w - cross(ang_w, com_c_vec),
            lin_w + cross(ang_w, x_child - X_wcj[..., 0:3]))
        w_total = w_parent + ang_w
        v_com = v_parent_origin + lin_origin + cross(w_total, com_c_vec)
        body_q[..., lv.child, :] = X_wc
        body_qd[..., lv.child, :] = torch.cat([v_com, w_total], -1)
    return body_q, body_qd


def eval_fk(model: Model, joint_q: torch.Tensor, joint_qd: torch.Tensor,
            state: State) -> State:
    """Forward kinematics: a new State with ``body_q``/``body_qd`` computed
    from ``joint_q``/``joint_qd``: the flat state of every world of the
    model, or leading batch dims of a one-world model."""
    body_q, body_qd = fk_bodies(model, joint_q, joint_qd, state.body_q,
                                state.body_qd)
    return replace(state, body_q=body_q, body_qd=body_qd, joint_q=joint_q,
                   joint_qd=joint_qd)


# eval_ik's per-joint value columns: coordinates [rel transform (7) |
# linear (3) | angular (3)], dofs [COM velocity (3) | world angular
# velocity (3) | joint-frame angular velocity (3) | linear (3) | angular (3)]
_Q_REL, _Q_LIN, _Q_ANG, _Q_COLS = 0, 7, 10, 13
_D_V, _D_W, _D_WJ, _D_LIN, _D_ANG, _D_COLS = 0, 3, 6, 9, 12, 15


def _ik_plan(st: ModelStructure):
    """Host scatter plan of eval_ik: for each coordinate and dof that a
    joint writes, its flat destination and its (joint, column) source.
    Free joints write their relative transform and world twist, ball joints
    their relative quaternion and joint-frame angular velocity, revolute,
    prismatic and D6 joints their linear then angular axes' values; fixed
    joints write nothing (their entries stay 0)."""
    J = st.joint_count
    jt = np.asarray(st.joint_type, dtype=np.int64)
    qs = np.asarray(st.joint_q_start, dtype=np.int64)[:J]
    ds = np.asarray(st.joint_qd_start, dtype=np.int64)[:J]
    dim = np.asarray(st.joint_dof_dim, dtype=np.int64).reshape(-1, 2)
    free = np.isin(jt, [int(JointType.FREE), int(JointType.DISTANCE)])
    ball = jt == int(JointType.BALL)
    axes = np.isin(jt, [int(JointType.REVOLUTE), int(JointType.PRISMATIC),
                        int(JointType.D6)])
    plan = {"q": ([], []), "d": ([], [])}

    def put(kind, mask, cols):
        starts, width = (qs, _Q_COLS) if kind == "q" else (ds, _D_COLS)
        j = np.nonzero(mask)[0]
        dst, src = plan[kind]
        dst.append((starts[j][:, None] + np.arange(len(cols))).reshape(-1))
        src.append((j[:, None] * width + np.asarray(cols)[None, :])
                   .reshape(-1))

    def span(start, n):
        return list(range(start, start + n))
    put("q", free, span(_Q_REL, 7))
    put("d", free, span(_D_V, 3) + span(_D_W, 3))
    put("q", ball, span(_Q_REL + 3, 4))
    put("d", ball, span(_D_WJ, 3))
    # axis joints: their linear axes first, then their angular axes
    for ln in range(4):
        for an in range(4):
            m = axes & (dim[:, 0] == ln) & (dim[:, 1] == an)
            if m.any():
                put("q", m, span(_Q_LIN, ln) + span(_Q_ANG, an))
                put("d", m, span(_D_LIN, ln) + span(_D_ANG, an))

    def cat(xs):
        return np.concatenate(xs) if xs else np.zeros(0, dtype=np.int64)
    return (cat(plan["q"][0]), cat(plan["q"][1]), cat(plan["d"][0]),
            cat(plan["d"][1]))


def _ik_tables(model: Model) -> SimpleNamespace:
    st = model.structure
    kc = get_kinematic_cache(st)
    dev = model.device
    cache = kc.__dict__.setdefault("_ik_tables", {})
    tab = cache.get(dev)
    if tab is None:
        def L(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)
        q_dst, q_src, d_dst, d_src = _ik_plan(st)
        parent = np.asarray(st.joint_parent, dtype=np.int64)
        tab = SimpleNamespace(
            q_dst=L(q_dst), q_src=L(q_src), d_dst=L(d_dst), d_src=L(d_src),
            parent=L(np.maximum(parent, 0)),
            has_parent=torch.as_tensor(parent >= 0, device=dev)[:, None],
            child=L(st.joint_child))
        cache[dev] = tab
    return tab


def eval_ik(model: Model, state: State):
    """Inverse kinematics of a flat State: (joint_q, joint_qd) from its body
    transforms and twists (the JAX package's ``eval_ik``). Each joint's
    relative transform from the parent anchor to the child anchor gives its
    coordinates: a free joint the transform itself, a ball joint its
    rotation, revolute, prismatic and D6 joints the anchor displacement
    projected on the linear axes and the rotation angle projected on the
    angular axes. Velocities are relative to the parent, in the parent
    anchor frame (a free joint's: the COM velocity and angular velocity
    differences, world frame)."""
    st = model.structure
    dtype = state.body_q.dtype
    dev = state.body_q.device
    joint_q = torch.zeros(st.joint_coord_count, dtype=dtype, device=dev)
    joint_qd = torch.zeros(st.joint_dof_count, dtype=dtype, device=dev)
    if st.joint_count == 0:
        return joint_q, joint_qd
    kin = kinematic_tables(model)
    t = _ik_tables(model)
    body_q, body_qd = state.body_q, state.body_qd
    X_wp = torch.where(t.has_parent, body_q[t.parent], kin.identity)
    X_wpj = transform_multiply(X_wp, model.joint_X_p)
    X_wc = body_q[t.child]
    X_wcj = transform_multiply(X_wc, model.joint_X_c)
    rel = transform_multiply(transform_inverse(X_wpj), X_wcj)

    qd_p = torch.where(t.has_parent, body_qd[t.parent], 0.0)
    qd_c = body_qd[t.child]
    w_rel = qd_c[:, 3:6] - qd_p[:, 3:6]
    x_anchor = X_wcj[:, 0:3]
    com_p = transform_point(X_wp, model.body_com[t.parent])
    com_c = transform_point(X_wc, model.body_com[t.child])
    v_p_at = qd_p[:, 0:3] + cross(qd_p[:, 3:6], x_anchor - com_p)
    v_c_at = qd_c[:, 0:3] + cross(qd_c[:, 3:6], x_anchor - com_c)
    q_pj = X_wpj[:, 3:7]
    w_rel_j = quat_rotate_inv(q_pj, w_rel)
    v_rel_j = quat_rotate_inv(q_pj, v_c_at - v_p_at)

    A_lin, A_ang = kin.A_lin, kin.A_ang                       # (J, 3, 3)
    q_lin = (rel[:, None, 0:3] * A_lin).sum(-1)               # (J, 3)
    qd_lin = (v_rel_j[:, None, :] * A_lin).sum(-1)
    axis_out, ang = quat_to_axis_angle(rel[:, 3:7])
    q_ang = ang[:, None] * (axis_out[:, None, :] * A_ang).sum(-1)
    qd_ang = (w_rel_j[:, None, :] * A_ang).sum(-1)

    vals_q = torch.cat([rel, q_lin, q_ang], -1).reshape(-1)
    vals_d = torch.cat([qd_c[:, 0:3] - qd_p[:, 0:3], w_rel, w_rel_j, qd_lin,
                        qd_ang], -1).reshape(-1)
    joint_q[t.q_dst] = vals_q[t.q_src]
    joint_qd[t.d_dst] = vals_d[t.d_src]
    return joint_q, joint_qd
