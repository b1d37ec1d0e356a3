"""Level-parallel forward kinematics (port of ``newton_tpu/sim/articulation.py``).

Joints are grouped by depth in the kinematic tree on the host; every level
is processed for all its joints at once, over any leading batch dims
(``(W, ...)`` in the batched step). Per-joint motion is branch-free: one
axis-composition path covers revolute/prismatic/fixed/D6 joints, and static
masks select the free-joint path.

``KinematicCache`` holds the host numpy plans; ``kinematic_tables`` turns
them into index tensors on a device once and caches them, so FK in the
substep builds nothing from numpy.
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
    transform_inverse,
    transform_multiply,
    transform_point,
)
from .enums import JointType
from .model import Model, ModelStructure
from .state import State

__all__ = ["KinematicCache", "get_kinematic_cache", "kinematic_tables",
           "angular_axes", "joint_motion", "eval_fk", "fk_bodies"]


class KinematicCache:
    """Host-precomputed gather plans (same construction as the JAX
    package's)."""

    def __init__(self, st: ModelStructure):
        J = st.joint_count
        self.joint_count = J
        jq, jqd = st.joint_q_start, st.joint_qd_start
        Q = int(jq[-1]) if J else 0
        D = int(jqd[-1]) if J else 0
        q_width = jq[1:] - jq[:-1]
        qd_width = jqd[1:] - jqd[:-1]

        def gather_plan(starts, widths, maxw, total):
            idx = np.zeros((J, maxw), dtype=np.int32)
            mask = np.zeros((J, maxw), dtype=np.float32)
            for j in range(J):
                for k in range(maxw):
                    if k < widths[j]:
                        idx[j, k] = starts[j] + k
                        mask[j, k] = 1.0
                    else:
                        idx[j, k] = min(starts[j], max(total - 1, 0))
            return idx, mask

        self.q_idx, self.q_mask = gather_plan(jq[:-1], q_width, 7, Q)
        self.qd_idx, self.qd_mask = gather_plan(jqd[:-1], qd_width, 6, D)

        lin_n, ang_n = st.joint_dof_dim[:, 0], st.joint_dof_dim[:, 1]
        self.lin_axis_idx = np.zeros((J, 3), dtype=np.int32)
        self.lin_mask = np.zeros((J, 3), dtype=np.float32)
        self.ang_axis_idx = np.zeros((J, 3), dtype=np.int32)
        self.ang_mask = np.zeros((J, 3), dtype=np.float32)
        self.lin_q_idx = np.zeros((J, 3), dtype=np.int32)
        self.ang_q_idx = np.zeros((J, 3), dtype=np.int32)
        excl = (JointType.BALL, JointType.FREE, JointType.DISTANCE,
                JointType.CABLE)
        for j in range(J):
            t = JointType(int(st.joint_type[j]))
            ln = int(lin_n[j]) if t not in excl else 0
            an = int(ang_n[j]) if t not in excl else 0
            for k in range(3):
                self.lin_axis_idx[j, k] = jqd[j] + min(k, max(ln - 1, 0))
                self.ang_axis_idx[j, k] = jqd[j] + ln + min(k, max(an - 1, 0))
                self.lin_q_idx[j, k] = jq[j] + min(k, max(ln - 1, 0))
                self.ang_q_idx[j, k] = jq[j] + ln + min(k, max(an - 1, 0))
                if k < ln:
                    self.lin_mask[j, k] = 1.0
                if k < an:
                    self.ang_mask[j, k] = 1.0
        if Q:
            self.lin_q_idx = np.clip(self.lin_q_idx, 0, Q - 1)
            self.ang_q_idx = np.clip(self.ang_q_idx, 0, Q - 1)
        if D:
            np.clip(self.lin_axis_idx, 0, D - 1, out=self.lin_axis_idx)
            np.clip(self.ang_axis_idx, 0, D - 1, out=self.ang_axis_idx)

        jt = st.joint_type
        self.is_ball = jt == int(JointType.BALL)
        self.is_free = np.isin(jt, [int(JointType.FREE),
                                    int(JointType.DISTANCE)])

        depth = np.zeros(J, dtype=np.int32)
        for j in range(J):
            pj = int(st.joint_parent_joint[j])
            depth[j] = 0 if pj < 0 else depth[pj] + 1
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
    if kc.is_ball.any():
        raise NotImplementedError("ball joints are not ported yet")

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
    A_lin = model.joint_axis[tab.lin_qd_idx] * tab.lin_mask[..., None]
    A_raw = model.joint_axis[tab.ang_qd_idx]
    pad = torch.zeros_like(A_raw)
    pad[..., 0] = 1.0
    # unused angular axes padded with unit X so axis-angle stays finite
    tab.A_lin = A_lin
    tab.A_ang = torch.where(tab.ang_mask[..., None] > 0, A_raw, pad)
    tab.is_free = torch.as_tensor(kc.is_free, device=dev)
    tab.identity = F([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    tab.levels = []
    for level in kc.levels:
        parent = st.joint_parent[level]
        child = st.joint_child[level]
        pc = np.maximum(parent, 0)
        jX_c_inv = transform_inverse(model.joint_X_c[L(level)])
        tab.levels.append(SimpleNamespace(
            j=L(level), parent=L(pc), child=L(child),
            has_parent=torch.as_tensor(parent >= 0, device=dev)[:, None],
            X_p=model.joint_X_p[L(level)], X_c_inv=jX_c_inv,
            com_p=model.body_com[L(pc)], com_c=model.body_com[L(child)],
            free=tab.is_free[L(level)][:, None]))
    kc._tables[dev] = tab
    return tab


def angular_axes(tab, joint_q: torch.Tensor):
    """Intrinsic axis transport of every joint's angular axes: the axes
    a0, a1, a2 ``(..., J, 3)`` in the parent-anchor frame, each rotated by
    the coordinates before it (``r10 = qfromaa(a1, q1) r0``, the JAX
    package's order), and the joint rotation ``(..., J, 4)``."""
    q_ang = joint_q[..., tab.ang_q_idx] * tab.ang_mask        # (..., J, 3)
    A_ang = tab.A_ang                                          # (J, 3, 3)
    a0 = A_ang[:, 0].expand(q_ang.shape)
    r0 = quat_from_axis_angle(a0, q_ang[..., 0])
    a1 = quat_rotate(r0, A_ang[:, 1])
    r10 = quat_mul(quat_from_axis_angle(a1, q_ang[..., 1]), r0)
    a2 = quat_rotate(r10, A_ang[:, 2])
    rot = quat_mul(quat_from_axis_angle(a2, q_ang[..., 2]), r10)
    return (a0, a1, a2), rot


def joint_motion(tab, joint_q: torch.Tensor, joint_qd: torch.Tensor):
    """Local joint transforms ``(..., J, 7)`` and twists ``(..., J, 6)`` in
    the parent-anchor frame, for all joints at once."""
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
    from ``joint_q``/``joint_qd`` (single world or leading batch dims)."""
    body_q, body_qd = fk_bodies(model, joint_q, joint_qd, state.body_q,
                                state.body_qd)
    return replace(state, body_q=body_q, body_qd=body_qd, joint_q=joint_q,
                   joint_qd=joint_qd)
