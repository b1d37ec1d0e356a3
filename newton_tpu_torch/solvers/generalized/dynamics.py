"""Host-side tables for generalized-coordinate dynamics (port of
``GeneralizedCache`` in ``newton_tpu/solvers/generalized/dynamics.py``).

Each dof's motion subspace is a world-frame twist at the origin (a ball
joint's three dofs rotate about the canonical axes of its joint-parent
frame, through its anchor); the
ancestor mask ``anc[b, d]`` of a group says whether its dof d moves its
body b. Articulations are grouped by topology signature; a group's rows
(one per articulation: N rows for N replicated worlds) share one ancestor
mask. Built once per ModelStructure with array operations (no loop over
bodies, joints or worlds), numpy only.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ...sim.articulation import get_kinematic_cache
from ...sim.enums import JointType
from ...sim.model import ModelStructure

__all__ = ["ArticulationGroup", "GeneralizedCache", "get_generalized_cache"]


class ArticulationGroup:
    """Articulations with identical topology, batched together."""

    __slots__ = ("arts", "dof_idx", "body_idx", "anc", "n", "d", "b",
                 "coord_idx", "nq")

    def __init__(self, arts, dof_idx, body_idx, anc, coord_idx):
        self.arts = np.asarray(arts, dtype=np.int32)
        self.dof_idx = dof_idx      # (n, d) global dof indices
        self.body_idx = body_idx    # (n, b) global body indices
        self.anc = anc              # (b, d) ancestor mask
        self.coord_idx = coord_idx  # (n, nq) global coord indices
        self.n, self.d = dof_idx.shape
        self.b = body_idx.shape[1]
        self.nq = coord_idx.shape[1]


class GeneralizedCache:
    def __init__(self, st: ModelStructure):
        kc = get_kinematic_cache(st)
        self.kc = kc
        J, D, B = st.joint_count, st.joint_dof_count, st.body_count
        self.D, self.B = D, B
        jt = np.asarray(st.joint_type, dtype=np.int64)
        jq = np.asarray(st.joint_q_start, dtype=np.int64)
        jqd = np.asarray(st.joint_qd_start, dtype=np.int64)
        dim = np.asarray(st.joint_dof_dim, dtype=np.int64).reshape(-1, 2)
        qd_w, q_w = np.diff(jqd), np.diff(jq)

        # per dof: its joint, its offset in the joint, and the joint's kind
        dof_joint = np.repeat(np.arange(J, dtype=np.int32), qd_w)
        off = np.arange(D) - jqd[:-1][dof_joint] if D else np.zeros(0, int)
        # a distance joint has a free joint's layout (6 dofs, 7 coordinates)
        free_kinds = [int(JointType.FREE), int(JointType.DISTANCE)]
        free = np.isin(jt[dof_joint], free_kinds)
        ln = dim[dof_joint, 0]
        self.dof_joint = dof_joint
        self.dof_is_linear = np.where(free, off < 3, off < ln)
        self.dof_anchor_is_com = free & (off >= 3)     # free angular dofs
        ball = jt[dof_joint] == int(JointType.BALL)
        self.dof_ang_slot = np.where(
            ~free & ~ball & (off >= ln) & (off - ln < dim[dof_joint, 1]),
            off - ln, -1).astype(np.int32)
        self.dof_body = st.joint_child[dof_joint] if D \
            else np.zeros(0, np.int32)

        # articulations grouped by topology signature, in order of first
        # appearance: per joint (type, parent joint relative to the
        # articulation's first, dof count, coordinate count)
        art_start = np.asarray(st.articulation_start, dtype=np.int64)
        nj = np.diff(art_start)
        pj = np.asarray(st.joint_parent_joint, dtype=np.int64)
        art_of = np.repeat(np.arange(len(nj)), nj)
        rel = np.where(pj >= 0, pj - art_start[:-1][art_of], -1)
        sig = np.stack([jt, rel, qd_w, q_w], 1) if J \
            else np.zeros((0, 4), np.int64)
        self.groups: List[ArticulationGroup] = []
        found = []
        for n in np.unique(nj[nj > 0]):
            arts = np.nonzero(nj == n)[0]
            joints = art_start[:-1][arts][:, None] + np.arange(n)[None]
            rows = sig[joints].reshape(len(arts), -1)
            _, first, inv = np.unique(rows, axis=0, return_index=True,
                                      return_inverse=True)
            inv = inv.reshape(-1)
            for u in range(len(first)):
                found.append((arts[first[u]], arts[inv == u], joints[0]))
        for _, arts, _ in sorted(found, key=lambda f: f[0]):
            j0 = art_start[arts]
            n_j = int(nj[arts[0]])
            d, nq = int(jqd[j0[0] + n_j] - jqd[j0[0]]), \
                int(jq[j0[0] + n_j] - jq[j0[0]])
            dof_idx = (jqd[j0][:, None] + np.arange(d)).astype(np.int32)
            coord_idx = (jq[j0][:, None] + np.arange(nq)).astype(np.int32)
            children = st.joint_child[j0[:, None] + np.arange(n_j)]
            body_idx = np.sort(children, axis=1).astype(np.int32)
            self.groups.append(ArticulationGroup(
                arts, dof_idx, body_idx,
                self._row_ancestors(st, body_idx[0], dof_idx[0]),
                coord_idx))

        # coordinate integration plan: the coordinates of every joint but
        # the free and ball ones advance with its dofs of the same offset;
        # a ball joint's quaternion (q start, dof start) integrates its
        # three dofs as the angular velocity in the joint-parent frame
        nonfree = ~np.isin(jt, free_kinds)
        is_ball = jt == int(JointType.BALL)
        wq = np.where(nonfree & ~is_ball, q_w, 0)
        jj = np.repeat(np.arange(J), wq)
        k = np.arange(int(wq.sum())) - np.repeat(np.cumsum(wq) - wq, wq)
        self.lin_coord_idx = (jq[:-1][jj] + k).astype(np.int32)
        self.lin_coord_dof = (jqd[:-1][jj] + k).astype(np.int32)
        bj = np.nonzero(is_ball)[0]
        self.quat_coord_starts = np.stack(
            [jq[:-1][bj], jqd[:-1][bj]], 1).astype(np.int32).reshape(-1, 2)
        fj = np.nonzero(~nonfree)[0]
        self.free_joints = np.stack(
            [jq[:-1][fj], jqd[:-1][fj], st.joint_child[fj]],
            1).astype(np.int32).reshape(-1, 3)

    @staticmethod
    def _row_ancestors(st, bodies, dofs):
        """anc[b, d] of one group row: does dof dofs[d] move body
        bodies[b] (its joint on the path from the body to the root)."""
        pos = {int(q): i for i, q in enumerate(dofs)}
        child_of = np.full(st.body_count + 1, -1, dtype=np.int64)
        child_of[st.joint_child] = np.arange(st.joint_count)
        anc = np.zeros((len(bodies), len(dofs)), dtype=bool)
        for i, b in enumerate(bodies):
            j = int(child_of[b])
            while j >= 0:
                for q in range(int(st.joint_qd_start[j]),
                               int(st.joint_qd_start[j + 1])):
                    if q in pos:
                        anc[i, pos[q]] = True
                j = int(st.joint_parent_joint[j])
        return anc


def get_generalized_cache(st: ModelStructure) -> GeneralizedCache:
    cache = getattr(st, "_gen_cache", None)
    if cache is None:
        cache = GeneralizedCache(st)
        st._gen_cache = cache
    return cache
