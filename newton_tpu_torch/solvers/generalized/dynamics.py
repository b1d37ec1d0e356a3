"""Host-side tables for generalized-coordinate dynamics (port of
``GeneralizedCache`` in ``newton_tpu/solvers/generalized/dynamics.py``).

Each dof's motion subspace is a world-frame twist at the origin; the
ancestor mask ``anc[b, d]`` says whether dof d moves body b. Articulations
are grouped by topology signature; the batched step runs one group row at
a time. Built once per ModelStructure, numpy only.
"""

from __future__ import annotations

from typing import Dict, List

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

        dof_joint = np.zeros(D, dtype=np.int32)
        dof_is_linear = np.zeros(D, dtype=bool)
        dof_anchor_is_com = np.zeros(D, dtype=bool)   # free angular dofs
        dof_ang_slot = -np.ones(D, dtype=np.int32)
        for j in range(J):
            t = JointType(int(st.joint_type[j]))
            s, e = int(st.joint_qd_start[j]), int(st.joint_qd_start[j + 1])
            dof_joint[s:e] = j
            if t == JointType.FREE:
                dof_is_linear[s:s + 3] = True
                dof_anchor_is_com[s + 3:e] = True
                continue
            ln = int(st.joint_dof_dim[j, 0])
            dof_is_linear[s:s + ln] = True
            for k in range(int(st.joint_dof_dim[j, 1])):
                dof_ang_slot[s + ln + k] = k
        self.dof_joint = dof_joint
        self.dof_is_linear = dof_is_linear
        self.dof_anchor_is_com = dof_anchor_is_com
        self.dof_ang_slot = dof_ang_slot
        self.dof_body = st.joint_child[dof_joint] if D \
            else np.zeros(0, np.int32)

        anc = np.zeros((B, D), dtype=bool)
        child_of = {int(st.joint_child[j]): j for j in range(J)}
        for b in range(B):
            j = child_of.get(b, -1)
            while j >= 0:
                s, e = int(st.joint_qd_start[j]), int(st.joint_qd_start[j + 1])
                anc[b, s:e] = True
                j = int(st.joint_parent_joint[j])
        self.anc = anc

        art_start = st.articulation_start
        sigs: Dict[tuple, List[int]] = {}
        for a in range(len(art_start) - 1):
            j0, j1 = int(art_start[a]), int(art_start[a + 1])
            sig = []
            for j in range(j0, j1):
                pj = int(st.joint_parent_joint[j])
                sig.append((int(st.joint_type[j]), pj - j0 if pj >= 0 else -1,
                            int(st.joint_qd_start[j + 1] - st.joint_qd_start[j]),
                            int(st.joint_q_start[j + 1] - st.joint_q_start[j])))
            sigs.setdefault(tuple(sig), []).append(a)
        self.groups: List[ArticulationGroup] = []
        for sig, arts in sigs.items():
            if not sig:
                continue
            dof_rows, body_rows, coord_rows = [], [], []
            for a in arts:
                j0, j1 = int(art_start[a]), int(art_start[a + 1])
                dof_rows.append(np.arange(st.joint_qd_start[j0],
                                          st.joint_qd_start[j1],
                                          dtype=np.int32))
                coord_rows.append(np.arange(st.joint_q_start[j0],
                                            st.joint_q_start[j1],
                                            dtype=np.int32))
                body_rows.append(np.asarray(sorted(
                    {int(st.joint_child[j]) for j in range(j0, j1)}),
                    dtype=np.int32))
            self.groups.append(ArticulationGroup(
                arts, np.stack(dof_rows), np.stack(body_rows),
                anc[body_rows[0]][:, dof_rows[0]], np.stack(coord_rows)))

        # coordinate integration plan
        lin_idx, lin_dof, free = [], [], []
        for j in range(J):
            t = JointType(int(st.joint_type[j]))
            qs, ds = int(st.joint_q_start[j]), int(st.joint_qd_start[j])
            nq = int(st.joint_q_start[j + 1]) - qs
            if t == JointType.FREE:
                free.append((qs, ds, int(st.joint_child[j])))
            else:
                lin_idx.extend(range(qs, qs + nq))
                lin_dof.extend(range(ds, ds + nq))
        self.lin_coord_idx = np.asarray(lin_idx, dtype=np.int32)
        self.lin_coord_dof = np.asarray(lin_dof, dtype=np.int32)
        self.free_joints = np.asarray(free, dtype=np.int32).reshape(-1, 3)


def get_generalized_cache(st: ModelStructure) -> GeneralizedCache:
    cache = getattr(st, "_gen_cache", None)
    if cache is None:
        cache = GeneralizedCache(st)
        st._gen_cache = cache
    return cache
