"""ArticulationView: batched RL access to the articulations of a model
(port of ``newton_tpu/utils/selection.py``).

Every accessor is a gather through index tensors that live on the model's
device (built once, in ``__init__``), and every setter returns a new
State, Control or Model (``dataclasses.replace``) whose tensor is a copy
with the view's entries written: nothing is read back to the host, so a
policy loop on the card runs without host syncs. Shapes are batched
``(count, ...)`` over the matched articulations in articulation order;
for a replicated scene that is ``(num_envs, ...)``.
"""

from __future__ import annotations

import fnmatch
import re
from dataclasses import replace
from typing import List, Sequence

import numpy as np
import torch

from ..sim.articulation import eval_fk
from ..sim.control import Control
from ..sim.enums import JointType
from ..sim.model import Model
from ..sim.state import State

__all__ = ["ArticulationView", "match_labels"]


def match_labels(keys: List[str], pattern) -> List[int]:
    """Indices of ``keys`` matched by a glob, else a regular expression,
    a list of patterns, or explicit indices (``None``/``"*"``: all)."""
    if pattern is None or pattern == "*":
        return list(range(len(keys)))
    if isinstance(pattern, (list, tuple, np.ndarray)) and len(pattern) \
            and isinstance(pattern[0], (int, np.integer)):
        return [int(i) for i in pattern]
    if isinstance(pattern, (list, tuple)):
        out = []
        for p in pattern:
            out.extend(match_labels(keys, p))
        return sorted(set(out))
    matched = [i for i, k in enumerate(keys) if fnmatch.fnmatch(k, pattern)]
    if not matched:
        try:
            rx = re.compile(pattern)
            matched = [i for i, k in enumerate(keys) if rx.search(k)]
        except re.error:
            pass
    return matched


def _set_rows(full: torch.Tensor, idx: torch.Tensor, values, mask):
    """A copy of ``full`` with ``full[idx] = values`` (rows of ``idx``
    where ``mask`` (n,) is False keep their entries)."""
    values = torch.as_tensor(values, dtype=full.dtype, device=full.device)
    values = values.expand(idx.shape + full.shape[1:])
    if mask is not None:
        m = torch.as_tensor(mask, dtype=torch.bool, device=full.device)
        values = torch.where(m.reshape((-1,) + (1,) * (values.dim() - 1)),
                             values, full[idx])
    out = full.clone()
    out[idx] = values
    return out


class ArticulationView:
    """Batched view over the articulations whose keys match ``pattern``
    (glob, regular expression or indices); ``exclude_joint_types`` drops
    joints of those types from the dof and coordinate sets."""

    def __init__(self, model: Model, pattern="*", verbose: bool = False,
                 exclude_joint_types: Sequence[JointType] = ()):
        self.model = model
        st = model.structure
        self.articulation_indices = match_labels(st.articulation_key, pattern)
        if not self.articulation_indices:
            raise ValueError(f"No articulations match {pattern!r}")
        art_start = np.asarray(st.articulation_start, dtype=np.int64)
        jq = np.asarray(st.joint_q_start, dtype=np.int64)
        jqd = np.asarray(st.joint_qd_start, dtype=np.int64)
        excl = {int(t) for t in exclude_joint_types}

        dof_rows, coord_rows, link_rows, joint_rows = [], [], [], []
        root_joint, root_body = [], []
        for a in self.articulation_indices:
            j0, j1 = int(art_start[a]), int(art_start[a + 1])
            joints = [j for j in range(j0, j1)
                      if int(st.joint_type[j]) not in excl]
            dof_rows.append([d for j in joints
                             for d in range(jqd[j], jqd[j + 1])])
            coord_rows.append([q for j in joints
                               for q in range(jq[j], jq[j + 1])])
            link_rows.append(sorted({int(st.joint_child[j])
                                     for j in range(j0, j1)}))
            joint_rows.append(joints)
            root_joint.append(j0)
            root_body.append(int(st.joint_child[j0]))
        if len({len(r) for r in dof_rows}) != 1:
            raise ValueError("Matched articulations have differing dof "
                             "counts; narrow the pattern")
        shape_body = np.asarray(st.shape_body)
        shape_rows = [np.nonzero(np.isin(shape_body, links))[0].tolist()
                      for links in link_rows]
        dev = model.device

        def L(rows):
            return torch.as_tensor(np.asarray(rows, dtype=np.int64),
                                   device=dev)
        self.dof_idx = L(dof_rows)                        # (n, d)
        self.coord_idx = L(coord_rows)                    # (n, nq)
        self.link_idx = L(link_rows)                      # (n, L)
        self.joint_idx = L(joint_rows)
        self.shape_idx = (L(shape_rows) if len({len(r) for r in shape_rows})
                          == 1 and shape_rows[0] else None)
        self.root_joint = L(root_joint)
        self.root_body = L(root_body)
        self._arts = L(self.articulation_indices)
        self.count = len(self.articulation_indices)
        self.joint_dof_count = self.dof_idx.shape[1]
        self.joint_coord_count = self.coord_idx.shape[1]
        self.link_count = self.link_idx.shape[1]
        rt = np.asarray(st.joint_type)[root_joint]
        self.root_is_free = bool(len(rt)) and bool(
            (rt == int(JointType.FREE)).all())
        if self.root_is_free:
            self._root_q = L(jq[root_joint][:, None] + np.arange(7))
            self._root_qd = L(jqd[root_joint][:, None] + np.arange(6))
        self.joint_names = [st.joint_key[j] for j in joint_rows[0]] \
            if joint_rows[0] else []
        self._mask_template = torch.zeros(st.articulation_count,
                                          dtype=torch.bool, device=dev)
        self._mask_template[self._arts] = True

    # ------------------------------------------------------------------
    # generic attribute access
    # ------------------------------------------------------------------
    def _index_for(self, n0: int):
        """The view's index tensor for an attribute of leading size
        ``n0`` (its frequency: dofs, coordinates, bodies, joints,
        articulations or shapes)."""
        st = self.model.structure
        for count, idx in ((st.joint_dof_count, self.dof_idx),
                           (st.joint_coord_count, self.coord_idx),
                           (st.body_count, self.link_idx),
                           (st.joint_count, self.joint_idx),
                           (st.articulation_count, self._arts)):
            if n0 == count:
                return idx
        if n0 == st.shape_count and self.shape_idx is not None:
            return self.shape_idx
        return None

    def get_attribute(self, name: str, source):
        """A Model, State or Control attribute (or ``custom`` entry)
        gathered over the view, its frequency inferred from its leading
        size."""
        arr = getattr(source, name, None)
        if arr is None and hasattr(source, "custom"):
            arr = source.custom.get(name)
        if arr is None:
            raise AttributeError(name)
        idx = self._index_for(arr.shape[0])
        if idx is None:
            raise ValueError(f"Cannot infer frequency for {name} "
                             f"(len {arr.shape[0]})")
        return arr[idx]

    def set_attribute(self, name: str, source, values, mask=None):
        """``source`` with the view's entries of attribute ``name`` set to
        ``values`` (rows where ``mask`` is False keep theirs)."""
        self.get_attribute(name, source)
        full = getattr(source, name, None)
        if full is None:
            custom = dict(source.custom)
            full = custom[name]
            custom[name] = _set_rows(full, self._index_for(full.shape[0]),
                                     values, mask)
            return replace(source, custom=custom)
        return replace(source, **{name: _set_rows(
            full, self._index_for(full.shape[0]), values, mask)})

    # ------------------------------------------------------------------
    # dof state
    # ------------------------------------------------------------------
    def get_dof_positions(self, state: State) -> torch.Tensor:
        return state.joint_q[self.coord_idx]

    def get_dof_velocities(self, state: State) -> torch.Tensor:
        return state.joint_qd[self.dof_idx]

    def set_dof_positions(self, state: State, q, mask=None) -> State:
        return replace(state, joint_q=_set_rows(state.joint_q,
                                                self.coord_idx, q, mask))

    def set_dof_velocities(self, state: State, qd, mask=None) -> State:
        return replace(state, joint_qd=_set_rows(state.joint_qd,
                                                 self.dof_idx, qd, mask))

    def get_dof_forces(self, control: Control) -> torch.Tensor:
        return control.joint_f[self.dof_idx]

    def set_dof_forces(self, control: Control, f, mask=None) -> Control:
        return replace(control, joint_f=_set_rows(control.joint_f,
                                                  self.dof_idx, f, mask))

    def get_dof_position_targets(self, control: Control) -> torch.Tensor:
        return control.joint_target_q[self.coord_idx]

    def set_dof_position_targets(self, control: Control, q) -> Control:
        return replace(control, joint_target_q=_set_rows(
            control.joint_target_q, self.coord_idx, q, None))

    def get_dof_velocity_targets(self, control: Control) -> torch.Tensor:
        return control.joint_target_qd[self.dof_idx]

    def set_dof_velocity_targets(self, control: Control, qd) -> Control:
        return replace(control, joint_target_qd=_set_rows(
            control.joint_target_qd, self.dof_idx, qd, None))

    def get_dof_limits(self):
        return (self.model.joint_limit_lower[self.dof_idx],
                self.model.joint_limit_upper[self.dof_idx])

    # ------------------------------------------------------------------
    # root state: a free root reads and writes its coordinates, any other
    # root its body
    # ------------------------------------------------------------------
    def get_root_transforms(self, state: State) -> torch.Tensor:
        if self.root_is_free:
            return state.joint_q[self._root_q]
        return state.body_q[self.root_body]

    def set_root_transforms(self, state: State, xf, mask=None) -> State:
        if self.root_is_free:
            return replace(state, joint_q=_set_rows(state.joint_q,
                                                    self._root_q, xf, mask))
        return replace(state, body_q=_set_rows(state.body_q, self.root_body,
                                               xf, mask))

    def get_root_velocities(self, state: State) -> torch.Tensor:
        if self.root_is_free:
            return state.joint_qd[self._root_qd]
        return state.body_qd[self.root_body]

    def set_root_velocities(self, state: State, qd, mask=None) -> State:
        if self.root_is_free:
            return replace(state, joint_qd=_set_rows(
                state.joint_qd, self._root_qd, qd, mask))
        return replace(state, body_qd=_set_rows(state.body_qd,
                                                self.root_body, qd, mask))

    # ------------------------------------------------------------------
    # link state
    # ------------------------------------------------------------------
    def get_link_transforms(self, state: State) -> torch.Tensor:
        return state.body_q[self.link_idx]                    # (n, L, 7)

    def get_link_velocities(self, state: State) -> torch.Tensor:
        return state.body_qd[self.link_idx]

    # ------------------------------------------------------------------
    # kinematics
    # ------------------------------------------------------------------
    def articulation_mask(self, mask=None) -> torch.Tensor:
        """(articulation_count,) bool: the view's articulations, or those
        of them that ``mask`` (count,) selects."""
        if mask is None:
            return self._mask_template
        full = torch.zeros_like(self._mask_template)
        full[self._arts] = torch.as_tensor(mask, dtype=torch.bool,
                                           device=full.device)
        return full

    def eval_fk(self, state: State, mask=None) -> State:
        """FK of the view's articulations (those ``mask`` selects); the
        other articulations keep their bodies."""
        return eval_fk(self.model, state.joint_q, state.joint_qd, state,
                       mask=self.articulation_mask(mask))

    # ------------------------------------------------------------------
    # per-view dynamics
    # ------------------------------------------------------------------
    def _group_rows(self):
        """(index among the groups with dofs, row tensor) of this view's
        articulations in the generalized-dynamics group layout."""
        from ..sim.dynamics_api import dynamics_solver
        want = set(self.articulation_indices)
        gi = 0
        for grp in dynamics_solver(self.model).groups:
            if grp.g.d == 0:
                continue
            rows = [i for i, a in enumerate(grp.g.arts) if int(a) in want]
            if len(rows) == len(want):
                return gi, torch.as_tensor(rows, device=self.model.device)
            gi += 1
        raise ValueError("view articulations span multiple topology groups; "
                         "narrow the pattern")

    def eval_mass_matrix(self, state: State) -> torch.Tensor:
        """(n, d, d) joint-space mass matrices of the view."""
        from ..sim.dynamics_api import eval_mass_matrix
        gi, rows = self._group_rows()
        return eval_mass_matrix(self.model, state)[gi][rows]

    def eval_jacobian(self, state: State) -> torch.Tensor:
        """(n, links, 6, d) body Jacobians of the view."""
        from ..sim.dynamics_api import eval_jacobian
        gi, rows = self._group_rows()
        return eval_jacobian(self.model, state)[gi][rows]

    def eval_inverse_dynamics(self, state: State, qdd=None) -> torch.Tensor:
        """(n, d) generalized forces realizing ``qdd`` (n, d) at the
        state."""
        from ..sim.dynamics_api import eval_inverse_dynamics
        full = None
        if qdd is not None:
            full = _set_rows(torch.zeros_like(state.joint_qd), self.dof_idx,
                             qdd, None)
        return eval_inverse_dynamics(self.model, state, full)[self.dof_idx]

    # ------------------------------------------------------------------
    # actuator gains
    # ------------------------------------------------------------------
    def get_gains(self):
        """(n, d) (kp, kd) drive gains over the view's dofs."""
        return (self.model.joint_target_ke[self.dof_idx],
                self.model.joint_target_kd[self.dof_idx])

    def set_gains(self, kp=None, kd=None) -> Model:
        """A new Model with the view's drive gains replaced, also kept as
        ``view.model`` (a solver keeps the model it was built with)."""
        m = self.model
        if kp is not None:
            m = replace(m, joint_target_ke=_set_rows(
                m.joint_target_ke, self.dof_idx, kp, None))
        if kd is not None:
            m = replace(m, joint_target_kd=_set_rows(
                m.joint_target_kd, self.dof_idx, kd, None))
        self.model = m
        return m
