"""Effort clamping models (port of ``newton_tpu/actuators/clamping.py``)."""

from __future__ import annotations

import torch

__all__ = ["ClampMaxEffort", "ClampPositionBased", "ClampDCMotor"]


class ClampMaxEffort:
    """Symmetric effort limit: ``max_effort``, or each dof's
    ``joint_effort_limit``."""

    def __init__(self, max_effort=None):
        self.max_effort = max_effort

    def __call__(self, model, state, effort, dof_indices):
        if self.max_effort is None:
            cap = model.joint_effort_limit[dof_indices]
            return torch.clamp(effort, -cap, cap)
        return torch.clamp(effort, -self.max_effort, self.max_effort)


class ClampPositionBased:
    """Effort limit scaled down to 0 within ``margin`` of a joint limit.
    As in the JAX package, the position read is ``joint_q`` at the DOF
    indices (ROADMAP C.36: where a joint's coordinates and dofs are
    numbered apart, behind a free root, that is another coordinate); when
    ``joint_q`` is shorter than the largest index, only the effort limit
    applies."""

    def __init__(self, margin: float = 0.1):
        self.margin = float(margin)

    def __call__(self, model, state, effort, dof_indices):
        lo = model.joint_limit_lower[dof_indices]
        hi = model.joint_limit_upper[dof_indices]
        cap = model.joint_effort_limit[dof_indices]
        n_max = getattr(self, "_n_max", None)
        if n_max is None or n_max[0] is not dof_indices:
            # the largest index, read once per index tensor
            n_max = self._n_max = (dof_indices,
                                   int(dof_indices.max()) if
                                   dof_indices.numel() else 0)
        if state.joint_q.shape[0] <= n_max[1]:
            return torch.clamp(effort, -cap, cap)
        q = state.joint_q[dof_indices]
        up = torch.clamp((hi - q) / self.margin, 0.0, 1.0)
        dn = torch.clamp((q - lo) / self.margin, 0.0, 1.0)
        return torch.clamp(effort, -cap * dn, cap * up)


class ClampDCMotor:
    """DC-motor torque-speed curve: the torque available in each
    direction falls linearly with the velocity, to 0 at the no-load
    speed."""

    def __init__(self, stall_torque: float, no_load_speed: float):
        self.stall_torque = float(stall_torque)
        self.no_load_speed = float(no_load_speed)

    def __call__(self, model, state, effort, dof_indices):
        qd = state.joint_qd[dof_indices]
        avail_pos = self.stall_torque * torch.clamp(
            1.0 - qd / self.no_load_speed, 0.0, 1.0)
        avail_neg = self.stall_torque * torch.clamp(
            1.0 + qd / self.no_load_speed, 0.0, 1.0)
        return torch.clamp(effort, -avail_neg, avail_pos)
