"""PD controller (port of ``newton_tpu/controllers/controller_pd.py``),
with the Actuator controller signature."""

from __future__ import annotations

import torch

from ._gains import DeviceValue, coords_and_dofs, targets

__all__ = ["ControllerPD"]


class ControllerPD:
    """effort = kp (q_target - q) + kd (qd_target - qd). ``command`` is the
    position target (n,) or [q_target, qd_target] (2, n);
    ``coord_indices`` the coordinates read for q (default: the dof
    indices)."""

    def __init__(self, kp, kd, coord_indices=None):
        self.kp = DeviceValue(kp)
        self.kd = DeviceValue(kd)
        self.coord_indices = (None if coord_indices is None
                              else DeviceValue(coord_indices, torch.long))

    def __call__(self, model, state, command, dof_indices):
        ci, di = coords_and_dofs(self.coord_indices, dof_indices,
                                 state.joint_q)
        q, qd = state.joint_q[ci], state.joint_qd[di]
        qt, qdt = targets(command, qd)
        return self.kp.on(q) * (qt - q) + self.kd.on(q) * (qdt - qd)
