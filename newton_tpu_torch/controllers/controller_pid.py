"""PID controller with an explicit integral carry (port of
``newton_tpu/controllers/controller_pid.py``)."""

from __future__ import annotations

import math

import torch

from ._gains import DeviceValue, coords_and_dofs

__all__ = ["ControllerPID"]


class ControllerPID:
    """Stateful PID: ``step(integral, model, state, command, dof_indices,
    dt)`` -> (integral, effort), with the integral of the position error
    clamped to +-``i_limit``; :meth:`init` gives the zero integral."""

    def __init__(self, kp, ki, kd, i_limit=math.inf, coord_indices=None):
        self.kp = DeviceValue(kp)
        self.ki = DeviceValue(ki)
        self.kd = DeviceValue(kd)
        self.i_limit = i_limit
        self.coord_indices = (None if coord_indices is None
                              else DeviceValue(coord_indices, torch.long))

    def init(self, n, device=None):
        return torch.zeros((n,), device=device)

    def step(self, integral, model, state, command, dof_indices, dt):
        ci, di = coords_and_dofs(self.coord_indices, dof_indices,
                                 state.joint_q)
        q, qd = state.joint_q[ci], state.joint_qd[di]
        err = torch.as_tensor(command, device=q.device) - q
        integral = torch.clamp(integral + err * dt, -self.i_limit,
                               self.i_limit)
        effort = (self.kp.on(q) * err + self.ki.on(q) * integral
                  - self.kd.on(q) * qd)
        return integral, effort
