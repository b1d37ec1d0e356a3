"""Joint-impedance controllers, model-free and model-based (port of
``newton_tpu/controllers/joint_impedance.py``). The model-based one
shapes the closed loop with the mass matrix and adds the bias forces
(gravity, Coriolis) of the port's batched CRBA and RNEA
(``sim/dynamics_api.py``)."""

from __future__ import annotations

import torch

from ._gains import DeviceValue, coords_and_dofs, targets

__all__ = ["JointImpedanceModelFree", "JointImpedanceModelBased"]


class JointImpedanceModelFree:
    """tau = kp (q* - q) + kd (qd* - qd)."""

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


class JointImpedanceModelBased:
    """tau = M(q) (kp e + kd ed) + bias(q, qd) over every articulation
    group, read at the controlled dofs."""

    def __init__(self, model, kp, kd, coord_indices=None):
        self.model = model
        self.kp = DeviceValue(kp)
        self.kd = DeviceValue(kd)
        self.coord_indices = (None if coord_indices is None
                              else DeviceValue(coord_indices, torch.long))

    def __call__(self, model, state, command, dof_indices):
        from ..sim.dynamics_api import _groups
        from ..solvers.generalized.batched import _bias_forces, _crba
        ci, di = coords_and_dofs(self.coord_indices, dof_indices,
                                 state.joint_q)
        q, qd = state.joint_q[ci], state.joint_qd[di]
        qt, qdt = targets(command, qd)
        a_des = torch.zeros_like(state.joint_qd)
        a_des[di] = self.kp.on(q) * (qt - q) + self.kd.on(q) * (qdt - qd)
        tau = torch.zeros_like(state.joint_qd)
        bias = torch.zeros_like(state.joint_qd)
        for grp, rows, v_o, w_o, x_b, Iw in _groups(model, state):
            t = grp.tables
            dofs = t.row_dof[:, t.di]
            M = _crba(t, v_o, w_o, x_b, Iw, grp.row_model.body_mass)
            tau[dofs] = torch.einsum("nde,ne->nd", M, a_des[dofs])
            bias[dofs] = _bias_forces(t, grp.row_model, rows.body_qd, v_o,
                                      w_o, x_b, Iw)[:, t.di]
        return (tau + bias)[di]
