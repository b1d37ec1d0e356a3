"""MuJoCo actuation: gain/bias/dyntype (port of
``newton_tpu/solvers/generalized/actuation.py``).

    force_i = gain_i(L, V) * clamp(ctrl_i) + bias_i(L, V)
    tau    += gear_i * clamp(force_i)          (joint transmission)

``MJCActuation`` holds the host numpy tables the MJCF importer fills;
``ActuationTables`` moves them to the device once, at solver construction.
A row model's parameter tables may carry a leading row axis ``(n, A, ...)``
where the worlds' actuators differ; the dof and coordinate maps are one
row's.
The port covers the stateless joint-transmission path that ``motor``,
``position`` and ``velocity`` actuators take; activation dynamics, muscles
and tendon transmissions raise.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.segment_sum import FixedOrderSum

__all__ = ["MJCActuation", "ActuationTables", "actuator_forces",
           "DYN_NONE", "GAIN_FIXED", "GAIN_AFFINE", "BIAS_NONE",
           "BIAS_AFFINE"]

DYN_NONE, DYN_INTEGRATOR, DYN_FILTER, DYN_FILTEREXACT, DYN_MUSCLE = 0, 1, 2, 3, 4
GAIN_FIXED, GAIN_AFFINE, GAIN_MUSCLE = 0, 1, 2
BIAS_NONE, BIAS_AFFINE, BIAS_MUSCLE = 0, 1, 2


class MJCActuation:
    """Static per-model actuator tables (host numpy; same fields as the JAX
    package's). ``dof``/``coord`` are global dof/coordinate indices."""

    __slots__ = ("n", "dof", "coord", "tendon", "sten", "gear",
                 "dyntype", "dynprm", "gaintype", "gainprm", "biastype",
                 "biasprm", "ctrlrange", "forcerange", "actrange",
                 "ctrllimited", "forcelimited", "actlimited",
                 "lengthrange", "acc0", "has_act", "has_muscle")

    def __init__(self, n: int):
        self.n = n
        self.dof = -np.ones(n, np.int32)
        self.coord = -np.ones(n, np.int32)
        self.tendon = -np.ones(n, np.int32)
        self.sten = -np.ones(n, np.int32)
        self.gear = np.ones(n, np.float64)
        self.dyntype = np.zeros(n, np.int32)
        self.dynprm = np.zeros((n, 3), np.float64)
        self.gaintype = np.zeros(n, np.int32)
        self.gainprm = np.zeros((n, 9), np.float64)
        self.gainprm[:, 0] = 1.0
        self.biastype = np.zeros(n, np.int32)
        self.biasprm = np.zeros((n, 9), np.float64)
        self.ctrlrange = np.tile([-1e30, 1e30], (n, 1))
        self.forcerange = np.tile([-1e30, 1e30], (n, 1))
        self.actrange = np.tile([-1e30, 1e30], (n, 1))
        self.ctrllimited = np.zeros(n, bool)
        self.forcelimited = np.zeros(n, bool)
        self.actlimited = np.zeros(n, bool)
        self.lengthrange = np.zeros((n, 2), np.float64)
        self.acc0 = np.ones(n, np.float64)
        self.has_act = False
        self.has_muscle = False

    def finish(self) -> "MJCActuation":
        self.has_act = bool((self.dyntype != DYN_NONE).any())
        self.has_muscle = bool(
            (self.dyntype == DYN_MUSCLE).any()
            or (self.gaintype == GAIN_MUSCLE).any()
            or (self.biastype == BIAS_MUSCLE).any())
        return self


class ActuationTables:
    """Device copies of the tables ``actuator_forces`` reads."""

    def __init__(self, au: MJCActuation, device, n_dof: int,
                 dtype=torch.float32):
        if au.has_muscle:
            raise NotImplementedError("muscle actuators are not ported yet")
        if au.has_act:
            raise NotImplementedError(
                "actuators with activation dynamics (dyntype != none) are "
                "not ported yet")
        if (au.tendon >= 0).any() or (au.sten >= 0).any() or (au.dof < 0).any():
            raise NotImplementedError(
                "tendon actuator transmissions are not ported yet")
        bad = ~np.isin(au.gaintype, [GAIN_FIXED, GAIN_AFFINE]) | \
            ~np.isin(au.biastype, [BIAS_NONE, BIAS_AFFINE])
        if bad.any():
            raise NotImplementedError("unsupported gain/bias type")

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def i(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=device)

        self.n = au.n
        self.dof = i(au.dof)
        # the actuators' torques into the n_dof dofs in a fixed order (two
        # actuators may share a dof)
        self.dof_sum = FixedOrderSum(au.dof, n_dof, device)
        self.coord = i(au.coord)
        self.gear = f(au.gear)
        cr = np.asarray(au.ctrlrange)
        fr = np.asarray(au.forcerange)
        self.ctrl_lo, self.ctrl_hi = f(cr[..., 0]), f(cr[..., 1])
        self.ctrllimited = torch.as_tensor(au.ctrllimited, device=device)
        self.force_lo, self.force_hi = f(fr[..., 0]), f(fr[..., 1])
        self.forcelimited = torch.as_tensor(au.forcelimited, device=device)
        gp, bp = np.asarray(au.gainprm), np.asarray(au.biasprm)
        self.gp = [f(gp[..., k]) for k in range(3)]
        self.bp = [f(bp[..., k]) for k in range(3)]
        self.gain_affine = torch.as_tensor(au.gaintype == GAIN_AFFINE,
                                           device=device)
        self.bias_affine = torch.as_tensor(au.biastype == BIAS_AFFINE,
                                           device=device)


def actuator_forces(tab: ActuationTables, q: torch.Tensor, qd: torch.Tensor,
                    ctrl: torch.Tensor) -> torch.Tensor:
    """Generalized actuator torques, env-major: q (W, nq), qd (W, D),
    ctrl (W, A) -> tau (W, D)."""
    gear = tab.gear
    length = gear * q[:, tab.coord]
    velocity = gear * qd[:, tab.dof]
    ctrl_c = torch.where(tab.ctrllimited,
                         torch.clamp(ctrl, tab.ctrl_lo, tab.ctrl_hi), ctrl)
    gp, bp = tab.gp, tab.bp
    gain = torch.where(tab.gain_affine,
                       gp[0] + gp[1] * length + gp[2] * velocity,
                       gp[0].expand_as(length))
    bias = torch.where(tab.bias_affine,
                       bp[0] + bp[1] * length + bp[2] * velocity,
                       torch.zeros_like(length))
    force = gain * ctrl_c + bias
    force = torch.where(tab.forcelimited,
                        torch.clamp(force, tab.force_lo, tab.force_hi), force)
    return tab.dof_sum(gear * force, dim=1)
