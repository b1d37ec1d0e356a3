"""MuJoCo actuation: gain/bias/dyntype and muscles (port of
``newton_tpu/solvers/generalized/actuation.py``).

    force_i = gain_i(L, V) * input_i + bias_i(L, V)
    input_i = act_i                (dyntype != none: activation state)
            = clamp(ctrl_i)        (dyntype == none)
    tau    += moment_i^T clamp(force_i)

where L and V are the transmission's length and velocity: gear times the
joint coordinate and velocity, a fixed tendon's length, or a spatial
tendon's. Activation dynamics (integrator, filter, filterexact, muscle)
advance ``State.custom["mjc:act"]`` once per substep. The muscle gain,
bias and dynamics follow MuJoCo's ``mju_muscleGain``, ``mju_muscleBias``
and ``mju_muscleDynamics``.

``MJCActuation`` holds the host numpy tables the MJCF importer fills;
``ActuationTables`` moves them to the device once, at solver construction.
A row model's tables may carry a leading row axis ``(n, A, ...)`` where the
worlds' actuators differ, the dof, coordinate and tendon maps too (each
row's own transmissions; a row with fewer actuators than the largest is
padded with gear-0 entries). Every sum into the dofs is in a fixed order
(C.17): the joint transmissions through a ``FixedOrderSum`` (per-row maps:
products with one-hot maps), the tendon transmissions as products with
dense maps.
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.segment_sum import FixedOrderSum

__all__ = ["MJCActuation", "ActuationTables", "actuator_forces",
           "muscle_gain", "muscle_bias", "muscle_dynamics",
           "DYN_NONE", "DYN_INTEGRATOR", "DYN_FILTER", "DYN_FILTEREXACT",
           "DYN_MUSCLE", "GAIN_FIXED", "GAIN_AFFINE", "GAIN_MUSCLE",
           "BIAS_NONE", "BIAS_AFFINE", "BIAS_MUSCLE"]

DYN_NONE, DYN_INTEGRATOR, DYN_FILTER, DYN_FILTEREXACT, DYN_MUSCLE = 0, 1, 2, 3, 4
GAIN_FIXED, GAIN_AFFINE, GAIN_MUSCLE = 0, 1, 2
BIAS_NONE, BIAS_AFFINE, BIAS_MUSCLE = 0, 1, 2

_MINVAL = 1e-15


class MJCActuation:
    """Static per-model actuator tables (host numpy; same fields as the JAX
    package's). ``dof``/``coord`` are global dof/coordinate indices (-1 for
    a tendon transmission), ``tendon`` a fixed tendon, ``sten`` a spatial
    tendon (-1: none)."""

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
        self.has_act = bool((np.asarray(self.dyntype) != DYN_NONE).any())
        self.has_muscle = bool(
            (np.asarray(self.dyntype) == DYN_MUSCLE).any()
            or (np.asarray(self.gaintype) == GAIN_MUSCLE).any()
            or (np.asarray(self.biastype) == BIAS_MUSCLE).any())
        return self


# ----------------------------------------------------------------------
# muscle model (MuJoCo mju_muscle*; prm (..., 9) as MuJoCo's gainprm:
# range0, range1, force, scale, lmin, lmax, vmax, fpmax, fvmax)
# ----------------------------------------------------------------------

def _bump(L, A, mid, B):
    """MuJoCo's piecewise-quadratic force-length bump over [A, mid, B]."""
    left = 0.5 * (A + mid)
    right = 0.5 * (mid + B)
    t_a = (L - A) / torch.clamp(left - A, min=_MINVAL)
    t_l = (mid - L) / torch.clamp(mid - left, min=_MINVAL)
    t_r = (L - mid) / torch.clamp(right - mid, min=_MINVAL)
    t_b = (B - L) / torch.clamp(B - right, min=_MINVAL)
    out = torch.where(L < left, 0.5 * t_a * t_a,
                      torch.where(L < mid, 1.0 - 0.5 * t_l * t_l,
                                  torch.where(L < right,
                                              1.0 - 0.5 * t_r * t_r,
                                              0.5 * t_b * t_b)))
    return torch.where((L <= A) | (L >= B), 0.0, out)


def _muscle_LV(length, vel, lengthrange, acc0, prm):
    """Normalized muscle length and velocity and the resolved peak force."""
    r0, r1 = prm[..., 0], prm[..., 1]
    force, scale = prm[..., 2], prm[..., 3]
    vmax = prm[..., 6]
    L0 = (lengthrange[..., 1] - lengthrange[..., 0]) / torch.clamp(
        r1 - r0, min=_MINVAL)
    L = r0 + (length - lengthrange[..., 0]) / torch.clamp(L0, min=_MINVAL)
    V = vel / torch.clamp(L0 * vmax, min=_MINVAL)
    F = torch.where(force < 0, scale / torch.clamp(acc0, min=_MINVAL), force)
    return L, V, F


def muscle_gain(length, vel, lengthrange, acc0, prm):
    """Active force-length-velocity gain (negative: muscles pull)."""
    lmin, lmax = prm[..., 4], prm[..., 5]
    fvmax = prm[..., 8]
    L, V, F = _muscle_LV(length, vel, lengthrange, acc0, prm)
    FL = _bump(L, lmin, torch.ones_like(L), lmax)
    y = fvmax - 1.0
    FV = torch.where(
        V <= -1.0, 0.0,
        torch.where(V <= 0.0, (V + 1.0) * (V + 1.0),
                    torch.where(V <= y, fvmax - (y - V) * (y - V)
                                / torch.clamp(y, min=_MINVAL), fvmax)))
    return -F * FL * FV


def muscle_bias(length, lengthrange, acc0, prm):
    """Passive force-length curve (negative)."""
    lmax = prm[..., 5]
    fpmax = prm[..., 7]
    L, _, F = _muscle_LV(length, torch.zeros_like(length), lengthrange,
                         acc0, prm)
    b = 0.5 * (lmax + 1.0)
    x_mid = (L - 1.0) / torch.clamp(b - 1.0, min=_MINVAL)
    x_hi = (L - b) / torch.clamp(b - 1.0, min=_MINVAL)
    FP = torch.where(L <= 1.0, 0.0,
                     torch.where(L <= b, 0.5 * x_mid * x_mid, 0.5 + x_hi))
    return -F * fpmax * FP


def muscle_dynamics(ctrl, act, prm):
    """Activation rate d(act)/dt with smooth or hard switching between the
    activation and deactivation time constants."""
    ctrlclamp = torch.clamp(ctrl, 0.0, 1.0)
    actclamp = torch.clamp(act, 0.0, 1.0)
    tau_act = prm[..., 0] * (0.5 + 1.5 * actclamp)
    tau_deact = prm[..., 1] / (0.5 + 1.5 * actclamp)
    tausmooth = prm[..., 2]
    dctrl = ctrlclamp - act
    tau_hard = torch.where(dctrl > 0, tau_act, tau_deact)
    x = dctrl / torch.clamp(tausmooth, min=_MINVAL) + 0.5
    xs = torch.clamp(x, 0.0, 1.0)
    sig = xs * xs * xs * (3.0 * xs * (2.0 * xs - 5.0) + 10.0)
    tau_smooth = tau_deact + (tau_act - tau_deact) * sig
    tau = torch.where(tausmooth > 0, tau_smooth, tau_hard)
    return dctrl / torch.clamp(tau, min=_MINVAL)


class ActuationTables:
    """Device copies of the tables ``actuator_forces`` reads. ``tendon_Cd``
    (T, D) or (n, T, D), the row's fixed tendons as a dense coefficient
    map, is needed when an actuator drives a fixed tendon;
    ``au.tendon``/``au.sten`` then index the row's fixed and spatial
    tendons. Maps of shape (n, A) (``per_row``) give each of the n envs
    its own transmissions."""

    def __init__(self, au: MJCActuation, device, n_dof: int,
                 tendon_Cd=None, n_sten: int = 0, dtype=torch.float32):
        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        def b(a):
            return torch.as_tensor(np.asarray(a, dtype=bool), device=device)

        def i(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.long,
                                   device=device)

        dof, tendon, sten = (np.asarray(au.dof), np.asarray(au.tendon),
                             np.asarray(au.sten))
        if ((dof < 0) & (tendon < 0) & (sten < 0)).any():
            raise ValueError("an actuator without a transmission")
        self.n = au.n
        coord = np.asarray(au.coord)
        # per-row maps: some map is (n, A), or the tendon map driven is
        # (n, T, D)
        rows = [x.shape[0] for x in (dof, tendon, sten) if x.ndim == 2]
        if tendon_Cd is not None and tendon_Cd.dim() == 3 and \
                (tendon >= 0).any():
            rows.append(tendon_Cd.shape[0])
        self.per_row = bool(rows)
        if self.per_row:
            dof, tendon, sten, coord = (np.broadcast_to(x, (max(rows), au.n))
                                        for x in (dof, tendon, sten, coord))
        self.is_joint = b(dof >= 0)
        self.dof = i(np.maximum(dof, 0))
        self.coord = i(np.maximum(coord, 0))
        # the joint transmissions' torques into the n_dof dofs in a fixed
        # order (two actuators may share a dof; tendon ones are dropped)
        if self.per_row:
            self.dof_map = f(_one_hot(dof, n_dof))
        else:
            self.dof_sum = FixedOrderSum(dof, n_dof, device)
        self.gear = f(au.gear)
        self.has_tendon = bool((tendon >= 0).any())
        self.has_sten = bool((sten >= 0).any())
        if self.has_tendon:
            if tendon_Cd is None:
                raise ValueError("fixed-tendon transmissions need the "
                                 "row's tendon map")
            self.is_ten = b(tendon >= 0)
            self.tendon = i(np.maximum(tendon, 0))
            # (A, D) or (n, A, D): an actuator's row of the tendon map
            # (zero for others)
            if self.per_row:
                Cd = tendon_Cd.expand(self.tendon.shape[0],
                                      *tendon_Cd.shape[-2:])
                self.ten_map = (self.take(Cd, self.tendon)
                                * self.is_ten[..., None].to(dtype))
            else:
                self.ten_map = tendon_Cd[self.tendon] * \
                    self.is_ten[:, None].to(dtype)
        if self.has_sten:
            self.is_st = b(sten >= 0)
            self.sten = i(np.maximum(sten, 0))
            # per-actuator terms into the row's n_sten spatial tendons
            if self.per_row:
                self.sten_map = f(_one_hot(sten, n_sten))
            else:
                self.sten_sum = FixedOrderSum(sten, n_sten, device)
        cr, fr, ar = (np.asarray(au.ctrlrange), np.asarray(au.forcerange),
                      np.asarray(au.actrange))
        self.ctrl_lo, self.ctrl_hi = f(cr[..., 0]), f(cr[..., 1])
        self.ctrllimited = b(au.ctrllimited)
        self.force_lo, self.force_hi = f(fr[..., 0]), f(fr[..., 1])
        self.forcelimited = b(au.forcelimited)
        self.act_lo, self.act_hi = f(ar[..., 0]), f(ar[..., 1])
        self.actlimited = b(au.actlimited)
        gp, bp = np.asarray(au.gainprm), np.asarray(au.biasprm)
        self.gp9, self.bp9 = f(gp), f(bp)
        self.gp = [f(gp[..., k]) for k in range(3)]
        self.bp = [f(bp[..., k]) for k in range(3)]
        self.gaintype = i(au.gaintype)
        self.biastype = i(au.biastype)
        self.dyntype = i(au.dyntype)
        self.dynprm = f(au.dynprm)
        self.lengthrange = f(au.lengthrange)
        self.acc0 = f(au.acc0)
        self.has_act = bool(au.has_act)
        self.has_muscle = bool(au.has_muscle)

    @staticmethod
    def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``x`` (W, k, ...) at the actuators' indices ``idx``, (A,) or
        each env's own (W, A): (W, A, ...)."""
        if idx.dim() == 1:
            return x[:, idx]
        return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]

    def to_dofs(self, v: torch.Tensor) -> torch.Tensor:
        """Per-actuator terms (W, A) of the joint transmissions summed into
        their dofs (W, D)."""
        if self.per_row:
            return (v[:, None, :] @ self.dof_map)[:, 0]
        return self.dof_sum(v, dim=1)

    def to_stens(self, v: torch.Tensor) -> torch.Tensor:
        """Per-actuator terms (W, A) summed into their spatial tendons."""
        if self.per_row:
            return (v[:, None, :] @ self.sten_map)[:, 0]
        return self.sten_sum(v, dim=1)


def _one_hot(idx: np.ndarray, n: int) -> np.ndarray:
    """(rows, A) indices (-1: none) as one-hot maps (rows, A, n)."""
    out = np.zeros(idx.shape + (n,), np.float32)
    r, a = np.nonzero(idx >= 0)
    out[r, a, idx[r, a]] = 1.0
    return out


def actuator_forces(tab: ActuationTables, q: torch.Tensor, qd: torch.Tensor,
                    ctrl: torch.Tensor, act=None, dt: float = 0.0,
                    sten=None, tendon=None):
    """Generalized actuator torques, env-major: q (W, nq), qd (W, D),
    ctrl (W, A), act (W, A) or None; ``tendon`` the row's fixed-tendon
    (length, velocity) (W, T) and ``sten`` its spatial tendons' (L, V, J)
    ((W, Ts), (W, Ts), (W, Ts, D)) where actuators drive them. Returns
    (tau (W, D), act_new (W, A) or None, force (W, A), dfdv (W, A): the
    force's velocity derivative that the implicit integrators read)."""
    gear, take = tab.gear, tab.take
    length = gear * take(q, tab.coord)
    velocity = gear * take(qd, tab.dof)
    if tab.has_tendon:
        t_len, t_vel = tendon
        length = torch.where(tab.is_ten, take(t_len, tab.tendon), length)
        velocity = torch.where(tab.is_ten, take(t_vel, tab.tendon),
                               velocity)
    if tab.has_sten:
        L_st, V_st, _ = sten
        length = torch.where(tab.is_st, gear * take(L_st, tab.sten), length)
        velocity = torch.where(tab.is_st, gear * take(V_st, tab.sten),
                               velocity)
    ctrl_c = torch.where(tab.ctrllimited,
                         torch.clamp(ctrl, tab.ctrl_lo, tab.ctrl_hi), ctrl)
    has_act = tab.has_act and act is not None
    inp = torch.where(tab.dyntype != DYN_NONE, act, ctrl_c) if has_act \
        else ctrl_c
    gp, bp = tab.gp, tab.bp
    gain = torch.where(tab.gaintype == GAIN_AFFINE,
                       gp[0] + gp[1] * length + gp[2] * velocity,
                       gp[0].expand_as(length))
    bias = torch.where(tab.biastype == BIAS_AFFINE,
                       bp[0] + bp[1] * length + bp[2] * velocity,
                       torch.zeros_like(length))
    if tab.has_muscle:
        lr = tab.lengthrange.expand(*length.shape, 2)
        acc0 = tab.acc0.expand_as(length)
        gain = torch.where(tab.gaintype == GAIN_MUSCLE,
                           muscle_gain(length, velocity, lr, acc0,
                                       tab.gp9.expand(*length.shape, 9)),
                           gain)
        bias = torch.where(tab.biastype == BIAS_MUSCLE,
                           muscle_bias(length, lr, acc0,
                                       tab.bp9.expand(*length.shape, 9)),
                           bias)
    force = gain * inp + bias
    force = torch.where(tab.forcelimited,
                        torch.clamp(force, tab.force_lo, tab.force_hi), force)
    # d force / d velocity (MuJoCo's implicitfast: the affine gain and bias
    # velocity coefficients; the muscle and clamp derivatives are left out)
    dfdv = torch.where(tab.gaintype == GAIN_AFFINE, gp[2] * inp,
                       torch.zeros_like(length))
    dfdv = dfdv + torch.where(tab.biastype == BIAS_AFFINE,
                              bp[2].expand_as(length),
                              torch.zeros_like(length))
    f = gear * force
    tau = tab.to_dofs(torch.where(tab.is_joint, f, 0.0))
    if tab.has_tendon:
        tau = tau + ((f[:, None, :] @ tab.ten_map)[:, 0] if tab.per_row
                     else f @ tab.ten_map)
    if tab.has_sten:
        J_a = take(sten[2], tab.sten)                        # (W, A, D)
        tau = tau + (J_a * torch.where(tab.is_st, f, 0.0)[..., None]).sum(1)
    act_new = None
    if has_act:
        dp = tab.dynprm
        tau_f = torch.clamp(dp[..., 0], min=_MINVAL)
        rate = torch.zeros_like(act)
        rate = torch.where(tab.dyntype == DYN_INTEGRATOR, ctrl_c, rate)
        rate = torch.where(tab.dyntype == DYN_FILTER, (ctrl_c - act) / tau_f,
                           rate)
        if tab.has_muscle:
            rate = torch.where(tab.dyntype == DYN_MUSCLE,
                               muscle_dynamics(ctrl_c, act,
                                               dp.expand(*act.shape, 3)),
                               rate)
        act_new = act + dt * rate
        # the exact filter integrates in closed form
        act_new = torch.where(
            tab.dyntype == DYN_FILTEREXACT,
            act + (ctrl_c - act) * (1.0 - torch.exp(-dt / tau_f)), act_new)
        act_new = torch.where(tab.actlimited,
                              torch.clamp(act_new, tab.act_lo, tab.act_hi),
                              act_new)
        act_new = torch.where(tab.dyntype == DYN_NONE, act, act_new)
    return tau, act_new, force, dfdv
