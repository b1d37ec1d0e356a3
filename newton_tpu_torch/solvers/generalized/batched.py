"""The generalized substep, env-major, and its two entries (ports of
``step_batched`` in ``newton_tpu/solvers/generalized/batched.py`` and of
``SolverMuJoCo.step`` in ``solver.py``).

The JAX package restates the per-env step in a lanes-minor transposed
layout for the TPU; the port keeps the env axis leading, ``(W, ...)``,
with vectors as trailing ``3``/``4``/``7`` axes. One env is one row of the
model's articulation group (see solver.py): ``step_batched`` runs W envs
of a one-world model, ``step`` runs the N rows of a flat multi-world
state, gathered into ``(N, ...)`` through the row tables and scattered
back. Both run the same ``_substep``, so B1 and B2 take all envs of a
substep in one launch each (B1 once per RK4 stage). The stages run in
the reference's order: dof subspace, spatial inertia, RNEA bias, applied
(PD, fixed tendons) and external forces, MJCF actuation, CRBA, the
Cholesky kernel (Euler: one solve of ``M + dt Kd``; RK4: four stages of
``M a = tau``, each after FK at its coordinates), the contact rows (top-K
compacted) and the PGS kernel (or the limits-only solve without
contacts), the velocity clips, coordinate integration and FK.
Every index comes from the solver's device tables (``solver.tables``), in
the row's local indices.
"""

from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace
from typing import Optional

import torch

from ...math import (
    cross,
    orthonormal_basis,
    quat_integrate,
    quat_rotate,
    quat_to_matrix,
    spatial_cross,
    spatial_cross_dual,
    transform_multiply,
    velocity_at_point,
)
from ...sim.articulation import angular_axes, fk_bodies
from ...sim.control import Control
from ...sim.state import State
from .actuation import actuator_forces
from .linalg import chol_inv_solve, chol_inv_solve_plain
from .pgs import pgs_solve_fused, pgs_solve_fused_plain

__all__ = ["step", "step_batched", "compaction_indices"]


def _dot(a, b):
    return (a * b).sum(-1)


def _dof_subspace(t, body_q, q):
    """World-frame motion subspace of every dof at the origin: (v_o, w),
    each (W, D, 3). Angular dofs of multi-axis joints use their axes
    transported by the coordinates before them, and those of a D6 joint
    with linear axes rotate about its anchor translated by the linear
    coordinates: the points and axes FK rotates about."""
    X_wp = torch.where(t.dof_hasp, body_q[:, t.dof_parent], t.identity)
    X_pj = transform_multiply(X_wp, t.dof_X_p)
    axis = t.model_axis
    if t.ang_kin is not None:
        axes, _ = angular_axes(t.ang_kin, q)
        tr = torch.stack(axes, dim=-2)[:, t.dof_joint, t.dof_ang_slot]
        axis = torch.where(t.dof_is_ang, tr, axis)
    axis_w = quat_rotate(X_pj[..., 3:7], axis)
    cb = body_q[:, t.dof_body]
    com_w = cb[..., 0:3] + quat_rotate(cb[..., 3:7], t.dof_com)
    pivot = X_pj[..., 0:3]
    if t.slide_pivot is not None:
        k = t.slide_pivot
        shift = ((q[:, k.lin_q_idx] * k.lin_mask)[..., None]
                 * k.A_lin).sum(-2)[:, k.dof_joint]           # (W, D, 3)
        pivot = torch.where(k.dof_shift,
                            pivot + quat_rotate(X_pj[..., 3:7], shift),
                            pivot)
    anchor = torch.where(t.dof_is_com, com_w, pivot)
    w = torch.where(t.dof_is_lin, 0.0, axis_w)
    v = torch.where(t.dof_is_lin, axis_w, cross(anchor, axis_w))
    return v, w


def _spatial_inertia(model, body_q):
    """World COM positions (W, B, 3) and world inertia tensors (W, B, 3, 3)."""
    q = body_q[..., 3:7]
    x_b = body_q[..., 0:3] + quat_rotate(q, model.body_com)
    R = quat_to_matrix(q)
    Iw = R @ model.body_inertia @ R.transpose(-1, -2)
    return x_b, Iw


def _accumulate(t, F):
    """Add every body's wrench into its parent, deepest level first."""
    F = F.clone()
    for src, dst in t.rounds:
        F[:, dst] = F[:, dst] + F[:, src]
    return F


def _bias_forces(t, model, body_qd, v_o, w_o, x_b, Iw):
    """RNEA bias torques (W, D) with spatial vectors [v, w] at the origin:
    gravity enters as the base acceleration, qdd = 0."""
    bw = body_qd[..., 3:6]
    V = torch.cat([body_qd[..., 0:3] - cross(bw, x_b), bw], -1)  # (W, B, 6)
    W = body_qd.shape[0]
    A = t.base_acc.expand(W, -1, -1).clone()
    for pbc, cb, hasp in t.levels:
        Vc = V[:, cb]
        dV = Vc - torch.where(hasp, V[:, pbc], 0.0)
        A_p = torch.where(hasp, A[:, pbc], t.base_acc[:, cb])
        A[:, cb] = A_p + spatial_cross(Vc, dV)
    m = model.body_mass[:, None]

    def apply_I(a):
        f = (a[..., 0:3] + cross(a[..., 3:6], x_b)) * m
        tau = (Iw @ a[..., 3:6, None])[..., 0] + cross(x_b, f)
        return torch.cat([f, tau], -1)

    F = apply_I(A) + spatial_cross_dual(V, apply_I(V))
    F = _accumulate(t, F)[:, t.dof_body]
    return _dot(v_o, F[..., 0:3]) + _dot(w_o, F[..., 3:6])


def _external_tau(t, body_f, x_b, v_o, w_o):
    """Generalized forces of world-frame body wrenches at the COM."""
    Ff = body_f[..., 0:3]
    Ft = body_f[..., 3:6] + cross(x_b, Ff)
    F = _accumulate(t, torch.cat([Ff, Ft], -1))[:, t.dof_body]
    return _dot(v_o, F[..., 0:3]) + _dot(w_o, F[..., 3:6])


def _applied_tau(t, q, qd, control, explicit=False):
    """Joint forces, PD drives and fixed-tendon forces. Under Euler the PD
    damping gains go implicit into M + dt*Kd, so the rhs carries only
    kd * target_qd (MuJoCo Euler); with ``explicit`` (the RK4 stages) the
    rhs carries kd * (target_qd - qd) and Kd stays zero. Tendon damping is
    explicit in both, as in the JAX batched step."""
    tau = torch.zeros_like(qd)
    kd_implicit = torch.zeros_like(qd)
    if control is None:
        return tau, kd_implicit
    tau = tau + control.joint_f
    if len(t.lin_idx):
        err = control.joint_target_q[:, t.lin_idx] - q[:, t.lin_idx]
        vel = control.joint_target_qd[:, t.lin_dof]
        if explicit:
            vel = vel - qd[:, t.lin_dof]
        pd = t.pd_ke * err + t.pd_kd * vel
        tau[:, t.lin_dof] = tau[:, t.lin_dof] + pd
        if not explicit:
            kd_implicit[:, t.lin_dof] = kd_implicit[:, t.lin_dof] + t.pd_kd
    if t.tendons:
        L = q @ t.tendon_Cq.T                                # (W, T)
        Ld = qd @ t.tendon_Cd.T
        f = -t.tendon_ke * (L - t.tendon_L0) - t.tendon_kd * Ld
        if control.tendon_f is not None:
            f = f + control.tendon_f
        tau = tau + f @ t.tendon_Cd
    return tau, kd_implicit


def _crba(t, v_o, w_o, x_b, Iw, mass):
    """Joint-space mass matrix (W, d, d) of the group row."""
    vg, wg = v_o[:, t.di], w_o[:, t.di]                      # (W, d, 3)
    xg = x_b[:, t.bi]                                        # (W, b, 3)
    anc = t.anc[None, :, :, None]                            # (1, b, d, 1)
    V = (vg[:, None] + cross(wg[:, None], xg[:, :, None])) * anc
    Wm = wg[:, None].expand_as(V) * anc                      # (W, b, d, 3)
    M = torch.einsum("wbdc,wbec->wde", V * mass[t.bi][None, :, None, None],
                     V)
    H = Wm @ Iw[:, t.bi]                                     # (W, b, d, 3)
    M = M + torch.einsum("wbdk,wbek->wde", H, Wm)
    return M + torch.diag_embed(t.armature)


def compaction_indices(score, K):
    """Slots of the K highest scores per env (W, K), highest first, ties
    to the lower slot index: a stable descending sort, the order
    ``jax.lax.top_k`` gives (``torch.topk`` promises no tie order)."""
    return torch.sort(score, dim=1, descending=True, stable=True)[1][:, :K]


def _contact_system(solver, t, Minv, qd_g, v_o, w_o, body_qd, x_b, q,
                    contacts, dt):
    """Contact and limit rows of the PGS system: J (W, 3c, d), b and act
    (W, r), mu (W, c) in BLOCK row order [n | t1 | t2 | lim-lo | lim-hi],
    from the row's c contact slots of each env (``contacts``, (W, c)).
    With a cap K below the slot count, each env keeps its K slots of
    highest score active * max(1 + depth, 0.5) (batched.py:684-736 of the
    JAX package), after the restitution pre-velocity of every slot."""
    nrm = contacts.rigid_contact_normal                      # (W, c, 3)
    pos = contacts.rigid_contact_position
    depth = contacts.rigid_contact_depth
    active = contacts.rigid_contact_mask
    W, c = active.shape

    def vel_of(gb, on):
        return torch.where(on, velocity_at_point(body_qd[:, gb],
                                                 pos - x_b[:, gb]), 0.0)

    vn_pre = _dot(nrm, vel_of(t.gb1, t.on1) - vel_of(t.gb0, t.on0))
    sign, mu, e_rest = t.sign, t.mu.expand(W, c), t.e_rest
    if t.cap < c:
        score = active.to(depth.dtype) * torch.clamp(1.0 + depth, min=0.5)
        idx = compaction_indices(score, t.cap)               # (W, K)
        i3 = idx[..., None].expand(-1, -1, 3)
        nrm, pos = nrm.gather(1, i3), pos.gather(1, i3)
        depth, active, vn_pre = (x.gather(1, idx)
                                 for x in (depth, active, vn_pre))
        sign, mu, e_rest = t.sign[idx], t.mu[idx], t.e_rest[idx]
        c = t.cap

    t1, t2 = orthonormal_basis(nrm)
    vg, wg = v_o[:, t.di], w_o[:, t.di]                      # (W, d, 3)
    Vp = vg[:, None] + cross(wg[:, None], pos[:, :, None])   # (W, c, d, 3)
    J = torch.cat([_dot(dirs[:, :, None], Vp) * sign
                   for dirs in (nrm, t1, t2)], dim=1)        # (W, 3c, d)

    diag_scale = 1.0 + (1.0 - solver.impratio) / solver.impratio
    rest = torch.where(vn_pre < -2.0 * 9.81 * dt, -e_rest * vn_pre, 0.0)
    pen = torch.clamp(solver.baumgarte / dt
                      * torch.clamp(depth - solver.contact_slop, min=0.0),
                      max=solver.depenetration_velocity)
    gap_allow = torch.clamp(depth, max=0.0) / dt
    b_n = torch.where(depth > 0, rest + pen,
                      torch.where(rest > 0, rest, gap_allow))
    actf = active.to(J.dtype)
    b_parts = [torch.where(active, b_n, 0.0),
               torch.zeros((W, 2 * c), dtype=J.dtype, device=J.device)]
    act_parts = [actf, actf, actf]
    if t.nl:
        qv = q[:, t.lim_coord]                               # (W, nl)
        k = solver.baumgarte / dt
        b_parts += [k * torch.clamp(t.lim_lo - qv, min=0.0),
                    k * torch.clamp(qv - t.lim_hi, min=0.0)]
        act_parts += [(qv <= t.lim_lo + 1e-4).to(J.dtype),
                      (qv >= t.lim_hi - 1e-4).to(J.dtype)]
    b_rows = torch.cat(b_parts, dim=1)
    act3 = torch.cat(act_parts, dim=1)
    lam0 = torch.zeros_like(b_rows)
    mu = mu.contiguous()
    kw = dict(c=c, ld=t.ld_i32, iters=solver.contact_iterations,
              omega=solver.contact_relaxation,
              use_cone=solver.friction_cone == "cone",
              diag_scale=diag_scale, reg=solver.contact_reg)
    return (J, Minv, qd_g, b_rows, act3, mu, lam0), kw


def _solve_limits(solver, t, Minv, qd_g, q, dt):
    """Limits-only unilateral solve for steps without a contact system;
    a dof's lower and upper rows merge into one signed row."""
    qv = q[:, t.lim_coord]
    lo, hi = t.lim_lo, t.lim_hi
    act_lo = qv <= lo + 1e-4
    active = act_lo | (qv >= hi - 1e-4)
    s = torch.where(act_lo, 1.0, -1.0)
    b = solver.baumgarte / dt * torch.where(
        act_lo, torch.clamp(lo - qv, min=0.0), torch.clamp(qv - hi, min=0.0))
    Msub = Minv[:, t.ld][:, :, t.ld]                         # (W, nl, nl)
    A = s[:, :, None] * Msub * s[:, None, :]
    diag = torch.diagonal(A, dim1=1, dim2=2) + solver.contact_reg
    v_free = s * qd_g[:, t.ld]
    lam = torch.zeros_like(v_free)
    omega = solver.contact_relaxation
    for _ in range(solver.contact_iterations):
        r = (A @ lam[..., None])[..., 0] + v_free - b
        lam = torch.clamp(lam - omega * r / diag, min=0.0)
        lam = torch.where(active, lam, 0.0)
    return qd_g + (Minv[:, :, t.ld] @ (s * lam)[..., None])[..., 0]


def _integrate_coords(t, q, qd, dt):
    """Semi-implicit Euler on the coordinates; free joints advance their
    COM and integrate the world-frame angular velocity."""
    q = q.clone()
    if len(t.lin_idx):
        q[:, t.lin_idx] = q[:, t.lin_idx] + dt * qd[:, t.lin_dof]
    if t.free_p.shape[0]:
        quat = q[:, t.free_q]                                # (W, F, 4)
        new_quat = quat_integrate(quat, qd[:, t.free_w], dt)
        p_com = (q[:, t.free_p] + quat_rotate(quat, t.free_com)) \
            + qd[:, t.free_v] * dt
        q[:, t.free_p] = p_com - quat_rotate(new_quat, t.free_com)
        q[:, t.free_q] = new_quat
    return q


def _smooth(solver, t, q, qd, body_q, body_qd, body_f, control_b,
            explicit):
    """The smooth dynamics at one configuration: the dof subspace (v_o,
    w_o), world COMs x_b, the mass matrix M (W, d, d) of the group row,
    the net generalized force tau_net = applied + external + actuator -
    bias, and the implicit damping gains (zero with ``explicit``)."""
    model = solver.row_model
    v_o, w_o = _dof_subspace(t, body_q, q)
    x_b, Iw = _spatial_inertia(model, body_q)
    tau_bias = _bias_forces(t, model, body_qd, v_o, w_o, x_b, Iw)
    tau, kd_implicit = _applied_tau(t, q, qd, control_b, explicit)
    tau = tau + _external_tau(t, body_f, x_b, v_o, w_o)
    if (solver.actuation is not None and control_b is not None
            and "mjc:ctrl" in control_b.custom):
        tau = tau + actuator_forces(solver.actuation, q, qd,
                                    control_b.custom["mjc:ctrl"])
    M = _crba(t, v_o, w_o, x_b, Iw, model.body_mass)
    return v_o, w_o, x_b, M, tau - tau_bias, kd_implicit


def _rk4(solver, t, state_b, control_b, dt, chol, record):
    """Classic RK4 on the smooth dynamics (MuJoCo's mj_RungeKutta tableau,
    the JAX package's ``_rk4_update``): four evaluations of ``M a =
    tau_net`` with explicit joint damping, one B1 call each; stages 2-4
    at coordinates integrated from the substep's start (FK at each).
    Returns stage 1's subspace, COMs and ``M^-1`` (for the contact and
    limit solve), the RK4 velocity and the tableau-weighted stage
    velocity that advances the coordinates."""
    q, qd = state_b.joint_q, state_b.joint_qd

    def accel(q_s, qd_s, stage):
        body_q, body_qd = state_b.body_q, state_b.body_qd
        if stage > 1:
            body_q, body_qd = fk_bodies(solver.row_model, q_s, qd_s, body_q,
                                        body_qd)
        v_o, w_o, x_b, M, tau_net, _ = _smooth(
            solver, t, q_s, qd_s, body_q, body_qd, state_b.body_f,
            control_b, explicit=True)
        rhs = tau_net[:, t.di]
        if record is not None and stage == 1:
            record["chol"] = (M, rhs)
        Minv, a_g = chol(M, rhs)
        a = torch.zeros_like(qd)
        a[:, t.di] = a_g
        return a, (v_o, w_o, x_b, Minv)

    a1, first = accel(q, qd, 1)
    v2 = qd + 0.5 * dt * a1
    a2, _ = accel(_integrate_coords(t, q, qd, 0.5 * dt), v2, 2)
    v3 = qd + 0.5 * dt * a2
    a3, _ = accel(_integrate_coords(t, q, v2, 0.5 * dt), v3, 3)
    v4 = qd + dt * a3
    a4, _ = accel(_integrate_coords(t, q, v3, dt), v4, 4)
    v_avg = (qd + 2.0 * v2 + 2.0 * v3 + v4) / 6.0
    qd_rk4 = qd + (dt / 6.0) * (a1 + 2.0 * a2 + 2.0 * a3 + a4)
    return first, qd_rk4, v_avg


def _substep(solver, state_b: State, control_b, contacts_b, dt: float,
             kernels: bool, record: Optional[dict]) -> State:
    """One substep of W envs of the row layout (leading axis of every
    tensor; ``contacts_b`` holds the row's c slots, (W, c), or None)."""
    model = solver.row_model
    t = solver.tables
    q, qd = state_b.joint_q, state_b.joint_qd
    body_q, body_qd = state_b.body_q, state_b.body_qd
    chol = chol_inv_solve if kernels else chol_inv_solve_plain

    if solver.integrator == "rk4":
        (v_o, w_o, x_b, Minv), qd_smooth, v_avg = _rk4(
            solver, t, state_b, control_b, dt, chol, record)
        qd_g = qd_smooth[:, t.di]
    else:
        # group row: factor / solve / invert M + dt*Kd
        v_o, w_o, x_b, M, tau_net, kd_implicit = _smooth(
            solver, t, q, qd, body_q, body_qd, state_b.body_f, control_b,
            explicit=False)
        Mi = M + dt * torch.diag_embed(kd_implicit[:, t.di])
        rhs = (M @ qd[:, t.di, None])[..., 0] + dt * tau_net[:, t.di]
        if record is not None:
            record["chol"] = (Mi, rhs)
        Minv, qd_g = chol(Mi, rhs)
    # the impulse solve on M^-1 (stage 1's under RK4)
    if contacts_b is not None:
        args, kw = _contact_system(solver, t, Minv, qd_g, v_o, w_o, body_qd,
                                   x_b, q, contacts_b, dt)
        if record is not None:
            record["pgs"] = (args, kw)
        pgs = pgs_solve_fused if kernels else pgs_solve_fused_plain
        lam, dqd = pgs(*args, **kw)
        if record is not None:
            record["lam"] = lam
        qd_g = qd_g + dqd
    elif t.nl:
        if record is not None:
            record["limits"] = (Minv, qd_g)
        qd_g = _solve_limits(solver, t, Minv, qd_g, q, dt)
    qd_new = qd.clone()
    qd_new[:, t.di] = qd_g

    vlim = t.vel_limit
    qd_new = torch.clamp(qd_new, -vlim, vlim)
    qd_new = torch.clamp(qd_new, -solver.max_velocity, solver.max_velocity)
    qd_new = torch.where(torch.isfinite(qd_new), qd_new, 0.0)

    v_int = qd_new
    if solver.integrator == "rk4":
        # positions advance with the stage velocities; the impulses and
        # clips ride on top as a delta, under the same ceiling and guard
        v_int = v_avg + (qd_new - qd_smooth)
        v_int = torch.clamp(v_int, -solver.max_velocity, solver.max_velocity)
        v_int = torch.where(torch.isfinite(v_int), v_int, 0.0)
    q_new = _integrate_coords(t, q, v_int, dt)
    body_q2, body_qd2 = fk_bodies(model, q_new, qd_new, body_q, body_qd)
    return replace(state_b, body_q=body_q2, body_qd=body_qd2, joint_q=q_new,
                   joint_qd=qd_new)


_CONTACT_ROWS = ("rigid_contact_normal", "rigid_contact_position",
                 "rigid_contact_depth", "rigid_contact_mask")


def _has_contacts(solver, contacts) -> bool:
    """Whether this substep has a contact system: contacts with slots and
    a contact plan."""
    return (contacts is not None and contacts.rigid_contact_max > 0
            and solver.contact_plans[0] is not None)


def _contact_rows(solver, contacts, take):
    """The row's slots of each env, or None without a contact system."""
    if not _has_contacts(solver, contacts):
        return None
    return SimpleNamespace(**{n: take(getattr(contacts, n))
                              for n in _CONTACT_ROWS})


def step_batched(solver, state_b: State, control_b=None, contacts_b=None,
                 dt: float = 1e-3, kernels: bool = True,
                 record: Optional[dict] = None) -> State:
    """One substep of W independent envs of a one-world model (leading
    axis of every tensor; ``contacts_b`` from ``collide`` on the batched
    state).

    ``kernels=False`` runs the plain PyTorch versions of the two kernels
    instead, whatever the device: the reference path that a run on the card
    compares the kernel path with. ``record``, when a dict, receives the
    operands of the two kernel calls (``"chol"``: stage 1's under RK4;
    ``"pgs"``) and the contact impulses (``"lam"``), or the operands of the
    limits-only solve (``"limits"``) in a substep without contacts."""
    t = solver.tables
    if not solver._model_is_row:
        raise NotImplementedError(
            "step_batched takes a one-world model whose bodies and joints "
            "all belong to its articulation; step() steps every world of "
            "a replicated model")
    rows = _contact_rows(solver, contacts_b, lambda x: x if
                         t.slots_are_all else x[:, t.row_slots[0]])
    return _substep(solver, state_b, control_b, rows, dt, kernels, record)


def step(solver, state: State, control: Optional[Control] = None,
         contacts=None, dt: float = 1e-3, kernels: bool = True,
         record: Optional[dict] = None) -> State:
    """One substep of a flat State (every world of the model: ``joint_q
    (N nq,)``, ``body_q (N b, 7)``, ``mjc:ctrl (N A,)``, Contacts ``(C,)``),
    the JAX package's ``SolverMuJoCo.step``. The N rows are gathered into
    ``(N, ...)``, stepped as N envs, and scattered back; the result is a
    new State. With ``contact:overflow:0`` in ``state.custom``
    (``init_state``) the output carries each row's count of active
    contacts that compaction dropped."""
    t = solver.tables
    # gather: each world's row, (N, k, ...) through the (N, k) row tables
    rows = replace(
        state, body_q=state.body_q[t.row_body],
        body_qd=state.body_qd[t.row_body], body_f=state.body_f[t.row_body],
        joint_q=state.joint_q[t.row_coord],
        joint_qd=state.joint_qd[t.row_dof], custom={})
    ctl = None
    if control is not None:
        custom = {}
        if "mjc:ctrl" in control.custom:
            custom["mjc:ctrl"] = control.custom["mjc:ctrl"][t.row_act]
        ctl = Control(
            joint_target_q=control.joint_target_q[t.row_coord],
            joint_target_qd=control.joint_target_qd[t.row_dof],
            joint_f=control.joint_f[t.row_dof],
            tendon_f=(None if control.tendon_f is None
                      else control.tendon_f[t.row_tendon]),
            custom=custom)
    out = _substep(solver, rows, ctl,
                   _contact_rows(solver, contacts, lambda x: x[t.row_slots]),
                   dt, kernels, record)

    def put(x, idx, v):
        x = x.clone()
        x[idx] = v
        return x
    custom = dict(state.custom)
    if "contact:overflow:0" in custom:
        over = torch.zeros_like(custom["contact:overflow:0"])
        if _has_contacts(solver, contacts):
            n_act = contacts.rigid_contact_mask[t.row_slots].sum(1)
            over = torch.clamp(n_act - t.cap, min=0).to(over.dtype)
        custom["contact:overflow:0"] = over
    return replace(
        state, body_q=put(state.body_q, t.row_body, out.body_q),
        body_qd=put(state.body_qd, t.row_body, out.body_qd),
        joint_q=put(state.joint_q, t.row_coord, out.joint_q),
        joint_qd=put(state.joint_qd, t.row_dof, out.joint_qd), custom=custom)
