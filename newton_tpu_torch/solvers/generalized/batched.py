"""The generalized substep, env-major, and its two entries (ports of
``step_batched`` in ``newton_tpu/solvers/generalized/batched.py`` and of
``SolverMuJoCo.step`` in ``solver.py``).

The JAX package restates the per-env step in a lanes-minor transposed
layout for the TPU; the port keeps the env axis leading, ``(W, ...)``,
with vectors as trailing ``3``/``4``/``7`` axes. One env is one row of an
articulation group (see solver.py): ``step_batched`` runs W envs of a
one-world model, ``step`` runs the N rows of each group of a flat
multi-world state, gathered into ``(N, ...)`` through the group's row
tables and scattered back. Both run the same ``_substep``, so B1 and B2
take all rows of a group in one launch each per substep (B1 once per RK4
stage); a group of several per-row constants broadcasts its ``(n, ...)``
tables against the ``(N, ...)`` rows. The stages run in
the reference's order: dof subspace, spatial inertia, RNEA bias, applied
(PD on linear coordinates and ball quaternions, fixed tendons, penalty
limits) and external forces, spatial tendons, MJCF actuation (and the
activations' step), CRBA, the
Cholesky kernel (Euler: one solve of ``M + dt Kd``; implicitfast: of ``M
+ dt (Kd + D)``; RK4: four stages of ``M a = tau``, each after FK at its
coordinates; implicit: an LU of ``M + dt (Kd + D + dbias/dqd)`` instead),
the contact rows (top-K compacted) and the PGS kernel (its non-symmetric
form under implicit; or the Newton QP, or Kamino's PADMM; or the
limits-only solve without contacts; with warm start the solve starts
from the last substep's impulses), the equality rows (their system
through the Cholesky kernel), the velocity clips, coordinate
integration, FK and sleeping.
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
    quat_conjugate,
    quat_integrate,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_axis_angle,
    quat_to_matrix,
    spatial_cross,
    spatial_cross_dual,
    transform_multiply,
    transform_point,
    velocity_at_point,
)
from ...sim.articulation import angular_axes, fk_bodies
from ...sim.control import Control
from ...sim.state import State
from ...sim.tendon import eval_spatial_tendons
from .actuation import actuator_forces
from .linalg import (chol_inv_solve, chol_inv_solve_plain, chol_solve,
                     chol_solve_plain)
from .kamino import solve_contacts_admm
from .newton_qp import solve_contacts_newton
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


def _accelerations(t, body_qd, x_b, mount=None):
    """The RNEA's forward pass, qdd = 0: each body's twist V and
    acceleration A (W, B, 6) at the origin, gravity as the base
    acceleration [-g, 0]; a mounted row's mount bodies take the
    accelerations of the rows carrying them (``mount.acc``)."""
    bw = body_qd[..., 3:6]
    V = torch.cat([body_qd[..., 0:3] - cross(bw, x_b), bw], -1)  # (W, B, 6)
    W = body_qd.shape[0]
    A = t.base_acc.expand(W, -1, -1).clone()
    if mount is not None and mount.acc is not None:
        A[:, t.mount_local] = mount.acc
    for pbc, cb, hasp in t.levels:
        Vc = V[:, cb]
        dV = Vc - torch.where(hasp, V[:, pbc], 0.0)
        A_p = torch.where(hasp, A[:, pbc], t.base_acc[:, cb])
        A[:, cb] = A_p + spatial_cross(Vc, dV)
    return V, A


def _bias_wrenches(t, model, body_qd, x_b, Iw, mount=None):
    """Each body's RNEA wrench I A + V x* I V (W, B, 6) at the origin,
    before the accumulation into the parents."""
    V, A = _accelerations(t, body_qd, x_b, mount)
    m = model.body_mass[..., None]

    def apply_I(a):
        f = (a[..., 0:3] + cross(a[..., 3:6], x_b)) * m
        tau = (Iw @ a[..., 3:6, None])[..., 0] + cross(x_b, f)
        return torch.cat([f, tau], -1)

    return apply_I(A) + spatial_cross_dual(V, apply_I(V))


def _bias_forces(t, model, body_qd, v_o, w_o, x_b, Iw, mount=None):
    """RNEA bias torques (W, D) with spatial vectors [v, w] at the origin:
    gravity enters as the base acceleration, qdd = 0. ``mount.F`` (W, B,
    6) adds the subtree wrenches of the rows mounted on this row's bodies
    (their bias less their external wrench), as the JAX package's RNEA
    accumulates every articulation into the body it hangs from."""
    F = _bias_wrenches(t, model, body_qd, x_b, Iw, mount)
    if mount is not None and mount.F is not None:
        F = F + mount.F
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
    explicit in both, as in the JAX batched step. A ball joint's drive
    acts on its three dofs: ke times the axis-angle vector of
    ``target * current^-1`` (the same for q and -q) plus its damping."""
    tau = torch.zeros_like(qd)
    kd_implicit = torch.zeros_like(qd)
    if t.penalty is not None:
        # one-sided limit springs (limit_mode="penalty"): -ke viol, and -kd
        # qd where the limit is violated
        lo, hi, ke, kd = t.penalty
        ql = q[:, t.lin_idx]
        viol = torch.clamp(ql - lo, max=0.0) + torch.clamp(ql - hi, min=0.0)
        lim = -ke * viol - torch.where(viol != 0.0, kd * qd[:, t.lin_dof],
                                       0.0)
        tau[:, t.lin_dof] = tau[:, t.lin_dof] + lim
    if control is None:
        # fixed tendons pull without a Control too, as in the JAX package
        return _tendon_tau(t, q, qd, None, tau), kd_implicit
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
    if len(t.ball_q):
        cur = quat_normalize(q[:, t.ball_q])                 # (W, nb, 4)
        tar = quat_normalize(control.joint_target_q[:, t.ball_q])
        axis, ang = quat_to_axis_angle(quat_mul(tar, quat_conjugate(cur)))
        vel = control.joint_target_qd[:, t.ball_d]           # (W, nb, 3)
        if explicit:
            vel = vel - qd[:, t.ball_d]
        pd = t.ball_ke * (axis * ang[..., None]) + t.ball_kd * vel
        tau[:, t.ball_d] = tau[:, t.ball_d] + pd
        if not explicit:
            kd_implicit[:, t.ball_d] = kd_implicit[:, t.ball_d] + t.ball_kd
    return _tendon_tau(t, q, qd, control, tau), kd_implicit


def _tendon_tau(t, q, qd, control, tau):
    """``tau`` plus the fixed tendons' spring, damper and ``tendon_f``
    forces through their coefficients."""
    if not t.tendons:
        return tau
    L, Ld = _tendon_state(t, q, qd)                          # (W, T)
    f = -t.tendon_ke * (L - t.tendon_L0) - t.tendon_kd * Ld
    if control is not None and control.tendon_f is not None:
        f = f + control.tendon_f
    Cd = t.tendon_Cd
    return tau + (f @ Cd if Cd.dim() == 2 else (f[:, None, :] @ Cd)[:, 0])


def _crba(t, v_o, w_o, x_b, Iw, mass):
    """Joint-space mass matrix (W, d, d) of the group row."""
    vg, wg = v_o[:, t.di], w_o[:, t.di]                      # (W, d, 3)
    xg = x_b[:, t.bi]                                        # (W, b, 3)
    anc = t.anc[None, :, :, None]                            # (1, b, d, 1)
    V = (vg[:, None] + cross(wg[:, None], xg[:, :, None])) * anc
    Wm = wg[:, None].expand_as(V) * anc                      # (W, b, d, 3)
    M = torch.einsum("wbdc,wbec->wde", V * mass[..., t.bi][..., None, None],
                     V)
    H = Wm @ Iw[:, t.bi]                                     # (W, b, d, 3)
    M = M + torch.einsum("wbdk,wbek->wde", H, Wm)
    return M + torch.diag_embed(t.armature)


def compaction_indices(score, K):
    """Slots of the K highest scores per env (W, K), highest first, ties
    to the lower slot index: a stable descending sort, the order
    ``jax.lax.top_k`` gives (``torch.topk`` promises no tie order)."""
    return torch.sort(score, dim=1, descending=True, stable=True)[1][:, :K]


def _at_bodies(x, gb, row_col):
    """``x`` (W, b, ...) at the local bodies ``gb`` of each contact entry:
    (c,) shared by every row, or (n, c) per row (``row_col`` the (n, 1)
    row numbers of a ragged plan)."""
    return x[:, gb] if row_col is None else x[row_col, gb]


def _take_slots(x, idx):
    """Entries ``idx`` (W, K) along axis 1 of x (W or 1, c, ...)."""
    idx = idx.view(*idx.shape, *([1] * (x.dim() - 2)))
    return x.expand(idx.shape[0], *x.shape[1:]).gather(
        1, idx.expand(-1, -1, *x.shape[2:]))


def _other_side(o, nrm, t1, t2, pos):
    """Two-sided entries: the other body's pre-step point velocity along
    the normal (for restitution), along the three row directions (the
    moving-support rows, which shift b) and its point inverse mass along
    them (w_other), each (W, c) or (W, 3c) in block order; zero where the
    entry has no other body (solver.py:1182-1230 of the JAX package)."""
    bq, bqd = o.bq, o.qd                                     # (W, c, 7|6)
    com = bq[..., 0:3] + quat_rotate(bq[..., 3:7], o.com)
    r = pos - com
    v = torch.where(o.on, bqd[..., 0:3] + cross(bqd[..., 3:6], r), 0.0)
    R = quat_to_matrix(bq[..., 3:7])
    I_w = R @ o.inv_inertia @ R.transpose(-1, -2)            # (W, c, 3, 3)
    dirs = (nrm, t1, t2)
    const = torch.cat([_dot(d, v) * o.sgn for d in dirs], dim=1)
    w = []
    for d in dirs:
        rxd = cross(r, d)
        w.append(o.inv_mass + _dot(rxd, (I_w @ rxd[..., None])[..., 0]))
    w_other = torch.where(o.on[..., 0].repeat(1, 3), torch.cat(w, dim=1),
                          0.0)
    return _dot(nrm, v) * o.sgn, const, w_other.contiguous()


def _contact_system(solver, t, Minv, qd_g, v_o, w_o, body_qd, x_b, q,
                    contacts, dt, warm=None):
    """Contact and limit rows of the PGS system: J (W, 3c, d), b and act
    (W, r), mu (W, c) in BLOCK row order [n | t1 | t2 | lim-lo | lim-hi],
    from the row's c contact entries of each env (``contacts``, (W, c);
    a ragged plan's pad entries masked off). With a cap K below the entry
    count, each env keeps its K entries of highest score active * max(1 +
    depth, 0.5) (batched.py:684-736 of the JAX package), after the
    restitution pre-velocity of every entry. Two-sided entries add the
    other body's motion to the pre-velocity, shift b by its velocity along
    each row and pass its point inverse mass as B2's ``w_other``. With
    ``warm`` (W, 3 c) (the last impulses in full entry space, block
    order), B2 starts from them, gathered through the compaction and
    zeroed on inactive rows; limit rows start at 0. Returns B2's operands,
    its keywords and the compaction indices (W, K) (None without)."""
    nrm = contacts.rigid_contact_normal                      # (W, c, 3)
    pos = contacts.rigid_contact_position
    depth = contacts.rigid_contact_depth
    active = contacts.rigid_contact_mask
    if t.valid is not None:
        active = active & t.valid
    W, c = active.shape

    def vel_of(gb, on):
        return torch.where(on, velocity_at_point(
            _at_bodies(body_qd, gb, t.row_col),
            pos - _at_bodies(x_b, gb, t.row_col)), 0.0)

    vn_pre = _dot(nrm, vel_of(t.gb1, t.on1) - vel_of(t.gb0, t.on0))
    sign, mu, e_rest = t.sign, t.mu.expand(W, c), t.e_rest.expand(W, c)
    other = getattr(contacts, "other", None)
    idx = None
    c_full = c
    if t.cap < c:
        score = active.to(depth.dtype) * torch.clamp(1.0 + depth, min=0.5)
        idx = compaction_indices(score, t.cap)               # (W, K)
        nrm, pos, depth, active, vn_pre, mu, e_rest = (
            _take_slots(x, idx) for x in (nrm, pos, depth, active, vn_pre,
                                          mu, e_rest))
        sign = (t.sign[idx] if t.sign.dim() == 2
                else _take_slots(t.sign, idx))
        if other is not None:
            other = SimpleNamespace(**{k: _take_slots(v, idx) for k, v in
                                       vars(other).items()})
        c = t.cap

    t1, t2 = orthonormal_basis(nrm)
    vg, wg = v_o[:, t.di], w_o[:, t.di]                      # (W, d, 3)
    Vp = vg[:, None] + cross(wg[:, None], pos[:, :, None])   # (W, c, d, 3)
    J = torch.cat([_dot(dirs[:, :, None], Vp) * sign
                   for dirs in (nrm, t1, t2)], dim=1)        # (W, 3c, d)
    w_other = None
    if other is not None:
        vn_other, const, w_other = _other_side(other, nrm, t1, t2, pos)
        vn_pre = vn_pre + vn_other

    diag_scale = 1.0 + (1.0 - solver.impratio) / solver.impratio
    rest = torch.where(vn_pre < -2.0 * 9.81 * dt, -e_rest * vn_pre, 0.0)
    pen = torch.clamp(solver.baumgarte / dt
                      * torch.clamp(depth - solver.contact_slop, min=0.0),
                      max=solver.depenetration_velocity)
    gap_allow = torch.clamp(depth, max=0.0) / dt
    b_n = torch.where(depth > 0, rest + pen,
                      torch.where(rest > 0, rest, gap_allow))
    actf = active.to(J.dtype)
    b_c = torch.cat([torch.where(active, b_n, 0.0),
                     torch.zeros((W, 2 * c), dtype=J.dtype,
                                 device=J.device)], dim=1)
    if w_other is not None:
        # the other side's velocity: each row measures the relative one
        b_c = b_c - const
    b_parts, act_parts = [b_c], [actf, actf, actf]
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
    if warm is not None:
        # block layout [n | t1 | t2] of the full entries; an index gather
        # gives the JAX package's one-hot contraction's numbers
        w3 = warm.view(W, 3, c_full)
        if idx is not None:
            w3 = w3.gather(2, idx[:, None, :].expand(W, 3, c))
        lam0[:, :3 * c] = act3[:, :3 * c] * w3.reshape(W, 3 * c)
    mu = mu.contiguous()
    kw = dict(c=c, ld=t.ld_i32, iters=solver.contact_iterations,
              omega=solver.contact_relaxation,
              use_cone=solver.friction_cone == "cone",
              diag_scale=diag_scale, reg=solver.contact_reg)
    if w_other is not None:
        kw["w_other"] = w_other
    return (J, Minv, qd_g, b_rows, act3, mu, lam0), kw, idx, (nrm, t1, t2)


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


def _solve_equality(solver, t, Minv, qd_g, v_o, w_o, body_q, q, dt, solve,
                    record):
    """Exact bilateral impulse solve of the row's equality constraints
    (the JAX package's ``_solve_equality``, solver.py:928-1012): per
    CONNECT three positional rows at the two anchors, per WELD those and
    three angular rows, per JOINT one row qd1 - poly'(q2) qd2, each with a
    Baumgarte bias; then (J M^-1 J^T + contact_reg I) lam = -(J qd + b)
    through B1 without the inverse (``chol_solve``: the kernel on the
    card), qd += M^-1 J^T lam."""
    e = t.eq
    W, d = qd_g.shape
    vg, wg = v_o[:, t.di], w_o[:, t.di]                      # (W, d, 3)
    bq = body_q[:, t.bi]                                     # (W, b, 7)
    beta = solver.baumgarte / dt
    zero = qd_g.new_zeros(d)
    ident = e.identity.expand(W, 4)
    rows_J, rows_b = [], []
    for i, kind in enumerate(e.kinds):
        if kind == 2:                   # JOINT: qd1 - poly'(q2) qd2 = 0
            pc = e.polycoef[i]
            row = qd_g.new_zeros(W, d)
            row[:, e.dof1[i]] = 1.0
            q1 = q[:, e.coord1[i]]
            if e.dof2[i] >= 0:
                x2 = q[:, e.coord2[i]]
                row[:, e.dof2[i]] = -(pc[..., 1] + 2 * pc[..., 2] * x2
                                      + 3 * pc[..., 3] * x2 ** 2
                                      + 4 * pc[..., 4] * x2 ** 3)
                target = (pc[..., 0] + pc[..., 1] * x2 + pc[..., 2] * x2 ** 2
                          + pc[..., 3] * x2 ** 3 + pc[..., 4] * x2 ** 4)
            else:
                target = pc[..., 0]
            rows_J.append(row[:, None, :])
            rows_b.append((beta * (q1 - target))[:, None])
            continue
        lb1, lb2 = e.lb1[i], e.lb2[i]
        a1, a2 = e.anchor1[i], e.anchor2[i]
        p1 = (transform_point(bq[:, lb1], a1) if lb1 >= 0
              else a1.expand(W, 3))
        p2 = (transform_point(bq[:, lb2], a2) if lb2 >= 0
              else a2.expand(W, 3))
        anc1 = t.anc[lb1] if lb1 >= 0 else zero
        anc2 = t.anc[lb2] if lb2 >= 0 else zero
        V1 = vg + cross(wg, p1[:, None, :])                  # (W, d, 3)
        V2 = vg + cross(wg, p2[:, None, :])
        Jpos = V1 * anc1[None, :, None] - V2 * anc2[None, :, None]
        rows_J.append(Jpos.transpose(1, 2))                  # (W, 3, d)
        rows_b.append(beta * (p1 - p2))
        if kind == 1:                   # WELD adds the angular rows
            rows_J.append((wg * (anc1 - anc2)[None, :, None]).transpose(1, 2))
            q1r = bq[:, lb1, 3:7] if lb1 >= 0 else ident
            q2r = bq[:, lb2, 3:7] if lb2 >= 0 else ident
            target_q = quat_mul(q2r, e.relpose[i].expand(W, 4))
            qe = quat_mul(q1r, quat_conjugate(target_q))
            qe = torch.where(qe[:, 3:4] < 0, -qe, qe)
            rows_b.append(beta * 2.0 * qe[:, 0:3])
    J = torch.cat(rows_J, dim=1)                             # (W, r, d)
    b = torch.cat(rows_b, dim=1)                             # (W, r)
    MinvJt = torch.einsum("wde,wre->wdr", Minv, J)
    A = torch.einsum("wrd,wds->wrs", J, MinvJt)
    A = A + solver.contact_reg * torch.eye(A.shape[-1], dtype=A.dtype,
                                           device=A.device)
    rhs = -(torch.einsum("wrd,wd->wr", J, qd_g) + b)
    if record is not None:
        record["eq"] = (A, rhs)
    lam = solve(A.contiguous(), rhs.contiguous())
    return qd_g + torch.einsum("wdr,wr->wd", MinvJt, lam)


def _integrate_coords(t, q, qd, dt):
    """Semi-implicit Euler on the coordinates; ball joints integrate their
    dofs as the angular velocity in the joint-parent frame, free joints
    advance their COM and integrate the world-frame angular velocity."""
    q = q.clone()
    if len(t.lin_idx):
        q[:, t.lin_idx] = q[:, t.lin_idx] + dt * qd[:, t.lin_dof]
    if len(t.ball_q):
        q[:, t.ball_q] = quat_integrate(q[:, t.ball_q], qd[:, t.ball_d], dt)
    if t.free_p.shape[0]:
        quat = q[:, t.free_q]                                # (W, F, 4)
        new_quat = quat_integrate(quat, qd[:, t.free_w], dt)
        p_com = (q[:, t.free_p] + quat_rotate(quat, t.free_com)) \
            + qd[:, t.free_v] * dt
        q[:, t.free_p] = p_com - quat_rotate(new_quat, t.free_com)
        q[:, t.free_q] = new_quat
    return q


def _tendon_state(t, q, qd):
    """The row's fixed tendons' lengths and velocities (W, T); maps of
    several rows ((n, T, k): the rows' tendons differ) apply each env's
    own."""
    if t.tendon_Cq.dim() == 2:
        return q @ t.tendon_Cq.T, qd @ t.tendon_Cd.T
    return ((t.tendon_Cq @ q[..., None])[..., 0],
            (t.tendon_Cd @ qd[..., None])[..., 0])


def _spatial_tendons(t, body_q, qd, v_o, w_o):
    """The row's spatial tendons: lengths L, velocities V = J qd (W, Ts)
    and moment rows J (W, Ts, d)."""
    k = t.sten
    Ls, Js = eval_spatial_tendons(k.paths, body_q, v_o[:, t.di],
                                  w_o[:, t.di], t.anc_bd)
    L = torch.stack(Ls, dim=1)
    J = torch.stack(Js, dim=1)
    if k.sel is not None:
        # each env's own paths out of the distinct ones (a pad: zero)
        on, sel = k.sel >= 0, k.sel.clamp(min=0)
        L = torch.where(on, torch.gather(L, 1, sel), 0.0)
        J = torch.where(on[..., None], torch.gather(
            J, 1, sel[..., None].expand(-1, -1, J.shape[-1])), 0.0)
    return L, (J * qd[:, None, t.di]).sum(-1), J


def _smooth(solver, grp, q, qd, body_q, body_qd, body_f, control_b,
            explicit, act=None, dt=0.0, mount=None, x_tau=None):
    """The smooth dynamics of a group's rows at one configuration: the dof
    subspace (v_o, w_o), world COMs x_b, world inertias Iw, the mass matrix
    M (W, d, d), the net generalized force tau_net = applied + external +
    spatial tendons + actuator - bias, the implicit damping gains (zero
    with ``explicit``), and for the implicit integrators and activation
    dynamics: the spatial tendons (L, V, J), the actuators' dfdv and the
    next activation ``act_new`` (``act`` (W, A) the current one).
    ``x_tau`` (W, nd): the forces of the fixed tendons between
    articulations on the rows' dofs (``step``'s flat pre-pass)."""
    model, t = grp.row_model, grp.tables
    v_o, w_o = _dof_subspace(t, body_q, q)
    x_b, Iw = _spatial_inertia(model, body_q)
    tau_bias = _bias_forces(t, model, body_qd, v_o, w_o, x_b, Iw, mount)
    tau, kd_implicit = _applied_tau(t, q, qd, control_b, explicit)
    if x_tau is not None:
        tau = tau + x_tau
    if solver.apply_body_forces:
        tau = tau + _external_tau(t, body_f, x_b, v_o, w_o)
    out = SimpleNamespace(sten=None, dfdv=None, act_new=None)
    if t.sten is not None:
        # spatial tendons: f = -ke (L - L0) - kd V through the moment rows
        L, V, J = out.sten = _spatial_tendons(t, body_q, qd, v_o, w_o)
        f = -t.sten.ke * (L - t.sten.L0) - t.sten.kd * V
        tau = tau.clone()
        tau[:, t.di] = tau[:, t.di] + (J * f[..., None]).sum(1)
    au = grp.actuation
    if (au is not None and control_b is not None
            and "mjc:ctrl" in control_b.custom):
        tendon = _tendon_state(t, q, qd) if au.has_tendon else None
        tau_a, out.act_new, _, out.dfdv = actuator_forces(
            au, q, qd, control_b.custom["mjc:ctrl"], act, dt,
            sten=out.sten, tendon=tendon)
        tau = tau + tau_a
    M = _crba(t, v_o, w_o, x_b, Iw, model.body_mass)
    out.v_o, out.w_o, out.x_b, out.Iw, out.M = v_o, w_o, x_b, Iw, M
    out.tau_net, out.kd_implicit = tau - tau_bias, kd_implicit
    return out


def _bias_jacobian(t, model, body_qd, v_o, w_o, x_b, Iw):
    """d tau_bias / d qd (W, d, d), the Coriolis derivative that
    ``integrator="implicit"`` adds. The bias is quadratic in qd and the
    twists linear: dof k moves every body it carries with its subspace
    column S_k = (v_o_k, w_o_k), so one forward-mode pass of the RNEA with
    the d tangents on an axis of their own (W, B, d, 6) gives every
    column. The JAX package takes ``jax.jacfwd`` over all (D,) dofs of a
    model and reads the per-row blocks (ROADMAP C.21); the port forms only
    the blocks."""
    bw = body_qd[..., 3:6]
    V = torch.cat([body_qd[..., 0:3] - cross(bw, x_b), bw], -1)  # (W, B, 6)
    S = torch.cat([v_o[:, t.di], w_o[:, t.di]], -1)             # (W, d, 6)
    dV = t.anc_bd[None, :, :, None] * S[:, None]       # (W, B, d, 6)
    W = body_qd.shape[0]
    A = t.base_acc.expand(W, -1, -1).clone()
    dA = torch.zeros_like(dV)
    for pbc, cb, hasp in t.levels:
        Vc, dVc = V[:, cb], dV[:, cb]
        rel = Vc - torch.where(hasp, V[:, pbc], 0.0)
        drel = dVc - torch.where(hasp[..., None], dV[:, pbc], 0.0)
        A_p = torch.where(hasp, A[:, pbc], t.base_acc[:, cb])
        dA_p = torch.where(hasp[..., None], dA[:, pbc], 0.0)
        A[:, cb] = A_p + spatial_cross(Vc, rel)
        dA[:, cb] = (dA_p + spatial_cross(dVc, rel[:, :, None])
                     + spatial_cross(Vc[:, :, None], drel))
    m = model.body_mass[..., None, None]
    xb, Iwb = x_b[:, :, None], Iw[:, :, None]

    def apply_I(a):
        # the 3x3 products as broadcast sums: as batched matmuls of this
        # shape they ran as cuBLAS gemv, the implicit substep's largest
        # kernel after the elementwise ones
        f = (a[..., 0:3] + cross(a[..., 3:6], xb)) * m
        tq = (Iwb * a[..., None, 3:6]).sum(-1) + cross(xb, f)
        return torch.cat([f, tq], -1)
    IV = apply_I(V[:, :, None])                                # (W, B, 1, 6)
    dF = (apply_I(dA) + spatial_cross_dual(dV, IV)
          + spatial_cross_dual(V[:, :, None], apply_I(dV)))
    dF = _accumulate(t, dF)[:, t.dof_body]                  # (W, D, d, 6)
    return (_dot(v_o[..., None, :], dF[..., 0:3])
            + _dot(w_o[..., None, :], dF[..., 3:6]))[:, t.di]


def _damping_matrix(solver, grp, sm):
    """The implicit integrators' D = -d tau / d qd beyond the diagonal
    joint damping (W, d, d): the fixed tendons' kd c c^T, the joint
    actuators' -gear^2 dfdv on their dofs, the spatial tendons' kd J^T J
    with their actuators' -gear^2 dfdv on kd, and under "implicit" the
    Coriolis derivative. Each sum in a fixed order (dense products and
    FixedOrderSums)."""
    t, au = grp.tables, grp.actuation
    W, d = sm.M.shape[0], sm.M.shape[1]
    D = sm.M.new_zeros(W, d, d)
    if t.D_tendon is not None:
        D = D + t.D_tendon
    neg = None
    if au is not None and sm.dfdv is not None:
        neg = -(au.gear * au.gear) * sm.dfdv                 # (W, A)
        dj = au.to_dofs(torch.where(au.is_joint, neg, 0.0))
        D = D + torch.diag_embed(dj[:, t.di])
    if sm.sten is not None:
        J = sm.sten[2]                                       # (W, Ts, d)
        kd = t.sten.kd.expand(W, J.shape[1])
        if neg is not None and au.has_sten:
            kd = kd + au.to_stens(torch.where(au.is_st, neg, 0.0))
        D = D + torch.einsum("wtd,wt,wte->wde", J, kd, J)
    if solver.integrator == "implicit":
        D = D + sm.jbias
    return D


def _rk4(solver, grp, state_b, control_b, dt, chol, record, act=None):
    """Classic RK4 on the smooth dynamics (MuJoCo's mj_RungeKutta tableau,
    the JAX package's ``_rk4_update``): four evaluations of ``M a =
    tau_net`` with explicit joint damping, one B1 call each; stages 2-4
    at coordinates integrated from the substep's start (FK at each).
    Activation dynamics advance once, with stage 1's values. Returns
    stage 1's subspace, COMs and ``M^-1`` (for the contact and limit
    solve), the RK4 velocity, the tableau-weighted stage velocity that
    advances the coordinates and the next activation."""
    t = grp.tables
    q, qd = state_b.joint_q, state_b.joint_qd

    def accel(q_s, qd_s, stage):
        body_q, body_qd = state_b.body_q, state_b.body_qd
        if stage > 1:
            body_q, body_qd = fk_bodies(grp.row_model, q_s, qd_s, body_q,
                                        body_qd)
        sm = _smooth(solver, grp, q_s, qd_s, body_q, body_qd,
                     state_b.body_f, control_b, explicit=True, act=act,
                     dt=dt)
        rhs = sm.tau_net[:, t.di]
        if record is not None and stage == 1:
            record["chol"] = (sm.M, rhs)
        Minv, a_g = chol(sm.M, rhs)
        a = torch.zeros_like(qd)
        a[:, t.di] = a_g
        return a, (sm.v_o, sm.w_o, sm.x_b, Minv, sm.act_new)

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


def _entry_forces(lam, dirs, idx, c, contacts_b, dt):
    """Each contact entry's force (W, c_full, 3): its impulses along the
    normal and the two tangents over dt, scattered from the K compacted
    entries back to the row's full entry list (unique per row: a plain
    scatter), zero on the entries compaction left out."""
    W = lam.shape[0]
    ln, l1, l2 = lam[:, :3 * c].view(W, 3, c).unbind(1)
    f = (ln[..., None] * dirs[0] + l1[..., None] * dirs[1]
         + l2[..., None] * dirs[2]) / dt                     # (W, c, 3)
    if idx is None:
        return f
    c_full = contacts_b.rigid_contact_mask.shape[1]
    return f.new_zeros(W, c_full, 3).scatter_(
        1, idx[..., None].expand(W, c, 3), f)


def _substep(solver, grp, state_b: State, control_b, contacts_b, dt: float,
             kernels: bool, record: Optional[dict],
             report: Optional[dict] = None) -> State:
    """One substep of W envs of a group's row layout (leading axis of every
    tensor; ``contacts_b`` holds the row's c contact entries, (W, c), or
    None)."""
    model, t = grp.row_model, grp.tables
    q, qd = state_b.joint_q, state_b.joint_qd
    body_q, body_qd = state_b.body_q, state_b.body_qd
    chol = chol_inv_solve if kernels else chol_inv_solve_plain
    act = state_b.custom.get("mjc:act")
    symmetric = True

    if solver.integrator == "rk4":
        (v_o, w_o, x_b, Minv, act_new), qd_smooth, v_avg = _rk4(
            solver, grp, state_b, control_b, dt, chol, record, act)
        qd_g = qd_smooth[:, t.di]
    else:
        # group row: factor / solve / invert M + dt*Kd (+ dt*D under the
        # implicit integrators)
        mount = None
        if "mount:acc" in state_b.custom or "mount:F" in state_b.custom:
            mount = SimpleNamespace(acc=state_b.custom.get("mount:acc"),
                                    F=state_b.custom.get("mount:F"))
        sm = _smooth(solver, grp, q, qd, body_q, body_qd, state_b.body_f,
                     control_b, explicit=False, act=act, dt=dt, mount=mount,
                     x_tau=state_b.custom.get("tendon:tau"))
        v_o, w_o, x_b, M, act_new = sm.v_o, sm.w_o, sm.x_b, sm.M, sm.act_new
        Mi = M + dt * torch.diag_embed(sm.kd_implicit[:, t.di])
        qd_d = qd[:, t.di]
        rhs = (M @ qd_d[..., None])[..., 0] + dt * sm.tau_net[:, t.di]
        if solver.integrator in ("implicitfast", "implicit"):
            if solver.integrator == "implicit":
                sm.jbias = _bias_jacobian(t, model, body_qd, v_o, w_o, x_b,
                                          sm.Iw)
            D = _damping_matrix(solver, grp, sm)
            Mi = Mi + dt * D
            rhs = rhs + dt * (D @ qd_d[..., None])[..., 0]
        if solver.integrator == "implicit":
            # the Coriolis derivative makes the system non-symmetric: LU
            # (torch.linalg.solve_ex without its error check, no host
            # sync), the inverse and the solution in one call
            d = Mi.shape[-1]
            eye = torch.eye(d, dtype=Mi.dtype, device=Mi.device)
            if record is not None:
                record["lu"] = (Mi, rhs)
            X = torch.linalg.solve_ex(
                Mi, torch.cat([eye.expand_as(Mi), rhs[..., None]], -1),
                check_errors=False)[0]
            Minv, qd_g = X[..., :d].contiguous(), X[..., d].contiguous()
            symmetric = False
        else:
            if record is not None:
                record["chol"] = (Mi, rhs)
            Minv, qd_g = chol(Mi, rhs)
    custom = {}
    if act_new is not None:
        custom["mjc:act"] = act_new
    # the impulse solve on M^-1 (stage 1's under RK4)
    if contacts_b is not None:
        warm = state_b.custom.get("contact:lam") if solver.warm_start \
            else None
        args, kw, idx, dirs = _contact_system(solver, t, Minv, qd_g, v_o,
                                              w_o, body_qd, x_b, q,
                                              contacts_b, dt, warm)
        if record is not None:
            record["pgs"] = (args, kw)
        if solver.contact_solver == "admm":
            lam, dqd = solve_contacts_admm(solver, t, *args, c=kw["c"],
                                           E=t.lim_E,
                                           w_other=kw.get("w_other"),
                                           record=record)
        elif solver.contact_solver == "newton":
            J, Minv_, qd_, b_rows, act3, mu, _ = args
            lam, dqd = solve_contacts_newton(
                J, Minv_, qd_, b_rows, act3, mu, c=kw["c"], E=t.lim_E,
                impratio=solver.impratio, reg=solver.contact_reg,
                iterations=solver.newton_iterations,
                w_other=kw.get("w_other"), record=record)
        else:
            pgs = pgs_solve_fused if kernels else pgs_solve_fused_plain
            if not symmetric:
                kw["symmetric"] = False
            lam, dqd = pgs(*args, **kw)
        if record is not None:
            record["lam"] = lam
        if report is not None:
            report["force"] = _entry_forces(lam, dirs, idx, kw["c"],
                                            contacts_b, dt)
        qd_g = qd_g + dqd
        if solver.warm_start:
            # back to full entry space (unique slots per row: a plain
            # scatter, no atomics)
            c = kw["c"]
            lam3 = lam[:, :3 * c]
            if idx is not None:
                W = lam.shape[0]
                lam3 = lam.new_zeros(W, 3, contacts_b.rigid_contact_mask
                                     .shape[1]).scatter_(
                    2, idx[:, None, :].expand(W, 3, c),
                    lam3.view(W, 3, c)).view(W, -1)
            custom["contact:lam"] = lam3
    elif t.nl:
        if record is not None:
            record["limits"] = (Minv, qd_g)
        qd_g = _solve_limits(solver, t, Minv, qd_g, q, dt)
    # bilateral equality rows, after the contacts and limits
    if t.eq is not None:
        qd_g = _solve_equality(solver, t, Minv, qd_g, v_o, w_o, body_q, q, dt,
                               chol_solve if kernels else chol_solve_plain,
                               record)
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
    if solver.sleep_threshold > 0.0:
        # a row quiet (every dof below the threshold, no joint_f on it)
        # for sleep_steps substeps keeps its coordinates and poses bit for
        # bit and stops (the JAX package's _apply_sleep)
        speed = qd_new.abs().amax(-1)
        quiet = speed < solver.sleep_threshold
        if control_b is not None:
            quiet = quiet & (control_b.joint_f.abs().amax(-1) == 0.0)
        cnt = torch.where(quiet, state_b.custom["sleep:count"] + 1, 0)
        custom["sleep:count"] = cnt.to(torch.int32)
        asleep = (cnt >= solver.sleep_steps)[:, None]
        q_new = torch.where(asleep, q, q_new)
        qd_new = torch.where(asleep, 0.0, qd_new)
        body_q2 = torch.where(asleep[..., None], body_q, body_q2)
        body_qd2 = torch.where(asleep[..., None], 0.0, body_qd2)
    return replace(state_b, body_q=body_q2, body_qd=body_qd2, joint_q=q_new,
                   joint_qd=qd_new, custom=custom)


_CONTACT_ROWS = ("rigid_contact_normal", "rigid_contact_position",
                 "rigid_contact_depth", "rigid_contact_mask")


def _has_contacts(grp, contacts) -> bool:
    """Whether a group has a contact system this substep: contacts with
    slots and a contact plan."""
    return (contacts is not None and contacts.rigid_contact_max > 0
            and grp.plan is not None)


def _refuse_dynamic(contacts):
    """The solver's contact plans read each slot's fixed pair: Contacts of
    the dynamic-pair pipeline, whose slots change every call, raise (the
    JAX package documents that its plan needs static mode,
    sim/collide.py:123-127, but computes with whatever the slots hold)."""
    if getattr(contacts, "dynamic", False):
        raise ValueError(
            "the generalized solvers' per-slot contact plan needs the static "
            "pipeline's slots: build CollisionPipeline(model, mode='static') "
            "(dynamic-pair Contacts reassign their slots every call)")


def _contact_rows(grp, contacts, take):
    """The group's contact entries of each env, or None without a contact
    system."""
    if not _has_contacts(grp, contacts):
        return None
    return SimpleNamespace(**{n: take(getattr(contacts, n))
                              for n in _CONTACT_ROWS})


def step_batched(solver, state_b: State, control_b=None, contacts_b=None,
                 dt: float = 1e-3, kernels: bool = True,
                 record: Optional[dict] = None,
                 report: Optional[dict] = None) -> State:
    """One substep of W independent envs of a one-world model (leading
    axis of every tensor; ``contacts_b`` from ``collide`` on the batched
    state).

    ``kernels=False`` runs the plain PyTorch versions of the two kernels
    instead, whatever the device: the reference path that a run on the card
    compares the kernel path with. ``record``, when a dict, receives the
    operands of the two kernel calls (``"chol"``: stage 1's under RK4;
    ``"pgs"``) and the contact impulses (``"lam"``), or the operands of the
    limits-only solve (``"limits"``) in a substep without contacts; under
    ``integrator="implicit"`` the LU's operands (``"lu"``) in place of
    ``"chol"``; the Newton QP's last masked system (``"newton_H"``) and
    Kamino's factored matrix (``"admm_factor"``). ``report``, when a dict,
    receives each contact entry's force (``"force"``, (W, c, 3)), the
    force report of ``step_with_contacts``."""
    _refuse_dynamic(contacts_b)
    if not solver._model_is_row:
        raise NotImplementedError(
            "step_batched takes a one-world model of one articulation whose "
            "bodies and joints all belong to it; step() steps every world "
            "and articulation of a model")
    grp = solver.groups[0]
    t = grp.tables
    rows = _contact_rows(grp, contacts_b, lambda x: x if
                         t.slots_are_all else x[:, t.row_slots[0]])
    # the one-world group's entries of State.custom, (W, 1, ...) as
    # batch_state tiles init_state's, carried as (W, ...)
    W = state_b.joint_q.shape[0]
    keys = _custom_keys(solver, grp)
    if "sleep:count" in keys and keys["sleep:count"] not in state_b.custom:
        raise ValueError(
            "sleeping enabled: initialize the state with "
            "solver.init_state(state) before batch_state to allocate the "
            "sleep counters")
    inner = {k: state_b.custom[v].reshape(W, *state_b.custom[v].shape[2:])
             for k, v in keys.items() if v in state_b.custom}
    if "mjc:act" in state_b.custom:
        # the activations (W, A), one world's actuators per env
        inner["mjc:act"] = state_b.custom["mjc:act"]
    out = _substep(solver, grp, replace(state_b, custom=inner), control_b,
                   rows, dt, kernels, record, report)
    custom = dict(state_b.custom)
    for k, v in out.custom.items():
        custom[k if k == "mjc:act" else keys[k]] = (
            v if k == "mjc:act" else v.reshape(W, 1, *v.shape[1:]))
    return replace(out, custom=custom)


def _custom_keys(solver, grp):
    """The substep's own State.custom entries -> the group's keys."""
    keys = {}
    if solver.warm_start and grp.plan is not None:
        keys["contact:lam"] = f"contact:lam:{grp.index}"
    if solver.sleep_threshold > 0.0:
        keys["sleep:count"] = f"sleep:count:{grp.index}"
    return keys


def _gather_rows(grp, state, control, contacts, keys=None):
    """A group's rows of a flat State, Control and Contacts: (n, k, ...)
    through the group's (n, k) row tables; a two-sided entry also takes
    its other body's pre-step pose and velocity. ``keys`` maps the
    substep's State.custom entries to the group's (per row already)."""
    t = grp.tables
    rows = replace(
        state, body_q=state.body_q[t.row_read],
        body_qd=state.body_qd[t.row_read], body_f=state.body_f[t.row_read],
        joint_q=state.joint_q[t.row_coord],
        joint_qd=state.joint_qd[t.row_dof],
        custom={k: state.custom[v] for k, v in (keys or {}).items()
                if v in state.custom})
    if "mjc:act" in state.custom and t.row_act.numel():
        rows.custom["mjc:act"] = _take(state.custom["mjc:act"], t.row_act,
                                       t.act_pad)
    ctl = None
    if control is not None:
        custom = {}
        if "mjc:ctrl" in control.custom:
            custom["mjc:ctrl"] = _take(control.custom["mjc:ctrl"],
                                       t.row_act, t.act_pad)
        ctl = Control(
            joint_target_q=control.joint_target_q[t.row_coord],
            joint_target_qd=control.joint_target_qd[t.row_dof],
            joint_f=control.joint_f[t.row_dof],
            tendon_f=(None if control.tendon_f is None
                      else _take(control.tendon_f, t.row_tendon,
                                 t.tendon_pad)),
            custom=custom)
    crows = _contact_rows(grp, contacts, lambda x: x[t.row_slots])
    if crows is not None and t.other is not None:
        o = t.other
        crows.other = SimpleNamespace(
            bq=state.body_q[o.body], qd=state.body_qd[o.body], on=o.on,
            sgn=o.sgn, inv_mass=o.inv_mass, inv_inertia=o.inv_inertia,
            com=o.com)
    return rows, ctl, crows


def _take(v, idx, pad):
    """``v`` at a group's (n, k) entity rows, zero on a ragged group's
    padding entries."""
    return v[idx] if pad is None else torch.where(pad, 0.0, v[idx])


def _cross_forces(solver, state, control, dt):
    """The flat pre-pass of the fixed tendons between articulations
    (``solver.cross``): their spring, damper and ``tendon_f`` forces and
    the forces of the actuators on them, on the flat dofs (D,), and those
    actuators' next activations (or None)."""
    x = solver.cross
    q, qd = state.joint_q[None], state.joint_qd[None]
    L, V = q @ x.Cq.T, qd @ x.Cd.T                           # (1, K)
    ke, kd, L0 = solver.model.tendon_params[x.tendons].unbind(-1)
    f = -ke * (L - L0) - kd * V
    if control is not None and control.tendon_f is not None:
        f = f + control.tendon_f[x.tendons]
    tau = f @ x.Cd
    act_new = None
    if (x.actuation is not None and control is not None
            and "mjc:ctrl" in control.custom):
        act = state.custom.get("mjc:act")
        tau_a, act_new, _, _ = actuator_forces(
            x.actuation, q, qd, control.custom["mjc:ctrl"][x.acts][None],
            None if act is None else act[x.acts][None], dt, tendon=(L, V))
        tau = tau + tau_a
    return tau[0], act_new


def _mount_coupling(solver, state):
    """The cross-articulation terms of the JAX package's whole-model RNEA,
    for the rows mounted on another articulation's body: each mounted
    row's mount accelerations (the carrier's forward pass, carriers
    first), and each carrier body's extra wrench, the subtree wrenches of
    the rows hanging from it (their bias less their external wrenches,
    carried rows first; one fixed-order sum per group). Returns
    {group index: (acc (n, m, 6) or None, F (n, b + m, 6) or None)}."""
    model = solver.model
    B = model.structure.body_count
    g = model.gravity[solver.mount_world]
    A_flat = torch.cat([-g, torch.zeros_like(g)], -1)        # (B, 6)
    acc = {}
    for gi in sorted(solver.acc_groups | set(solver.mount_order),
                     key=solver.mount_depth.__getitem__):
        grp = solver.groups[gi]
        t = grp.tables
        m_acc = A_flat[t.row_read[:, t.nb:]] if grp.mounts is not None \
            else None
        acc[gi] = m_acc
        if gi in solver.acc_groups:
            body_q = state.body_q[t.row_read]
            x_b = body_q[..., 0:3] + quat_rotate(body_q[..., 3:7],
                                                 grp.row_model.body_com)
            _, A = _accelerations(t, state.body_qd[t.row_read], x_b,
                                  SimpleNamespace(acc=m_acc))
            A_flat[t.row_body] = A[:, :t.nb]
    extra = torch.zeros(B, 6, dtype=A_flat.dtype, device=A_flat.device)
    for gi in reversed(solver.mount_order):
        grp = solver.groups[gi]
        t, rm = grp.tables, grp.row_model
        body_q = state.body_q[t.row_read]
        x_b, Iw = _spatial_inertia(rm, body_q)
        F = _bias_wrenches(t, rm, state.body_qd[t.row_read], x_b, Iw,
                           SimpleNamespace(acc=acc[gi]))
        if solver.apply_body_forces:
            f = state.body_f[t.row_read]
            F = F - torch.cat([f[..., 0:3], f[..., 3:6]
                               + cross(x_b, f[..., 0:3])], -1)
        F = F + extra[t.row_read]
        # only the row's own bodies hang from the mounts
        F = torch.cat([F[:, :t.nb], torch.zeros_like(F[:, t.nb:])], 1)
        F_hat = _accumulate(t, F)[:, t.nb:]                  # (n, m, 6)
        extra = extra + solver.mount_sums[gi](F_hat.reshape(-1, 6))
    out = {}
    for grp in solver.groups:
        gi = grp.index
        F = (extra[grp.tables.row_read]
             if grp.tables.d and gi in solver.acc_groups else None)
        if acc.get(gi) is not None or F is not None:
            out[gi] = (acc.get(gi), F)
    return out


def step(solver, state: State, control: Optional[Control] = None,
         contacts=None, dt: float = 1e-3, kernels: bool = True,
         record: Optional[dict] = None,
         report: Optional[dict] = None) -> State:
    """One substep of a flat State (every world of the model: ``joint_q
    (N nq,)``, ``body_q (N b, 7)``, ``mjc:ctrl (N A,)``, Contacts ``(C,)``),
    the JAX package's ``SolverMuJoCo.step``. Each articulation group's N
    rows are gathered into ``(N, ...)`` from the input state, stepped as N
    envs, and scattered back into disjoint indices of a new State (a group
    without dofs keeps its bodies, and so does a body outside every
    articulation). A mounted group steps from its mounts' pre-step poses
    and twists, and its bodies follow its mounts' new poses through FK
    after every group has stepped. With ``contact:overflow:<gi>`` in
    ``state.custom`` (``init_state``) the output carries each row's count
    of active contacts that compaction dropped. ``record`` receives what
    ``step_batched`` records; for a model of several groups, one such dict
    per group under ``record["groups"][gi]``. ``report``, when a dict,
    receives each group's per-entry contact forces under
    ``report[gi]``."""
    _refuse_dynamic(contacts)
    if solver.sleep_threshold > 0.0 and "sleep:count:0" not in state.custom:
        # counters allocated lazily, as the JAX package's step does
        state = solver.init_state(state)
    coupling = _mount_coupling(solver, state) if solver.mount_order else {}
    outs = []
    custom = dict(state.custom)
    x_tau = None
    if solver.cross is not None:
        x_tau, x_act = _cross_forces(solver, state, control, dt)
        if x_act is not None:
            custom["mjc:act"] = state.custom["mjc:act"].clone()
            custom["mjc:act"][solver.cross.acts] = x_act[0]
    for grp in solver.groups:
        t = grp.tables
        if t.d == 0:
            continue
        rec = record
        if record is not None and len(solver.groups) > 1:
            rec = record.setdefault("groups", {}).setdefault(grp.index, {})
        rep = None
        if report is not None:
            rep = report.setdefault(grp.index, {})
        keys = _custom_keys(solver, grp)
        rows, ctl, crows = _gather_rows(grp, state, control, contacts, keys)
        if x_tau is not None:
            rows.custom["tendon:tau"] = x_tau[t.row_dof]
        if grp.index in coupling:
            m_acc, m_F = coupling[grp.index]
            rows.custom.update({k: v for k, v in (("mount:acc", m_acc),
                                                  ("mount:F", m_F))
                                if v is not None})
        out = _substep(solver, grp, rows, ctl, crows, dt, kernels, rec, rep)
        outs.append((grp, out))
        act = out.custom.pop("mjc:act", None)
        if act is not None:
            # each row's activations back into the flat (N A,) layout
            if "mjc:act" not in custom or custom["mjc:act"] is \
                    state.custom.get("mjc:act"):
                custom["mjc:act"] = state.custom["mjc:act"].clone()
            if t.act_put is None:
                custom["mjc:act"][t.row_act] = act
            else:
                dst, r, a = t.act_put
                custom["mjc:act"][dst] = act[r, a]
        custom.update({keys[k]: v for k, v in out.custom.items()})

    def put(name, idx_name):
        x = getattr(state, name).clone()
        for grp, out in outs:
            t = grp.tables
            v = getattr(out, name)
            x[getattr(t, idx_name)] = v[:, :t.nb] if idx_name == "row_body" \
                else v
        return x
    for grp in solver.groups:
        key = f"contact:overflow:{grp.index}"
        if key in custom and grp.g.d:
            t = grp.tables
            over = torch.zeros_like(custom[key])
            if _has_contacts(grp, contacts):
                mask = contacts.rigid_contact_mask[t.row_slots]
                if t.valid is not None:
                    mask = mask & t.valid
                over = torch.clamp(mask.sum(1) - t.cap, min=0).to(over.dtype)
            custom[key] = over
    body_q, body_qd = put("body_q", "row_body"), put("body_qd", "row_body")
    if solver.mount_order:
        # mounted rows follow their mounts' new poses (carriers first)
        outs_of = {grp.index: out for grp, out in outs}
        for gi in solver.mount_order:
            grp = solver.groups[gi]
            t, out = grp.tables, outs_of[gi]
            bq, bqd = fk_bodies(grp.row_model, out.joint_q, out.joint_qd,
                                body_q[t.row_read], body_qd[t.row_read])
            body_q[t.row_body] = bq[:, :t.nb]
            body_qd[t.row_body] = bqd[:, :t.nb]
    return replace(
        state, body_q=body_q, body_qd=body_qd,
        joint_q=put("joint_q", "row_coord"),
        joint_qd=put("joint_qd", "row_dof"), custom=custom)
