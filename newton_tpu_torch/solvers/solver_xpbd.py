"""XPBD solver (port of ``newton_tpu/solvers/solver_xpbd.py``).

Extended position-based dynamics for rigid bodies, particles, cloth, soft
bodies and cables: each substep predicts the bodies and particles with
semi-implicit Euler, runs ``iterations`` Jacobi sweeps of positional
corrections (joints, the cable joints' compliant stretch, shear, bend and
twist rows, contacts; particle springs, triangle edges, tetrahedra,
particle-particle contacts through a hash grid and particle-shape
contacts with friction against the shape's surface motion), each body's
and particle's corrections averaged over its constraints, rebuilds the
velocities from the positions, and applies the velocity passes at the
rigid contacts (Coulomb friction, or Dahl bristle friction with one pass,
restitution and the removal of depenetration bias) and the cables'
implicit damping; generalized coordinates follow through ``eval_ik``.
``step`` takes the flat State of any model: every world of a replicated
model at once, since worlds share no joint or contact.

The JAX package sums the corrections with ``segment_sum`` and
``.at[].add``; here every such sum is a ``FixedOrderSum`` over tables
built once from the joint list, the particle constraint lists and the
static pipeline's contact slots, so two runs of a substep are equal bit
for bit on the card (``index_add_`` would add in no fixed order); the
dynamic-pair pipeline's Contacts, whose slots change every call, are
summed by a ``DynamicOrderSum`` planned once per substep on the device. The
particle-particle candidates come from the hash grid's fixed budget per
cell; the candidates beyond it are counted in
``State.custom["xpbd:grid_overflow"]``, not dropped in silence.
Hydroelastic Contacts (``rigid_contact_stiffness``, from
``CollisionPipeline(hydroelastic=True)``) make their slots compliant
rows: an XPBD constraint of compliance 1 / (c dt^2), scaled by the
share of each correction that the averaged Jacobi update realizes (the
previous iteration's per-body constraint counts), so that the settled
force is c depth, the patch's pressure integral; such a slot may push
but not pull, keeps the velocity stop of an approaching contact, and
reports c depth as its force.
"""

from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..core.segment_sum import (DynamicOrderSum, FixedOrderSum,
                                check_static_slots, slot_body_dst,
                                soft_contact_sum)
from ..math import (
    cross,
    quat_conjugate,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inv,
    quat_to_matrix,
    safe_norm,
    safe_normalize,
    transform_multiply,
    transform_point,
)
from ..sim.articulation import eval_ik
from ..sim.contacts import Contacts
from ..sim.control import Control
from ..sim.enums import JointType
from ..sim.model import Model
from ..sim.state import State
from ..geometry.hashgrid import HashGrid
from .solver import (SolverBase, body_gravity, integrate_bodies,
                     integrate_particles, particle_gravity)

__all__ = ["SolverXPBD"]


def _mv(M, v):
    """Batched 3x3 matrix-vector product (..., 3, 3) x (..., 3), as a
    broadcast product and sum (a batched matmul of 3x3 blocks runs as a
    slow general matrix-vector kernel on the card)."""
    return (M * v[..., None, :]).sum(-1)


def _quad(u, M):
    """u^T M u over the last axis."""
    return (u * _mv(M, u)).sum(-1)


class SolverXPBD(SolverBase):
    """Extended position-based dynamics (same constructor and defaults as
    the JAX package's ``SolverXPBD``).

    Args:
        iterations: positional solver iterations per substep.
        relaxation: Jacobi relaxation factor of the accumulated corrections.
        joint_linear_compliance / joint_angular_compliance: XPBD compliance
            of the joint constraints (0 = rigid).
        rigid_contact_relaxation: relaxation of the contact corrections.
        angular_damping: passed to the semi-implicit integrator.
        enable_restitution: the velocity pass's restitution and bias
            removal.
        enable_particle_particle: particle-particle contacts through the
            hash grid (cell 2 r_max, ``particle_max_per_cell`` candidates
            from each of the 27 neighbouring cells).
        max_depenetration_velocity: cap of the positional push-out rate.
        friction_model: "coulomb", or "dahl": bristle friction whose
            tangential force per static contact slot, in
            ``State.custom["xpbd:dahl_f"]`` (``init_state``), evolves with
            the slip as df/dx = dahl_sigma (1 - f.t / (mu N)).
    ``friction_epsilon`` is accepted for the reference's signature (the
    JAX package reads it nowhere).
    """

    def __init__(self, model: Model, iterations: int = 4,
                 relaxation: float = 0.7,
                 joint_linear_compliance: float = 0.0,
                 joint_angular_compliance: float = 0.0,
                 rigid_contact_relaxation: float = 0.8,
                 angular_damping: float = 0.05,
                 enable_restitution: bool = True,
                 enable_particle_particle: bool = True,
                 friction_epsilon: float = 1e-5,
                 max_depenetration_velocity: float = 3.0,
                 friction_model: str = "coulomb",
                 dahl_sigma: float = 2.0e4,
                 particle_max_per_cell: int = 4):
        super().__init__(model)
        if friction_model not in ("coulomb", "dahl"):
            raise ValueError(f"unknown friction_model {friction_model!r}")
        self.iterations = int(iterations)
        self.relaxation = float(relaxation)
        self.joint_linear_compliance = float(joint_linear_compliance)
        self.joint_angular_compliance = float(joint_angular_compliance)
        self.rigid_contact_relaxation = float(rigid_contact_relaxation)
        self.angular_damping = float(angular_damping)
        self.enable_restitution = bool(enable_restitution)
        self.enable_particle_particle = bool(enable_particle_particle)
        self.friction_epsilon = float(friction_epsilon)
        self.max_depenetration_velocity = float(max_depenetration_velocity)
        self.friction_model = friction_model
        self.dahl_sigma = float(dahl_sigma)
        self.particle_max_per_cell = int(particle_max_per_cell)
        self.notify_model_changed()
        self._last_lam_n = None

    def notify_model_changed(self, flags: int = 0):
        """Re-read the model's tensors after an edit (gravity, drive gains,
        limits, masses, friction, particle materials): the plans' per-joint,
        per-body and per-constraint constants are gathered again. ``flags``
        is ignored."""
        self._plan = _XPBDPlan(self.model)
        self._pplan = (_ParticlePlan(self.model, self)
                       if self.model.particle_count else None)

    def init_state(self, state: State) -> State:
        """The State with the solver's entries of ``State.custom``: with
        ``friction_model="dahl"``, ``xpbd:dahl_f`` (C, 3), the bristle
        force of each static contact slot (the JAX package's
        ``init_state``)."""
        custom = dict(state.custom)
        if self.friction_model == "dahl":
            C = len(np.asarray(self.model.structure.slot_shape0))
            custom.setdefault("xpbd:dahl_f", torch.zeros(
                (C, 3), dtype=torch.float32, device=state.body_q.device))
        return replace(state, custom=custom)

    # ------------------------------------------------------------------
    def step(self, state_in: State, state_out: Optional[State] = None,
             control: Optional[Control] = None,
             contacts: Optional[Contacts] = None, dt: float = 1e-3) -> State:
        """One substep of a flat State; returns the new State (``state_out``
        is not written). Its ``body_f`` is ``state_in``'s: the joint
        forces' wrenches act inside the substep only."""
        model, plan, pp = self.model, self._plan, self._pplan
        B, N = model.body_count, model.particle_count
        _check_contacts(contacts)
        C = contacts.rigid_contact_max if contacts is not None else 0
        S = contacts.soft_contact_max if contacts is not None else 0
        state = state_in
        custom = dict(state_in.custom)
        if B:
            # 1. generalized joint forces -> body wrenches
            if control is not None and model.structure.joint_dof_count:
                state = replace(state, body_f=state.body_f
                                + plan.joint_forces_to_body_f(model, state,
                                                              control))
            # 2. prediction
            body_q_pred, body_qd_pred = integrate_bodies(
                model, state, dt, self.angular_damping,
                gravity=plan.gravity)
            x_prev = state.body_q[:, 0:3] + quat_rotate(state.body_q[:, 3:7],
                                                        model.body_com)
            q_prev = state.body_q[:, 3:7]
            x = body_q_pred[:, 0:3] + quat_rotate(body_q_pred[:, 3:7],
                                                  model.body_com)
            q = body_q_pred[:, 3:7]
        cb = None
        lam_n = torch.zeros(C, dtype=state_in.body_q.dtype,
                            device=state_in.body_q.device)
        if B and C:
            if not getattr(contacts, "dynamic", False):
                check_static_slots(contacts, model.structure, rigid=True)
            cb = plan.contact_bodies(model, contacts)
            cb.anchors = plan.contact_local_anchors(model, state_in,
                                                    contacts, cb)
        if N:
            px, _ = integrate_particles(model, state, dt,
                                        gravity=pp.gravity)
            px_prev = state.particle_q
            nbr = None
            if pp.grid is not None:
                # the neighbourhood of the predicted positions, once per
                # substep; candidates beyond the grid's budget are counted
                *nbr, over = pp.grid.query(px, pp.query_radius,
                                           count_overflow=True)
                custom["xpbd:grid_overflow"] = over
            soft = None
            if S:
                if not getattr(contacts, "dynamic", False):  # soft: static
                    check_static_slots(contacts, model.structure, soft=True)
                soft = pp.soft_frame(model, state_in, contacts, dt)
        # 3. positional iterations: averaged Jacobi over all constraints;
        # compliant slots read the previous iteration's per-body counts
        contact_scale = self.rigid_contact_relaxation / self.relaxation
        stiff = None if contacts is None else \
            contacts.rigid_contact_stiffness
        denom_prev = torch.ones(B, dtype=state_in.body_q.dtype,
                                device=state_in.body_q.device)
        for _ in range(self.iterations):
            if B:
                Iinv = plan.inv_inertia_world(model, q)
                rows = [plan.solve_joints(
                    model, x, q, Iinv, dt, self.joint_linear_compliance,
                    self.joint_angular_compliance, control)]
                if C:
                    vals, lam_n = plan.solve_rigid_contacts(
                        model, x, q, Iinv, contacts, cb, lam_n, dt,
                        self.max_depenetration_velocity, stiff,
                        self.rigid_contact_relaxation, denom_prev)
                    vals = torch.cat([vals[:, 0:6] * contact_scale,
                                      vals[:, 6:7]], -1)
                    rows.append(vals)
                acc = plan.sum_rows(rows, C, cb)
                denom = torch.clamp(acc[:, 6:7], min=1.0)
                denom_prev = denom[:, 0]
                x = x + self.relaxation * acc[:, 0:3] / denom
                dq = quat_mul(torch.cat([acc[:, 3:6] / denom,
                                         torch.zeros_like(denom)], -1), q)
                q = quat_normalize(q + 0.5 * self.relaxation * dq)
            if N:
                dpx, dpxc, pnc = pp.solve(model, px, px_prev, dt, nbr, soft)
                # structural corrections averaged by the constraint degree,
                # contact corrections by the active-contact count
                px = px + self.relaxation * (
                    dpx / pp.degree + dpxc / torch.clamp(pnc, min=1.0)[:, None])

        out = state_in
        if B:
            # 4. velocities from the positions; bodies without mass keep
            # the integrator's
            v = (x - x_prev) / dt
            dq_rel = quat_mul(q, quat_conjugate(q_prev))
            w = 2.0 / dt * dq_rel[:, 0:3]
            w = torch.where(dq_rel[:, 3:4] < 0.0, -w, w)
            dyn = plan.dynamic
            v = torch.where(dyn, v, body_qd_pred[:, 0:3])
            w = torch.where(dyn, w, body_qd_pred[:, 3:6])
            # 5. contact velocity passes: Coulomb one, then three more to
            # converge the averaged-Jacobi projection of coupled slip; Dahl
            # one, its bristle state integrating once per substep
            if C:
                vp = plan.velocity_plan(model, x, q, state_in, contacts, cb,
                                        lam_n, dt, self.enable_restitution)
                if self.friction_model == "dahl":
                    dahl_f = state_in.custom.get("xpbd:dahl_f")
                    if dahl_f is None:
                        raise ValueError(
                            "friction_model='dahl': initialize the state "
                            "with solver.init_state(state) to allocate "
                            "bristle state")
                    v, w, custom["xpbd:dahl_f"] = plan.velocity_pass(
                        vp, v, w, contacts, dt, dahl_f, self.dahl_sigma)
                else:
                    for _ in range(4):
                        v, w, _ = plan.velocity_pass(vp, v, w, contacts, dt)
            if plan.cable is not None:
                v, w = plan.cable_velocity_pass(model, x, q, v, w, dt)
            body_q = torch.cat([x - quat_rotate(q, model.body_com), q], -1)
            out = replace(out, body_q=body_q, body_qd=torch.cat([v, w], -1))
        if N:
            pv = (px - px_prev) / dt
            pv = torch.where(pp.active, pv, state_in.particle_qd)
            px = torch.where(pp.active, px, state_in.particle_q)
            out = replace(out, particle_q=px, particle_qd=pv)
        out = replace(out, custom=custom)
        if model.structure.joint_count:
            jq, jqd = eval_ik(model, out)
            out = replace(out, joint_q=jq, joint_qd=jqd)
        self._last_lam_n = lam_n
        return out

    def step_with_contacts(self, state_in, state_out, control, contacts, dt):
        """``step`` and the contact force report from the accumulated normal
        impulses: f = rigid_contact_relaxation lambda / dt^2 along the
        normal, c depth at a compliant slot (the JAX package's
        ``step_with_contacts``)."""
        out = self.step(state_in, state_out, control, contacts, dt)
        if contacts is None or contacts.rigid_contact_max == 0:
            return out, contacts
        fmag = self.rigid_contact_relaxation * self._last_lam_n / (dt * dt)
        stiff = contacts.rigid_contact_stiffness
        if stiff is not None:
            # compliant slots report the patch integral c depth (the
            # impulse would carry the Jacobi averaging factor)
            fmag = torch.where(stiff > 0.0,
                               stiff * contacts.rigid_contact_depth, fmag)
        return out, replace(contacts, rigid_contact_force=(
            contacts.rigid_contact_normal * fmag[:, None]))

    def update_contacts(self, contacts, state_in, state_out, dt):
        _, c2 = self.step_with_contacts(state_in, None, None, contacts, dt)
        return c2


def _check_contacts(contacts):
    """Contacts the solver cannot honour raise, naming what they carry."""
    if contacts is None:
        return
    if contacts.rigid_contact_mask.dim() != 1:
        raise ValueError("SolverXPBD.step takes the flat (C,) Contacts of a "
                         "flat State")


class _XPBDPlan:
    """Index tensors and per-joint/per-body constants on the model's device,
    built once; the constraint sweeps read them."""

    def __init__(self, model: Model):
        st = model.structure
        dev = model.device
        self.st = st
        J = st.joint_count
        D = st.joint_dof_count
        jt = np.asarray(st.joint_type, dtype=np.int64)

        def L(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        def Bm(a):
            return torch.as_tensor(np.asarray(a, dtype=bool),
                                   device=dev)[:, None]
        parent = np.asarray(st.joint_parent, dtype=np.int64)
        self.J = J
        self.dev = dev
        B = st.body_count
        child = np.asarray(st.joint_child, dtype=np.int64)
        # the destinations of the sums: each joint's row for its child,
        # then for its parent (none for a joint to the world)
        self._jdst = np.concatenate([child, np.where(parent >= 0, parent,
                                                     -1)])
        self._sums = {}
        self.parent = L(np.maximum(parent, 0))
        self.hasp = Bm(parent >= 0)
        self.child = L(st.joint_child)
        is_rev = jt == int(JointType.REVOLUTE)
        is_pris = jt == int(JointType.PRISMATIC)
        self.free = Bm(np.isin(jt, [int(JointType.FREE),
                                    int(JointType.DISTANCE)]))
        self.rev, self.pris = Bm(is_rev), Bm(is_pris)
        self.lock = Bm((jt == int(JointType.FIXED)) | is_pris)
        self.identity = torch.tensor([0.0, 0, 0, 0, 0, 0, 1], device=dev)
        self.z_axis = torch.tensor([0.0, 0, 1], device=dev)
        # each joint's first dof and coordinate (the axis, limits and drive
        # of a 1-dof joint), clamped into range as a JAX gather is
        dof0 = np.minimum(np.asarray(st.joint_qd_start[:J]), max(D - 1, 0))
        coord0 = np.minimum(np.asarray(st.joint_q_start[:J]),
                            max(st.joint_coord_count - 1, 0))
        self.coord0 = L(coord0)
        zeros = torch.zeros(J, device=dev)
        if D:
            d0 = L(dof0)
            self.axis = model.joint_axis[d0]
            self.lo = model.joint_limit_lower[d0]
            self.hi = model.joint_limit_upper[d0]
            self.ke = model.joint_target_ke[d0]
        else:
            self.axis = torch.zeros(J, 3, device=dev)
            self.lo = self.hi = self.ke = zeros
        # drives act on revolute and prismatic joints with a stiffness
        drive = (is_rev | is_pris) & (self.ke.cpu().numpy() > 0)
        self.has_drives = bool(drive.any())
        # generalized forces of 1-dof joints
        one = np.nonzero(is_rev | is_pris)[0]
        self.f_joint = None
        if len(one):
            j = L(one)
            self.f_joint = SimpleNamespace(
                sum=FixedOrderSum(np.concatenate([
                    child[one], np.where(parent[one] >= 0, parent[one],
                                         -1)]), B, dev),
                dof=L(dof0[one]), parent=self.parent[j],
                hasp=self.hasp[j], child=self.child[j], rev=self.rev[j],
                X_p=model.joint_X_p[j], axis=self.axis[j],
                com_p=model.body_com[self.parent[j]],
                com_c=model.body_com[self.child[j]])
        self.shape_body = L(st.shape_body)
        self.gravity = body_gravity(model)
        self.dynamic = (model.body_inv_mass > 0)[:, None]
        # cable joints: their six stiffness and damping slots [shear_x,
        # shear_y, stretch_z, bend_x, bend_y, twist_z] (dof indices
        # clamped into range as a JAX gather is; other joints masked off)
        self.cable = None
        is_cable = jt == int(JointType.CABLE)
        if J and is_cable.any():
            cdof = L(np.minimum(np.asarray(st.joint_qd_start[:J])[:, None]
                                + np.arange(6)[None], max(D - 1, 0)))
            ke, kd = model.joint_target_ke[cdof], model.joint_target_kd[cdof]
            mask = Bm(is_cable)[:, 0]
            # the four rows of each cable, all at once (4, J): stretch,
            # shear (linear), bend, twist (angular) in the sweep; stretch,
            # shear, twist, bend in the damping pass
            ke4 = torch.stack([ke[:, 2], ke[:, 0], ke[:, 3], ke[:, 5]])
            kd4 = torch.stack([kd[:, 2], kd[:, 0], kd[:, 5], kd[:, 3]])
            self.cable = SimpleNamespace(
                mask=mask, inv_ke=1.0 / torch.clamp(ke4, min=1e-12),
                on=mask & (ke4 > 0), kd=kd4, don=mask & (kd4 > 0),
                linear=torch.tensor([True, True, False, False],
                                    device=dev)[:, None, None],
                sum=FixedOrderSum(self._jdst, B, dev))

    def sum_rows(self, rows, C: int, cb):
        """The joint rows' and (with C contact slots) the contact rows'
        sum into the bodies: one fixed-order table over both for the
        static pipeline's slots; the joints' table plus the contacts'
        per-call sum (``cb.sum``) for dynamic-pair Contacts."""
        if not (C and cb.dynamic):
            return self.sums(C)[1](torch.cat(rows))
        return self.sums(0)[1](rows[0]) + cb.sum(rows[1])

    def sums(self, C: int):
        """The fixed-order sums of a substep with C contact slots: (the
        contact rows' (2C: body1's, then body0's), the joint rows' then
        the contact rows' (2J + 2C)), each into the B bodies. Built once
        per C from the static pipeline's slots (``slot_shape0/1``), which
        ``CollisionPipeline(model)`` fills in that order; a static side
        drops its (zero) row."""
        s = self._sums.get(C)
        if s is None:
            cdst = slot_body_dst(self.st, C, "SolverXPBD")
            B = self.st.body_count
            s = (FixedOrderSum(cdst, B, self.dev),
                 FixedOrderSum(np.concatenate([self._jdst, cdst]), B,
                               self.dev))
            self._sums[C] = s
        return s

    # ------------------------------------------------------------------
    @staticmethod
    def inv_inertia_world(model: Model, q):
        """R I^-1 R^T of every body (B, 3, 3), by broadcast products."""
        R = quat_to_matrix(q)
        RI = (R[..., :, :, None] * model.body_inv_inertia[..., None, :, :]
              ).sum(-2)
        return (RI[..., :, None, :] * R[..., None, :, :]).sum(-1)

    def joint_forces_to_body_f(self, model: Model, state: State,
                               control: Control):
        """Body wrenches (B, 6) of the generalized forces of revolute
        (a torque about the world axis) and prismatic joints (a force
        along it at the anchor) on the child and, opposite, the parent."""
        f_out = torch.zeros_like(state.body_f)
        fj = self.f_joint
        if fj is None:
            return f_out
        tau = control.joint_f[fj.dof][:, None]
        X_wp = torch.where(fj.hasp, state.body_q[fj.parent], self.identity)
        X_pj = transform_multiply(X_wp, fj.X_p)
        force = quat_rotate(X_pj[:, 3:7], fj.axis) * tau
        com_c = transform_point(state.body_q[fj.child], fj.com_c)
        com_p = transform_point(X_wp, fj.com_p)
        f_c = torch.where(fj.rev, 0.0, force)
        t_c = torch.where(fj.rev, force, cross(X_pj[:, 0:3] - com_c, force))
        t_p = torch.where(fj.rev, -force,
                          cross(X_pj[:, 0:3] - com_p, -force))
        wrench_p = torch.cat([-f_c, t_p], -1) * fj.hasp
        return f_out + fj.sum(torch.cat([torch.cat([f_c, t_c], -1),
                                         wrench_p]))

    # ------------------------------------------------------------------
    def solve_joints(self, model: Model, x, q, Iinv, dt, lin_compliance,
                     ang_compliance, control):
        """Positional and angular corrections of every joint (free joints
        none; ball joints positional only; revolute axis alignment and
        limits; prismatic slide limits; fixed and prismatic rotation lock;
        target drives of revolute and prismatic joints with a stiffness).
        Returns the rows [dx | dtheta | count] (2J, 7): each joint's row
        for its child, then for its parent (``sums``' order)."""
        if self.J == 0:
            return x.new_zeros(0, 7)
        parent, child, hasp = self.parent, self.child, self.hasp
        p_origin = x - quat_rotate(q, model.body_com)
        pose = torch.cat([p_origin, q], -1)
        X_wp = torch.where(hasp, pose[parent], self.identity)
        X_pj = transform_multiply(X_wp, model.joint_X_p)
        X_cj = transform_multiply(pose[child], model.joint_X_c)
        im_p = torch.where(hasp[:, 0], model.body_inv_mass[parent], 0.0)
        im_c = model.body_inv_mass[child]
        Iinv_p = torch.where(hasp[:, :, None], Iinv[parent], 0.0)
        Iinv_c = Iinv[child]

        # positional: anchors coincide; a prismatic joint slides along its
        # world axis within its limits
        e = X_cj[:, 0:3] - X_pj[:, 0:3]
        a_p = quat_rotate(X_pj[:, 3:7], self.axis)
        s_along = (e * a_p).sum(-1)
        s_clamped = torch.minimum(torch.maximum(s_along, self.lo), self.hi)
        e_pris = e - a_p * s_along[:, None] \
            + a_p * (s_along - s_clamped)[:, None]
        e = torch.where(self.pris, e_pris, e)
        e = torch.where(self.free, 0.0, e)
        if self.cable is not None:
            # cables hold their anchors by the compliant rows below
            e = torch.where(self.cable.mask[:, None], 0.0, e)
        c = safe_norm(e)
        n = safe_normalize(e)
        r_p = X_pj[:, 0:3] - torch.where(hasp, x[parent], 0.0)
        r_c = X_cj[:, 0:3] - x[child]
        w_p = im_p + _quad(cross(r_p, n), Iinv_p)
        w_c = im_c + _quad(cross(r_c, n), Iinv_c)
        alpha = lin_compliance / (dt * dt)
        active = c > 1e-9
        imp = n * (c / torch.clamp(w_p + w_c + alpha, min=1e-9)
                   * active)[:, None]

        # angular: fixed and prismatic joints lock the rotation, revolute
        # joints align their axes and keep the twist within the limits
        q_rel = quat_mul(quat_conjugate(X_pj[:, 3:7]), X_cj[:, 3:7])
        q_rel = torch.where(q_rel[:, 3:4] < 0, -q_rel, q_rel)
        dO_lock = quat_rotate(X_pj[:, 3:7], 2.0 * q_rel[:, 0:3])
        a_c = quat_rotate(X_cj[:, 3:7], self.axis)
        twist = 2.0 * torch.atan2((q_rel[:, 0:3] * self.axis).sum(-1),
                                  q_rel[:, 3])
        t_clamped = torch.minimum(torch.maximum(twist, self.lo), self.hi)
        dO_rev = cross(a_p, a_c) + a_p * (twist - t_clamped)[:, None]
        dO = torch.where(self.lock, dO_lock,
                         torch.where(self.rev, dO_rev, 0.0))
        th = safe_norm(dO)
        n_a = safe_normalize(dO)
        wa = _quad(n_a, Iinv_p) + _quad(n_a, Iinv_c)
        alpha_a = ang_compliance / (dt * dt)
        active_a = th > 1e-9
        imp_a = n_a * (th / torch.clamp(wa + alpha_a, min=1e-9)
                       * active_a)[:, None]

        lin_c = -imp * im_c[:, None]
        lin_p = imp * im_p[:, None]
        tor_c = cross(r_c, imp) + imp_a
        tor_p = cross(r_p, imp) + imp_a
        cnt = active.to(x.dtype) + active_a.to(x.dtype)
        if self.cable is not None:
            # compliant stretch and shear (linear) and bend and twist
            # (angular) rows of the cables, the parent anchor's +Z the
            # material tangent, the four at once; their cables' point rows
            # carry none
            k = self.cable
            e_full = X_cj[:, 0:3] - X_pj[:, 0:3]
            t_p = quat_rotate(X_pj[:, 3:7], self.z_axis.expand_as(e_full))
            t_c = quat_rotate(X_cj[:, 3:7], self.z_axis.expand_as(e_full))
            e_ax = t_p * (e_full * t_p).sum(-1, keepdim=True)
            tw = 2.0 * torch.atan2(q_rel[:, 2], q_rel[:, 3])
            vec = torch.stack([e_ax, e_full - e_ax, cross(t_p, t_c),
                               safe_normalize(t_p + t_c) * tw[:, None]])
            c_ = safe_norm(vec)
            n_ = safe_normalize(vec)
            wsum = torch.where(
                k.linear[..., 0],
                im_p + _quad(cross(r_p, n_), Iinv_p) + im_c
                + _quad(cross(r_c, n_), Iinv_c),
                _quad(n_, Iinv_p) + _quad(n_, Iinv_c))
            act = k.on & (c_ > 1e-9)
            im_ = n_ * (c_ / torch.clamp(wsum + k.inv_ke / (dt * dt),
                                         min=1e-9) * act)[..., None]
            lin = torch.where(k.linear, im_, 0.0).sum(0)
            ang = torch.where(k.linear, 0.0, im_).sum(0)
            lin_c = lin_c - lin * im_c[:, None]
            lin_p = lin_p + lin * im_p[:, None]
            tor_c = tor_c + cross(r_c, lin) + ang
            tor_p = tor_p + cross(r_p, lin) + ang
            cnt = cnt + act.to(x.dtype).sum(0)
        if control is not None and self.has_drives:
            # drives toward joint_target_q with compliance 1 / ke
            tq = control.joint_target_q[self.coord0]
            ke = self.ke
            alpha_d = 1.0 / torch.clamp(ke, min=1e-9) / (dt * dt)
            err_rot = a_p * (twist - tq)[:, None]
            dlam_d = torch.where(self.rev[:, 0] & (ke > 0), safe_norm(err_rot)
                                 / torch.clamp(wa + alpha_d, min=1e-9), 0.0)
            imp_d = safe_normalize(err_rot) * dlam_d[:, None]
            tor_c = tor_c + imp_d
            tor_p = tor_p + imp_d
            err_lin = a_p * (s_along - tq)[:, None]
            dlam_p = torch.where(self.pris[:, 0] & (ke > 0), safe_norm(err_lin)
                                 / torch.clamp(w_p + w_c + alpha_d, min=1e-9),
                                 0.0)
            imp_p = safe_normalize(err_lin) * dlam_p[:, None]
            lin_c = lin_c - imp_p * im_c[:, None]
            lin_p = lin_p + imp_p * im_p[:, None]
        rows = torch.cat([
            torch.cat([lin_c, -_mv(Iinv_c, tor_c), cnt[:, None]], -1),
            torch.cat([lin_p, _mv(Iinv_p, tor_p), cnt[:, None] * hasp], -1)])
        return rows

    # ------------------------------------------------------------------
    def contact_bodies(self, model: Model, contacts: Contacts):
        """Per-slot bodies (0 where static), dynamic masks, friction and
        restitution, from the contacts' shape indices."""
        s0 = torch.clamp(contacts.rigid_contact_shape0.long(), min=0)
        s1 = torch.clamp(contacts.rigid_contact_shape1.long(), min=0)
        b0r, b1r = self.shape_body[s0], self.shape_body[s1]
        dyn0 = (contacts.rigid_contact_shape0 >= 0) & (b0r >= 0)
        dyn1 = (contacts.rigid_contact_shape1 >= 0) & (b1r >= 0)
        mu = model.shape_material_mu
        e = model.shape_material_restitution
        dynamic = getattr(contacts, "dynamic", False)
        if dynamic:
            # the slots' bodies change every call: the sum's order is
            # planned from this call's destinations, on the device
            csum = DynamicOrderSum(torch.cat([torch.where(dyn1, b1r, -1),
                                              torch.where(dyn0, b0r, -1)]),
                                   model.body_count)
        else:
            csum = self.sums(contacts.rigid_contact_max)[0]
        return SimpleNamespace(
            b0=torch.where(dyn0, b0r, 0), b1=torch.where(dyn1, b1r, 0),
            dyn0=dyn0[:, None], dyn1=dyn1[:, None], sum=csum,
            dynamic=dynamic,
            mu=0.5 * (mu[s0] + mu[s1]), e=0.5 * (e[s0] + e[s1]))

    def contact_local_anchors(self, model: Model, state_in: State,
                              contacts: Contacts, cb):
        """Each shape's deepest point in its body's collide-time COM frame
        (a static shape's: the world point), so that penetration is measured
        again at every iteration's poses."""
        x_in = state_in.body_q[:, 0:3] + quat_rotate(state_in.body_q[:, 3:7],
                                                     model.body_com)
        q_in = state_in.body_q[:, 3:7]
        n = contacts.rigid_contact_normal
        p = contacts.rigid_contact_position
        half = n * (0.5 * contacts.rigid_contact_depth)[:, None]
        p0, p1 = p + half, p - half
        l0 = torch.where(cb.dyn0, quat_rotate_inv(q_in[cb.b0],
                                                  p0 - x_in[cb.b0]), p0)
        l1 = torch.where(cb.dyn1, quat_rotate_inv(q_in[cb.b1],
                                                  p1 - x_in[cb.b1]), p1)
        return l0, l1

    def solve_rigid_contacts(self, model: Model, x, q, Iinv,
                             contacts: Contacts, cb, lam_n, dt,
                             max_depen_vel=3.0, stiff=None, gamma_relax=1.0,
                             denom_prev=None):
        """Non-penetration and positional (static) friction corrections of
        every slot, penetration measured at the current poses from the
        collide-time anchors; the push-out is capped at max_depen_vel dt.
        A slot with stiffness c > 0 (``stiff`` (C,)) is a compliant row,
        alpha = gamma / (c dt^2), gamma the realized share of a correction:
        gamma_relax (w0 / n0 + w1 / n1) / (w0 + w1), n the bodies' counts of
        the previous iteration (``denom_prev``).
        Returns the rows [dx | dtheta | count] (2C, 7) (each slot's row
        for body1, then body0) and the accumulated normal impulses."""
        b0, b1, dyn0, dyn1 = cb.b0, cb.b1, cb.dyn0, cb.dyn1
        inv_m = model.body_inv_mass
        im0 = torch.where(dyn0[:, 0], inv_m[b0], 0.0)
        im1 = torch.where(dyn1[:, 0], inv_m[b1], 0.0)
        I0 = torch.where(dyn0[:, :, None], Iinv[b0], 0.0)
        I1 = torch.where(dyn1[:, :, None], Iinv[b1], 0.0)
        n = contacts.rigid_contact_normal
        l0, l1 = cb.anchors
        a0 = torch.where(dyn0, x[b0] + quat_rotate(q[b0], l0), l0)
        a1 = torch.where(dyn1, x[b1] + quat_rotate(q[b1], l1), l1)
        depth = -((a1 - a0) * n).sum(-1)
        active = contacts.rigid_contact_mask & (depth > 0.0)
        depth = torch.clamp(depth, max=max_depen_vel * dt)
        r0 = a0 - x[b0]
        r1 = a1 - x[b1]
        if stiff is None:
            w = im0 + _quad(cross(r0, n), I0) + im1 + _quad(cross(r1, n), I1)
            dlam = torch.where(active, depth / torch.clamp(w, min=1e-9), 0.0)
        else:
            w0 = im0 + _quad(cross(r0, n), I0)
            w1 = im1 + _quad(cross(r1, n), I1)
            d0 = torch.clamp(denom_prev[b0], min=1.0)
            d1 = torch.clamp(denom_prev[b1], min=1.0)
            gamma = gamma_relax * torch.where(
                w0 + w1 > 0.0, (w0 / d0 + w1 / d1)
                / torch.clamp(w0 + w1, min=1e-12), 1.0)
            soft = stiff > 0.0
            alpha = torch.where(soft, gamma / (torch.where(soft, stiff, 1.0)
                                               * dt * dt), 0.0)
            dlam = torch.where(active, (depth - alpha * lam_n)
                               / torch.clamp(w0 + w1 + alpha, min=1e-9), 0.0)
        # a compliant slot may push but not pull
        dlam = torch.maximum(dlam, -lam_n)
        lam_n = lam_n + dlam
        # static friction: cancel the anchors' tangential drift within the
        # mu lambda_n cone
        t_err = a1 - a0
        t_err = t_err - n * (t_err * n).sum(-1, keepdim=True)
        t_len = safe_norm(t_err)
        t_dir = safe_normalize(t_err)
        wt = (im0 + _quad(cross(r0, t_dir), I0) + im1
              + _quad(cross(r1, t_dir), I1))
        dlam_t = torch.where(active & (t_len > 1e-9),
                             t_len / torch.clamp(wt, min=1e-9), 0.0)
        dlam_t = torch.minimum(dlam_t, cb.mu * lam_n)
        imp = n * dlam[:, None] - t_dir * dlam_t[:, None]
        act = active.to(x.dtype)[:, None]
        rows = torch.cat([
            torch.cat([imp * im1[:, None], _mv(I1, cross(r1, imp)),
                       act * dyn1], -1),
            torch.cat([-imp * im0[:, None], -_mv(I0, cross(r0, imp)),
                       act * dyn0], -1)])
        return rows, lam_n

    # ------------------------------------------------------------------
    def velocity_plan(self, model: Model, x, q, state_in: State,
                      contacts: Contacts, cb, lam_n, dt, enable_restitution):
        """What the four velocity passes of a substep share: the slots'
        arms, generalized inverse masses, active masks and averaging
        divisors, and the pre-step normal velocities for restitution."""
        b0, b1, dyn0, dyn1 = cb.b0, cb.b1, cb.dyn0, cb.dyn1
        Iinv = self.inv_inertia_world(model, q)
        inv_m = model.body_inv_mass
        vp = SimpleNamespace(cb=cb, restitution=enable_restitution)
        vp.im0 = torch.where(dyn0[:, 0], inv_m[b0], 0.0)
        vp.im1 = torch.where(dyn1[:, 0], inv_m[b1], 0.0)
        vp.I0 = torch.where(dyn0[:, :, None], Iinv[b0], 0.0)
        vp.I1 = torch.where(dyn1[:, :, None], Iinv[b1], 0.0)
        n = contacts.rigid_contact_normal
        p = contacts.rigid_contact_position
        vp.r0, vp.r1 = p - x[b0], p - x[b1]
        vp.w_n = (vp.im0 + _quad(cross(vp.r0, n), vp.I0) + vp.im1
                  + _quad(cross(vp.r1, n), vp.I1))
        vp.active = contacts.rigid_contact_mask & (lam_n > 0.0)
        vp.f_cap = cb.mu * lam_n / dt
        act = vp.active.to(x.dtype)
        vp.div = self._divisor(act, cb)
        if enable_restitution:
            x_in = state_in.body_q[:, 0:3] + quat_rotate(
                state_in.body_q[:, 3:7], model.body_com)
            qd_in = state_in.body_qd
            g_dt = self.gravity * dt

            def v_in(b, dyn):
                return torch.where(dyn, qd_in[b, 0:3] + g_dt[b] + cross(
                    qd_in[b, 3:6], p - x_in[b]), 0.0)
            vn_old = ((v_in(b1, dyn1) - v_in(b0, dyn0)) * n).sum(-1)
            vp.vn_old = vn_old
            vp.vn_target = torch.clamp(-cb.e * vn_old, min=0.0)
            vp.approach = vp.active & (vn_old < 0.0)
            # separating speed gained from resolving the overlap that
            # existed at the substep's start is bias, removed up to d0/dt
            vp.bias_cap = torch.clamp(contacts.rigid_contact_depth,
                                      min=0.0) / dt
            # compliant slots keep their settled penetration: no bias
            # removal there
            stiff = contacts.rigid_contact_stiffness
            vp.rigid = None if stiff is None else stiff <= 0.0
            vp.vn_old_pos = torch.clamp(vn_old, min=0.0)
        return vp

    @staticmethod
    def _divisor(act, cb):
        """Each slot's averaging divisor: the larger active-slot count of
        its two dynamic bodies, at least 1."""
        d0, d1 = cb.dyn0[:, 0].to(act.dtype), cb.dyn1[:, 0].to(act.dtype)
        cnt = cb.sum(torch.cat([act * d1, act * d0]))
        return torch.clamp(torch.maximum(cnt[cb.b1] * d1, cnt[cb.b0] * d0),
                           min=1.0)

    def velocity_pass(self, vp, v, w, contacts: Contacts, dt, dahl_f=None,
                      dahl_sigma=0.0):
        """Velocity-level friction, restitution against the pre-step
        normal velocity and depenetration-bias removal at the active
        contacts, averaged over each body's active slots. Coulomb friction
        cancels the slip within the mu lambda_n / dt cone; with ``dahl_f``
        (C, 3) the bristle force integrates this step's slip, clamped to
        the cone, and acts as an impulse that cannot reverse the slip.
        Returns (v, w, the new bristle state or None)."""
        cb = vp.cb
        b0, b1, dyn0, dyn1 = cb.b0, cb.b1, cb.dyn0, cb.dyn1
        n = contacts.rigid_contact_normal
        v0 = torch.where(dyn0, v[b0] + cross(w[b0], vp.r0), 0.0)
        v1 = torch.where(dyn1, v[b1] + cross(w[b1], vp.r1), 0.0)
        v_rel = v1 - v0
        vn = (v_rel * n).sum(-1)
        vt = v_rel - n * vn[:, None]
        vt_norm = safe_norm(vt)
        t_dir = safe_normalize(vt)
        w_t = (vp.im0 + _quad(cross(vp.r0, t_dir), vp.I0) + vp.im1
               + _quad(cross(vp.r1, t_dir), vp.I1))
        w_t = torch.clamp(w_t, min=1e-9)
        dahl_new = None
        if dahl_f is not None:
            f_c = vp.f_cap
            f_par = (dahl_f * t_dir).sum(-1)
            df = dahl_sigma * (vt_norm * dt) * (
                1.0 - f_par / torch.clamp(f_c, min=1e-9))
            f_new = dahl_f + t_dir * df[:, None]
            f_mag = safe_norm(f_new)
            f_new = f_new * (torch.minimum(f_mag, f_c)
                             / torch.clamp(f_mag, min=1e-9))[:, None]
            f_new = torch.where(vp.active[:, None], f_new, 0.0)
            imp_mag = torch.minimum(safe_norm(f_new) * dt, vt_norm / w_t)
            imp = -safe_normalize(f_new) * torch.where(
                vp.active, imp_mag, 0.0)[:, None]
            dahl_new = f_new
        else:
            dv_t = torch.minimum(vt_norm, vp.f_cap * w_t)
            imp = -t_dir * torch.where(vp.active & (vt_norm > 1e-9),
                                       dv_t / w_t, 0.0)[:, None]
        imp = imp / vp.div[:, None]
        if vp.restitution:
            excess = torch.minimum(torch.clamp(vn - vp.vn_old_pos, min=0.0),
                                   vp.bias_cap)
            bias = vp.active & (excess > 0.0)
            if vp.rigid is not None:
                bias = bias & vp.rigid
            dvn = torch.where(vp.approach, vp.vn_target - vn,
                              torch.where(bias, -excess, 0.0))
            rest = vp.approach | bias
            div_r = self._divisor(rest.to(v.dtype), cb)
            imp = imp + n * torch.where(
                rest, dvn / torch.clamp(vp.w_n, min=1e-9) / div_r,
                0.0)[:, None]
        rows = torch.cat([
            torch.cat([imp * (vp.im1 * dyn1[:, 0])[:, None],
                       _mv(vp.I1, cross(vp.r1, imp)) * dyn1], -1),
            torch.cat([-imp * (vp.im0 * dyn0[:, 0])[:, None],
                       -_mv(vp.I0, cross(vp.r0, imp)) * dyn0], -1)])
        acc = cb.sum(rows)
        return v + acc[:, 0:3], w + acc[:, 3:6], dahl_new

    def cable_velocity_pass(self, model: Model, x, q, v, w, dt):
        """The cables' implicit damping on the rebuilt velocities: the
        relative anchor velocity along the tangent (stretch) and across it
        (shear), the relative angular velocity about it (twist) and across
        it (bend), each reduced by kd dt / (1 + kd dt w) with its
        generalized inverse mass w, summed per body in a fixed order."""
        k = self.cable
        parent, child, hasp = self.parent, self.child, self.hasp
        pose = torch.cat([x - quat_rotate(q, model.body_com), q], -1)
        X_wp = torch.where(hasp, pose[parent], self.identity)
        X_pj = transform_multiply(X_wp, model.joint_X_p)
        X_cj = transform_multiply(pose[child], model.joint_X_c)
        t_p = quat_rotate(X_pj[:, 3:7], self.z_axis.expand_as(X_pj[:, 0:3]))
        r_p = X_pj[:, 0:3] - x[parent]
        r_c = X_cj[:, 0:3] - x[child]
        v_p = torch.where(hasp, v[parent] + cross(w[parent], r_p), 0.0)
        v_rel = v[child] + cross(w[child], r_c) - v_p
        w_rel = w[child] - torch.where(hasp, w[parent], 0.0)
        Iinv = self.inv_inertia_world(model, q)
        im_p = torch.where(hasp[:, 0], model.body_inv_mass[parent], 0.0)
        im_c = model.body_inv_mass[child]
        Iinv_p = torch.where(hasp[:, :, None], Iinv[parent], 0.0)
        Iinv_c = Iinv[child]
        v_ax = t_p * (v_rel * t_p).sum(-1, keepdim=True)
        w_ax = t_p * (w_rel * t_p).sum(-1, keepdim=True)
        vec = torch.stack([v_ax, v_rel - v_ax, w_ax, w_rel - w_ax])
        c_ = safe_norm(vec)
        n_ = safe_normalize(vec)
        wsum = torch.where(
            k.linear[..., 0],
            im_p + _quad(cross(r_p, n_), Iinv_p) + im_c
            + _quad(cross(r_c, n_), Iinv_c),
            _quad(n_, Iinv_p) + _quad(n_, Iinv_c))
        g = k.kd * dt
        lam = g * c_ / torch.clamp(1.0 + g * wsum, min=1e-9)
        imp = -n_ * (lam * k.don)[..., None]
        lin = torch.where(k.linear, imp, 0.0).sum(0)
        ang = torch.where(k.linear, 0.0, imp).sum(0)
        lin_c, lin_p = lin * im_c[:, None], -lin * im_p[:, None]
        tor_c = cross(r_c, lin) + ang
        tor_p = -(cross(r_p, lin) + ang)
        acc = k.sum(torch.cat([torch.cat([lin_c, _mv(Iinv_c, tor_c)], -1),
                               torch.cat([lin_p, _mv(Iinv_p, tor_p)], -1)]))
        return (v + acc[:, 0:3] * self.dynamic,
                w + acc[:, 3:6] * self.dynamic)


class _ParticlePlan:
    """The particle side of the substep, built once: the distance rows
    (springs, the three edges of every triangle, the six edges of every
    tetrahedron) with their rest lengths and compliances, the tetrahedra's
    volume rows, one fixed-order sum of all their corrections into the
    particles, the static Jacobi degree, the soft-contact slots' particles
    and friction, and the hash grid of the particle-particle contacts."""

    def __init__(self, model: Model, solver: "SolverXPBD"):
        st = model.structure
        dev = model.device
        N = st.particle_count
        self.gravity = particle_gravity(model)
        self.active = (model.particle_inv_mass > 0)[:, None]
        q0 = model.particle_q

        def idx(t):
            return t.detach().cpu().numpy().astype(np.int64)
        i_, j_, rest, comp = [], [], [], []
        deg = np.zeros(N, dtype=np.float32)
        if st.spring_count:
            si = idx(model.spring_indices)
            i_.append(si[:, 0])
            j_.append(si[:, 1])
            rest.append(model.spring_rest_length)
            comp.append(1.0 / torch.clamp(model.spring_stiffness, min=1e-9))
            np.add.at(deg, si.reshape(-1), 1.0)
        if st.tri_count:
            # the membrane as the distance rows of the edges at rest
            ti = idx(model.tri_indices)
            c = 1.0 / torch.clamp(model.tri_materials[:, 0], min=1e-9)
            for a, b in ((0, 1), (1, 2), (2, 0)):
                i_.append(ti[:, a])
                j_.append(ti[:, b])
                rest.append(torch.linalg.vector_norm(
                    q0[ti[:, b]] - q0[ti[:, a]], dim=-1))
                comp.append(c)
            np.add.at(deg, ti.reshape(-1), 2.0)
        self.tets = None
        if st.tet_count:
            tt = idx(model.tet_indices)
            c = 1.0 / torch.clamp(model.tet_materials[:, 0], min=1e-9)
            for a, b in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
                i_.append(tt[:, a])
                j_.append(tt[:, b])
                rest.append(torch.linalg.vector_norm(
                    q0[tt[:, b]] - q0[tt[:, a]], dim=-1))
                comp.append(c)
            np.add.at(deg, tt.reshape(-1), 4.0)
            T = torch.as_tensor(tt, device=dev)
            p0, p1, p2, p3 = (q0[T[:, k]] for k in range(4))
            self.tets = SimpleNamespace(
                idx=T.unbind(1), vol0=(cross(p1 - p0, p2 - p0)
                                       * (p3 - p0)).sum(-1) / 6.0,
                k_lambda=torch.clamp(model.tet_materials[:, 1], min=1e-9))
        self.dist = None
        dst = []
        if i_:
            I = np.concatenate(i_)
            Jx = np.concatenate(j_)
            self.dist = SimpleNamespace(
                i=torch.as_tensor(I, device=dev),
                j=torch.as_tensor(Jx, device=dev),
                rest=torch.cat(rest), comp=torch.cat(comp))
            dst += [I, Jx]
        if self.tets is not None:
            dst += [tt[:, k] for k in range(4)]
        self.sum = (FixedOrderSum(np.concatenate(dst), N, dev) if dst
                    else None)
        # each particle's structural constraint count, plus its contact
        self.degree = torch.as_tensor(np.maximum(deg + 1.0, 1.0),
                                      device=dev)[:, None]
        # particle-shape contacts: the static pipeline's soft slots
        sp = np.asarray(st.soft_pairs, dtype=np.int64).reshape(-1, 2)
        self.soft = None
        if len(sp):
            pi = torch.as_tensor(sp[:, 0], device=dev)
            si = torch.as_tensor(sp[:, 1], device=dev)
            self.soft = SimpleNamespace(
                particle=pi, radius=model.particle_radius[pi],
                mu=0.5 * (model.shape_material_mu[si] + model.particle_mu),
                body=torch.as_tensor(np.maximum(
                    np.asarray(st.shape_body)[sp[:, 1]], 0), device=dev),
                on_body=torch.as_tensor(
                    np.asarray(st.shape_body)[sp[:, 1]] >= 0,
                    device=dev)[:, None],
                movable=self.active[pi],
                sum=soft_contact_sum(st, N, dev))
        # particle-particle contacts: a hash grid of cell 2 r_max
        self.grid = None
        if N > 1 and solver.enable_particle_particle:
            r_max = float(model.particle_radius.max())
            if r_max > 0:
                self.grid = HashGrid(cell_size=2.0 * r_max,
                                     max_per_cell=solver.particle_max_per_cell)
                self.query_radius = 2.0 * r_max

    def soft_frame(self, model: Model, state_in: State, contacts: Contacts,
                   dt: float):
        """What every iteration's soft-contact rows share: each slot's
        particle position when the contact was found, and the shape
        surface's displacement over the substep there (v + w x r of the
        shape's body: a moving belt or a roller drags the particle)."""
        sc = self.soft
        n = contacts.soft_contact_normal
        depth0 = contacts.soft_contact_depth
        p_then = contacts.soft_contact_position + n * (sc.radius
                                                       - depth0)[:, None]
        surf = None
        if model.body_count:
            bq = state_in.body_q[sc.body]
            qd = state_in.body_qd[sc.body]
            com = bq[:, 0:3] + quat_rotate(bq[:, 3:7], model.body_com[sc.body])
            v = qd[:, 0:3] + cross(qd[:, 3:6],
                                   contacts.soft_contact_position - com)
            surf = torch.where(sc.on_body, v, 0.0) * dt
        return SimpleNamespace(n=n, depth0=depth0, p_then=p_then, surf=surf,
                               mask=contacts.soft_contact_mask)

    def solve(self, model: Model, px, px_prev, dt, nbr=None, soft=None):
        """One sweep of the particle rows at positions ``px``: the
        structural corrections (N, 3), the contact corrections (N, 3) and
        each particle's active-contact count (N,)."""
        inv_m = model.particle_inv_mass
        terms = []
        if self.dist is not None:
            k = self.dist
            d = px[k.j] - px[k.i]
            c = safe_norm(d) - k.rest
            dlam = c / torch.clamp(inv_m[k.i] + inv_m[k.j]
                                   + k.comp / (dt * dt), min=1e-9)
            imp = safe_normalize(d) * dlam[:, None]
            terms += [imp * inv_m[k.i][:, None], -imp * inv_m[k.j][:, None]]
        if self.tets is not None:
            a, b, c_, d_ = self.tets.idx
            p0, p1, p2, p3 = px[a], px[b], px[c_], px[d_]
            vol = (cross(p1 - p0, p2 - p0) * (p3 - p0)).sum(-1) / 6.0
            g1 = cross(p2 - p0, p3 - p0) / 6.0
            g2 = cross(p3 - p0, p1 - p0) / 6.0
            g3 = cross(p1 - p0, p2 - p0) / 6.0
            g0 = -(g1 + g2 + g3)
            wsum = (inv_m[a] * (g0 * g0).sum(-1) + inv_m[b] * (g1 * g1).sum(-1)
                    + inv_m[c_] * (g2 * g2).sum(-1)
                    + inv_m[d_] * (g3 * g3).sum(-1))
            comp = 1.0 / self.tets.k_lambda / (dt * dt)
            dlam = -(vol - self.tets.vol0) / torch.clamp(wsum + comp,
                                                         min=1e-9)
            terms += [g * (dlam * inv_m[v])[:, None]
                      for g, v in ((g0, a), (g1, b), (g2, c_), (g3, d_))]
        dx = (self.sum(torch.cat(terms)) if terms
              else torch.zeros_like(px))
        dxc = torch.zeros_like(px)
        ncon = torch.zeros_like(px[:, 0])
        if nbr is not None:
            # each particle pushes itself out of its overlapping neighbours
            # (the symmetric half of each pair: a sum over its candidates)
            idx, nmask = nbr
            d = px[idx] - px[:, None, :]
            r = model.particle_radius
            overlap = r[:, None] + r[idx] - safe_norm(d)
            act = nmask & (overlap > 0)
            dlam = torch.where(act, overlap / torch.clamp(
                inv_m[:, None] + inv_m[idx], min=1e-9), 0.0)
            dxc = dxc - (safe_normalize(d)
                         * (dlam * inv_m[:, None])[..., None]).sum(1)
            ncon = ncon + act.to(px.dtype).sum(1)
        if soft is not None:
            # one-sided rows against the shapes, the whole correction on
            # the particle, with position-level Coulomb friction against
            # the surface's motion, clamped to mu times the correction
            sc = self.soft
            p = px[sc.particle]
            c = soft.depth0 - ((p - soft.p_then) * soft.n).sum(-1)
            act = soft.mask & (c > 0)
            cc = torch.where(act, c, 0.0)
            slip = p - px_prev[sc.particle]
            if soft.surf is not None:
                slip = slip - soft.surf
            slip_t = slip - soft.n * (slip * soft.n).sum(-1, keepdim=True)
            corr = soft.n * cc[:, None] - slip_t * torch.clamp(
                sc.mu * cc / torch.clamp(safe_norm(slip_t), min=1e-9),
                max=1.0)[:, None]
            acc = sc.sum(torch.cat([corr * sc.movable,
                                    act.to(px.dtype)[:, None]], -1))
            dxc = dxc + acc[:, 0:3]
            ncon = ncon + acc[:, 3]
        return dx, dxc, ncon
