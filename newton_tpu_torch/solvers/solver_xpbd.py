"""XPBD solver, rigid-body path (port of ``newton_tpu/solvers/solver_xpbd.py``).

Extended position-based dynamics for rigid bodies: each substep predicts
the bodies with semi-implicit Euler, runs ``iterations`` Jacobi sweeps of
positional joint and contact corrections (each body's corrections averaged
over its active constraints), rebuilds the velocities from the positions,
and applies four velocity passes at the contacts (Coulomb friction,
restitution and the removal of depenetration bias); generalized
coordinates follow through ``eval_ik``. ``step`` takes the flat State of any
model: every world of a replicated model at once, since worlds share no
joint or contact.

The JAX package sums the corrections with ``segment_sum``; here every such
sum is a ``FixedOrderSum`` over tables built once from the joint list and
the static pipeline's contact slots, so two runs of a substep are equal bit
for bit on the card (``index_add_`` would add in no fixed order).
Particles, cables, hydroelastic (compliant) contacts, soft contacts and
Dahl friction are not ported and raise.
"""

from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..core.segment_sum import FixedOrderSum, check_static_slots
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
from .solver import SolverBase, body_gravity, integrate_bodies

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
        max_depenetration_velocity: cap of the positional push-out rate.
    ``enable_particle_particle``, ``friction_epsilon``, ``dahl_sigma`` and
    ``particle_max_per_cell`` are accepted for the reference's signature;
    ``friction_model="dahl"`` raises (not ported).
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
        if friction_model == "dahl":
            raise NotImplementedError(
                "SolverXPBD friction_model='dahl' (bristle friction) is not "
                "ported yet")
        if model.particle_count:
            raise NotImplementedError(
                "SolverXPBD particles (solve_particles, the hash grid) are "
                "not ported yet")
        if (np.asarray(model.structure.joint_type) == int(JointType.CABLE)
                ).any():
            raise NotImplementedError(
                "SolverXPBD cable joints (cable_velocity_pass) are not "
                "ported yet")
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
        self._plan = _XPBDPlan(model)
        self._last_lam_n = None

    def notify_model_changed(self, flags: int = 0):
        """Re-read the model's tensors after an edit (gravity, drive gains,
        limits, masses, friction): the plan's per-joint and per-body
        constants are gathered again. ``flags`` is ignored."""
        self._plan = _XPBDPlan(self.model)

    # ------------------------------------------------------------------
    def step(self, state_in: State, state_out: Optional[State] = None,
             control: Optional[Control] = None,
             contacts: Optional[Contacts] = None, dt: float = 1e-3) -> State:
        """One substep of a flat State; returns the new State (``state_out``
        is not written). Its ``body_f`` is ``state_in``'s: the joint
        forces' wrenches act inside the substep only."""
        model, plan = self.model, self._plan
        B = model.body_count
        if B == 0:
            return state_in
        _check_contacts(contacts)
        C = contacts.rigid_contact_max if contacts is not None else 0
        state = state_in
        # 1. generalized joint forces -> body wrenches
        if control is not None and model.structure.joint_dof_count:
            state = replace(state, body_f=state.body_f
                            + plan.joint_forces_to_body_f(model, state,
                                                          control))
        # 2. prediction
        body_q_pred, body_qd_pred = integrate_bodies(
            model, state, dt, self.angular_damping, gravity=plan.gravity)
        x_prev = state.body_q[:, 0:3] + quat_rotate(state.body_q[:, 3:7],
                                                    model.body_com)
        q_prev = state.body_q[:, 3:7]
        x = body_q_pred[:, 0:3] + quat_rotate(body_q_pred[:, 3:7],
                                              model.body_com)
        q = body_q_pred[:, 3:7]

        cb = None
        lam_n = torch.zeros(C, dtype=x.dtype, device=x.device)
        if C:
            check_static_slots(contacts, model.structure, rigid=True)
            cb = plan.contact_bodies(model, contacts)
            cb.anchors = plan.contact_local_anchors(model, state_in,
                                                    contacts, cb)
        # 3. positional iterations: averaged Jacobi over all constraints
        contact_scale = self.rigid_contact_relaxation / self.relaxation
        for _ in range(self.iterations):
            Iinv = plan.inv_inertia_world(model, q)
            rows = [plan.solve_joints(
                model, x, q, Iinv, dt, self.joint_linear_compliance,
                self.joint_angular_compliance, control)]
            if C:
                vals, lam_n = plan.solve_rigid_contacts(
                    model, x, q, Iinv, contacts, cb, lam_n, dt,
                    self.max_depenetration_velocity)
                vals = torch.cat([vals[:, 0:6] * contact_scale,
                                  vals[:, 6:7]], -1)
                rows.append(vals)
            acc = plan.sums(C)[1](torch.cat(rows))
            denom = torch.clamp(acc[:, 6:7], min=1.0)
            x = x + self.relaxation * acc[:, 0:3] / denom
            dq = quat_mul(torch.cat([acc[:, 3:6] / denom,
                                     torch.zeros_like(denom)], -1), q)
            q = quat_normalize(q + 0.5 * self.relaxation * dq)

        # 4. velocities from the positions; bodies without mass keep the
        # integrator's
        v = (x - x_prev) / dt
        dq_rel = quat_mul(q, quat_conjugate(q_prev))
        w = 2.0 / dt * dq_rel[:, 0:3]
        w = torch.where(dq_rel[:, 3:4] < 0.0, -w, w)
        dyn = plan.dynamic
        v = torch.where(dyn, v, body_qd_pred[:, 0:3])
        w = torch.where(dyn, w, body_qd_pred[:, 3:6])

        # 5. contact velocity passes: one, then three more to converge the
        # averaged-Jacobi projection of coupled slip
        if C:
            vp = plan.velocity_plan(model, x, q, state_in, contacts, cb,
                                    lam_n, dt, self.enable_restitution)
            for _ in range(4):
                v, w = plan.velocity_pass(vp, v, w, contacts, dt)

        body_q = torch.cat([x - quat_rotate(q, model.body_com), q], -1)
        out = replace(state_in, body_q=body_q,
                      body_qd=torch.cat([v, w], -1))
        if model.structure.joint_count:
            jq, jqd = eval_ik(model, out)
            out = replace(out, joint_q=jq, joint_qd=jqd)
        self._last_lam_n = lam_n
        return out

    def step_with_contacts(self, state_in, state_out, control, contacts, dt):
        """``step`` and the contact force report from the accumulated normal
        impulses: f = rigid_contact_relaxation lambda / dt^2 along the
        normal (the JAX package's ``step_with_contacts``)."""
        out = self.step(state_in, state_out, control, contacts, dt)
        if contacts is None or contacts.rigid_contact_max == 0:
            return out, contacts
        fmag = self.rigid_contact_relaxation * self._last_lam_n / (dt * dt)
        return out, replace(contacts, rigid_contact_force=(
            contacts.rigid_contact_normal * fmag[:, None]))

    def update_contacts(self, contacts, state_in, state_out, dt):
        _, c2 = self.step_with_contacts(state_in, None, None, contacts, dt)
        return c2


def _check_contacts(contacts):
    """Contacts the rigid path cannot honour raise, naming what they carry."""
    if contacts is None:
        return
    if contacts.rigid_contact_mask.dim() != 1:
        raise ValueError("SolverXPBD.step takes the flat (C,) Contacts of a "
                         "flat State")
    if getattr(contacts, "rigid_contact_stiffness", None) is not None:
        raise NotImplementedError(
            "SolverXPBD hydroelastic (compliant) contact stiffness is not "
            "ported yet")
    if getattr(contacts, "soft_contact_max", 0):
        raise NotImplementedError(
            "SolverXPBD soft (particle-shape) contacts are not ported yet")


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

    def sums(self, C: int):
        """The fixed-order sums of a substep with C contact slots: (the
        contact rows' (2C: body1's, then body0's), the joint rows' then
        the contact rows' (2J + 2C)), each into the B bodies. Built once
        per C from the static pipeline's slots (``slot_shape0/1``), which
        ``CollisionPipeline(model)`` fills in that order; a static side
        drops its (zero) row."""
        s = self._sums.get(C)
        if s is None:
            st = self.st
            S = len(np.asarray(st.slot_shape0))
            if C and C != S:
                raise ValueError(
                    f"SolverXPBD sums the {S} contact slots of the model's "
                    f"static pipeline (CollisionPipeline(model)); got {C}")
            sb = np.asarray(st.shape_body, dtype=np.int64)

            def body(shape):
                shape = np.asarray(shape, dtype=np.int64)
                return np.where(shape >= 0, sb[np.maximum(shape, 0)], -1)
            cdst = (np.concatenate([body(st.slot_shape1),
                                    body(st.slot_shape0)]) if C
                    else np.zeros(0, np.int64))
            B = st.body_count
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
        cnt = active.to(x.dtype) + active_a.to(x.dtype)
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
        return SimpleNamespace(
            b0=torch.where(dyn0, b0r, 0), b1=torch.where(dyn1, b1r, 0),
            dyn0=dyn0[:, None], dyn1=dyn1[:, None],
            sum=self.sums(contacts.rigid_contact_max)[0],
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
                             max_depen_vel=3.0):
        """Non-penetration and positional (static) friction corrections of
        every slot, penetration measured at the current poses from the
        collide-time anchors; the push-out is capped at max_depen_vel dt.
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
        w = im0 + _quad(cross(r0, n), I0) + im1 + _quad(cross(r1, n), I1)
        dlam = torch.where(active, depth / torch.clamp(w, min=1e-9), 0.0)
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

    def velocity_pass(self, vp, v, w, contacts: Contacts, dt):
        """Velocity-level Coulomb friction, restitution against the
        pre-step normal velocity and depenetration-bias removal at the
        active contacts, averaged over each body's active slots."""
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
        dv_t = torch.minimum(vt_norm, vp.f_cap * w_t)
        imp = -t_dir * torch.where(vp.active & (vt_norm > 1e-9),
                                   dv_t / w_t, 0.0)[:, None]
        imp = imp / vp.div[:, None]
        if vp.restitution:
            excess = torch.minimum(torch.clamp(vn - vp.vn_old_pos, min=0.0),
                                   vp.bias_cap)
            bias = vp.active & (excess > 0.0)
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
        return v + acc[:, 0:3], w + acc[:, 3:6]
