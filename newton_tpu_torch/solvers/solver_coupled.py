"""Coupled solver: two solvers co-simulating one Model (port of
``newton_tpu/solvers/solver_coupled.py``).

Two modes, as the JAX package has them:

- **Rigid and particle solvers** (``particle_solver``): the rigid solver
  steps the bodies and joints, the particle solver the particles, and the
  two meet at the shared soft contacts of the static pipeline. Before the
  rigid step the bodies take the equal-and-opposite penalty wrench of the
  particles' contacts (``coupling_ke``, ``coupling_kd``) plus the wrench of
  a dual normal impulse ``lam`` per soft slot; ``consensus_iters`` rounds
  of dual ascent (``rho``) drive the contacts' remaining approach velocity
  to zero, each round's RMS residual reported in
  ``State.custom["coupled:residuals"]`` when ``init_state`` allocated it.
- **Body partition** (``body_partition`` with ``second_rigid_solver``):
  ``rigid_solver`` owns the True bodies (and the coordinates of the
  joints whose child they are), ``second_rigid_solver`` the rest. Each
  solver steps the whole flat State with the partner's bodies standing in
  as proxies at their latest poses, the two results merge by the masks,
  and the exchange repeats ``consensus_iters`` times from the same start;
  a ``particle_solver`` then steps the particles last.

The per-body wrench sums are one ``FixedOrderSum`` over the soft slots'
bodies (slots on the world drop out), so two runs of a substep are equal
bit for bit on the card.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..core.segment_sum import FixedOrderSum, check_static_slots
from ..math import cross, quat_rotate
from ..sim.contacts import Contacts
from ..sim.control import Control
from ..sim.model import Model
from ..sim.state import State
from .solver import SolverBase

__all__ = ["SolverCoupled"]


class SolverCoupled(SolverBase):
    """Two-way co-simulation of two solvers over one Model (the JAX
    package's constructor, defaults and errors).

    Args:
        rigid_solver: steps the bodies and joints (e.g. SolverMuJoCo,
            SolverXPBD, SolverVBD).
        particle_solver: steps the particles (e.g. SolverVBD,
            SolverStyle3D, SolverXPBD).
        coupling_ke / coupling_kd: penalty gains of the reaction wrench.
        consensus_iters: rounds of the consensus (or of the partitioned
            exchange) per step.
        rho: dual ascent step of the consensus impulse.
        second_rigid_solver / body_partition: the body partition, (B,)
            bool, True for ``rigid_solver``'s bodies.
    """

    def __init__(self, model: Model, rigid_solver: SolverBase,
                 particle_solver: Optional[SolverBase] = None,
                 coupling_ke: float = 1.0e4, coupling_kd: float = 50.0,
                 consensus_iters: int = 3, rho: float = 0.6,
                 second_rigid_solver: Optional[SolverBase] = None,
                 body_partition=None):
        super().__init__(model)
        self.rigid_solver = rigid_solver
        self.particle_solver = particle_solver
        self.coupling_ke = float(coupling_ke)
        self.coupling_kd = float(coupling_kd)
        self.consensus_iters = int(consensus_iters)
        self.rho = float(rho)
        self.second_rigid_solver = second_rigid_solver
        self.body_partition = None
        st = model.structure
        dev = model.device
        if body_partition is not None:
            if second_rigid_solver is None:
                raise ValueError("body_partition requires second_rigid_solver")
            bp = np.asarray(body_partition, dtype=bool)
            if bp.shape != (st.body_count,):
                raise ValueError("body_partition must be (body_count,) bool")
            self.body_partition = bp
            # joint coordinates and dofs follow their child body's owner
            jc = np.asarray(st.joint_child, dtype=np.int64)
            own_j = bp[jc] if len(jc) else np.zeros(0, bool)
            qmask = np.zeros(int(st.joint_coord_count), dtype=bool)
            dmask = np.zeros(int(st.joint_dof_count), dtype=bool)
            for j in range(st.joint_count):
                if own_j[j]:
                    qmask[st.joint_q_start[j]:st.joint_q_start[j + 1]] = True
                    dmask[st.joint_qd_start[j]:st.joint_qd_start[j + 1]] = \
                        True
            self._part_masks = tuple(torch.as_tensor(a, device=dev)
                                     for a in (bp[:, None], qmask, dmask))
        elif particle_solver is None:
            raise ValueError("SolverCoupled needs a particle_solver or a "
                             "body_partition + second_rigid_solver")
        # the soft slots' bodies (static: the pipeline's soft pairs)
        sp = np.asarray(getattr(st, "soft_pairs", np.zeros((0, 2))),
                        dtype=np.int64).reshape(-1, 2)
        body_idx = np.asarray(st.shape_body, dtype=np.int64)[sp[:, 1]]
        self._slot_dyn = torch.as_tensor(body_idx >= 0, device=dev)
        self._slot_body = torch.as_tensor(np.maximum(body_idx, 0),
                                          device=dev)
        self._wrench_sum = FixedOrderSum(np.where(body_idx >= 0, body_idx,
                                                  -1), st.body_count, dev)

    def step(self, state_in: State, state_out: Optional[State] = None,
             control: Optional[Control] = None,
             contacts: Optional[Contacts] = None, dt: float = 1e-3) -> State:
        """One step of a flat State; returns the new State."""
        model = self.model
        if self.body_partition is not None:
            return self._step_partitioned(state_in, control, contacts, dt)
        has_coupling = (contacts is not None and contacts.soft_contact_max
                        and model.body_count)
        # the particle step reads state_in alone: the same in every round
        particle_out = self.particle_solver.step(state_in, None, control,
                                                 contacts, dt)
        if not has_coupling:
            rigid_out = self.rigid_solver.step(state_in, None, control,
                                               contacts, dt)
            return self._merge(state_in, rigid_out, particle_out, None)

        check_static_slots(contacts, model.structure, soft=True)
        S = contacts.soft_contact_max
        lam = state_in.body_q.new_zeros(S)                # dual impulse
        residuals = []
        pi = contacts.soft_contact_particle.long()
        nrm = contacts.soft_contact_normal
        act = (contacts.soft_contact_mask & (contacts.soft_contact_depth > 0)
               & self._slot_dyn)
        m_p = model.particle_mass[pi]
        vp = particle_out.particle_qd[pi]
        # the penalty wrench and the slots' lever arms read state_in alone
        arm = contacts.soft_contact_position - self._com(state_in)
        reaction = self._reaction_wrenches(state_in, contacts, arm)
        rigid_out = None
        for _ in range(max(self.consensus_iters, 1)):
            f = -nrm * (lam / dt)[:, None]
            wrench = reaction + self._wrench_sum(torch.cat([f, cross(arm, f)],
                                                           -1))
            state_r = replace(state_in, body_f=state_in.body_f + wrench)
            rigid_out = self.rigid_solver.step(state_r, None, control,
                                               contacts, dt)
            # the consensus residual: the contacts' remaining approach
            # velocity; dual ascent projected onto lam >= 0
            vb = self._body_point_vel(rigid_out, contacts)
            vn_rel = ((vp - vb) * nrm).sum(-1)              # > 0 separating
            gap = torch.where(act, torch.clamp(vn_rel, max=0.0), 0.0)
            residuals.append(torch.sqrt((gap * gap).mean() + 1e-20))
            lam = torch.clamp(lam + self.rho * m_p * (-gap), min=0.0)
        return self._merge(state_in, rigid_out, particle_out,
                           torch.stack(residuals))

    def _step_partitioned(self, state_in, control, contacts, dt):
        """The staggered exchange over the body partition: each round
        re-steps dt from state_in with the partner's bodies at the
        previous round's post-step poses."""
        mA, mQ, mD = self._part_masks

        def merge(cur, out, keep_body, keep_q, keep_d):
            return replace(
                cur,
                body_q=torch.where(keep_body, out.body_q, cur.body_q),
                body_qd=torch.where(keep_body, out.body_qd, cur.body_qd),
                joint_q=torch.where(keep_q, out.joint_q, cur.joint_q)
                if cur.joint_q.shape[0] else cur.joint_q,
                joint_qd=torch.where(keep_d, out.joint_qd, cur.joint_qd)
                if cur.joint_qd.shape[0] else cur.joint_qd,
                custom={**cur.custom, **out.custom})
        prev = state_in
        for _ in range(max(self.consensus_iters, 1)):
            inA = merge(state_in, prev, ~mA, ~mQ, ~mD)
            inB = merge(state_in, prev, mA, mQ, mD)
            outA = self.rigid_solver.step(inA, None, control, contacts, dt)
            outB = self.second_rigid_solver.step(inB, None, control,
                                                 contacts, dt)
            prev = merge(merge(state_in, outA, mA, mQ, mD),
                         outB, ~mA, ~mQ, ~mD)
        cur = prev
        if self.particle_solver is not None and self.model.particle_count:
            outP = self.particle_solver.step(cur, None, control, contacts, dt)
            cur = replace(cur, particle_q=outP.particle_q,
                          particle_qd=outP.particle_qd,
                          custom={**cur.custom, **outP.custom})
        return cur

    def init_state(self, state: State) -> State:
        """The State with ``coupled:residuals`` allocated
        (``consensus_iters``,): each step then reports every round's
        consensus residual there."""
        custom = dict(state.custom)
        custom.setdefault("coupled:residuals", torch.zeros(
            max(self.consensus_iters, 1), dtype=state.body_q.dtype,
            device=state.body_q.device))
        return replace(state, custom=custom)

    def _merge(self, state_in, rigid_out, particle_out, residuals):
        custom = {**particle_out.custom, **rigid_out.custom}
        if residuals is not None and "coupled:residuals" in state_in.custom:
            custom["coupled:residuals"] = residuals
        return replace(state_in, body_q=rigid_out.body_q,
                       body_qd=rigid_out.body_qd, joint_q=rigid_out.joint_q,
                       joint_qd=rigid_out.joint_qd,
                       particle_q=particle_out.particle_q,
                       particle_qd=particle_out.particle_qd, custom=custom)

    def _com(self, state):
        """The soft slots' bodies' centres of mass (S, 3)."""
        bq = state.body_q[self._slot_body]
        return bq[:, 0:3] + quat_rotate(bq[:, 3:7],
                                        self.model.body_com[self._slot_body])

    def _body_point_vel(self, state, contacts):
        qd = state.body_qd[self._slot_body]
        return qd[:, 0:3] + cross(qd[:, 3:6], contacts.soft_contact_position
                                  - self._com(state))

    def _reaction_wrenches(self, state: State, contacts: Contacts, arm):
        """The equal-and-opposite penalty wrench of the particles' active
        contacts on the bodies (B, 6)."""
        n = contacts.soft_contact_normal
        depth = contacts.soft_contact_depth
        act = contacts.soft_contact_mask & (depth > 0) & self._slot_dyn
        vn = (state.particle_qd[contacts.soft_contact_particle.long()]
              * n).sum(-1)
        f_mag = torch.where(act, self.coupling_ke * depth
                            - self.coupling_kd * vn, 0.0)
        f = -n * torch.clamp(f_mag, min=0.0)[:, None]
        return self._wrench_sum(torch.cat([f, cross(arm, f)], -1))
