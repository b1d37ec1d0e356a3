"""Semi-implicit (symplectic Euler) force-based solver (port of
``newton_tpu/solvers/solver_semi_implicit.py``).

Explicit particle forces: springs, co-rotational membrane triangles,
NeoHookean tetrahedra, a dihedral spring on each bending edge and penalty
soft contacts with friction, every term summed into its particle by one
fixed-order sum over a table built at construction (two runs of a step are
equal bit for bit on the card, where ``index_add_`` adds in no fixed
order); then one symplectic Euler step of the bodies and the particles. The 3x3
determinants and inverses of the tetrahedra are closed-form, so a step
never waits for the device.

The bending force copies the JAX package's formula, including what it
does on the cloth grid's collinear bending rows (v0 == v1): their edge
vector is zero, so the angle is atan2(0, 0) = 0, their rest angle, and a
grid cloth gets no bending force from this solver.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..core.segment_sum import FixedOrderSum, check_static_slots
from ..math import det3, inv3
from ..sim.contacts import Contacts
from ..sim.control import Control
from ..sim.model import Model
from ..sim.state import State
from .solver import SolverBase, body_gravity, integrate_bodies, \
    integrate_particles, particle_gravity

__all__ = ["SolverSemiImplicit"]


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


class SolverSemiImplicit(SolverBase):
    """Explicit forces, then symplectic Euler.

    Args:
        angular_damping: the bodies' angular velocity damping.
    """

    def __init__(self, model: Model, angular_damping: float = 0.05):
        super().__init__(model)
        self.angular_damping = float(angular_damping)
        self._body_g = body_gravity(model) if model.body_count else None
        self._g = particle_gravity(model) if model.particle_count else None
        st = model.structure

        def cols(t):
            return [c.long() for c in t.unbind(1)]
        self._springs = cols(model.spring_indices) if st.spring_count \
            else None
        self._tris = cols(model.tri_indices) if st.tri_count else None
        self._tets = None
        if st.tet_count:
            self._tets = cols(model.tet_indices)
            self._tet_vol0 = 1.0 / torch.clamp(
                det3(model.tet_poses).abs(), min=1e-12) / 6.0
        self._edges = None
        if st.edge_count:
            ei = model.edge_indices.long()
            self._edges = (torch.clamp(ei[:, 0], min=0),
                           torch.clamp(ei[:, 1], min=0), ei[:, 2], ei[:, 3],
                           (ei[:, 0] >= 0) & (ei[:, 1] >= 0))
        # each force term's particle, in _particle_forces' order
        self._force_dst = [c.cpu().numpy() for part in (
            self._springs, self._tris, self._tets,
            self._edges[:4] if self._edges is not None else None)
            if part is not None for c in part]
        self._sums = {}

    def step(self, state_in: State, state_out: Optional[State] = None,
             control: Optional[Control] = None,
             contacts: Optional[Contacts] = None, dt: float = 1e-3) -> State:
        model = self.model
        state = state_in
        if model.particle_count:
            state = replace(state, particle_f=state.particle_f
                            + self._particle_forces(model, state, contacts))
        body_q, body_qd = integrate_bodies(model, state, dt,
                                           self.angular_damping,
                                           gravity=self._body_g)
        particle_q, particle_qd = integrate_particles(model, state, dt,
                                                      gravity=self._g)
        return replace(state_in, body_q=body_q, body_qd=body_qd,
                       particle_q=particle_q, particle_qd=particle_qd)

    # ------------------------------------------------------------------
    def _particle_forces(self, model: Model, state: State,
                         contacts: Optional[Contacts]) -> torch.Tensor:
        px, pv = state.particle_q, state.particle_qd
        terms = []

        if self._springs is not None:
            i, j = self._springs
            d = px[j] - px[i]
            dist = _norm(d)
            n = d / torch.clamp(dist, min=1e-9)[:, None]
            dv = ((pv[j] - pv[i]) * n).sum(-1)
            fs = (model.spring_stiffness * (dist - model.spring_rest_length)
                  + model.spring_damping * dv)
            fvec = n * fs[:, None]
            terms += [fvec, -fvec]

        if self._tris is not None:
            a, b, c = self._tris
            x0 = px[a]
            e1 = px[b] - x0
            e2 = px[c] - x0
            nrm = torch.linalg.cross(e1, e2)
            nhat = nrm / torch.clamp(_norm(nrm), min=1e-12)[:, None]
            u1 = e1 / torch.clamp(_norm(e1), min=1e-12)[:, None]
            u2 = torch.linalg.cross(nhat, u1)
            D = torch.stack([
                torch.stack([(e1 * u1).sum(-1), (e2 * u1).sum(-1)], -1),
                torch.stack([(e1 * u2).sum(-1), (e2 * u2).sum(-1)], -1)], -2)
            F = D @ model.tri_poses                        # (T, 2, 2)
            ke = model.tri_materials[:, 0]
            kd = model.tri_materials[:, 2]
            E = 0.5 * (F @ F.transpose(-1, -2)
                       - torch.eye(2, dtype=px.dtype, device=px.device))
            P = ke[:, None, None] * (F @ E)
            H = -model.tri_areas[:, None, None] * (
                P @ model.tri_poses.transpose(-1, -2))
            f1 = H[:, 0, 0, None] * u1 + H[:, 1, 0, None] * u2
            f2 = H[:, 0, 1, None] * u1 + H[:, 1, 1, None] * u2
            vd = kd[:, None] * (pv[a] + pv[b] + pv[c]) / 3.0
            terms += [-(f1 + f2) - vd, f1 - vd, f2 - vd]

        if self._tets is not None:
            a, b, c, d_ = self._tets
            xa = px[a]
            Ds = torch.stack([px[b] - xa, px[c] - xa, px[d_] - xa], -1)
            F = Ds @ model.tet_poses
            k_mu = model.tet_materials[:, 0]
            k_lambda = model.tet_materials[:, 1]
            k_damp = model.tet_materials[:, 2]
            Jdet = det3(F)
            Finv_T = inv3(F.transpose(-1, -2) + 1e-8 * torch.eye(
                3, dtype=px.dtype, device=px.device))
            P = (k_mu[:, None, None] * (F - Finv_T)
                 + (k_lambda * torch.log(torch.clamp(Jdet, min=1e-6)))[
                     :, None, None] * Finv_T)
            H = -self._tet_vol0[:, None, None] * (
                P @ model.tet_poses.transpose(-1, -2))
            fb, fc, fd = H[:, :, 0], H[:, :, 1], H[:, :, 2]
            vdamp = k_damp[:, None]
            terms += [-(fb + fc + fd) - vdamp * pv[a], fb - vdamp * pv[b],
                      fc - vdamp * pv[c], fd - vdamp * pv[d_]]

        if self._edges is not None:
            o0, o1, v0, v1, valid = self._edges
            x1, x2 = px[v0], px[v1]
            x3, x4 = px[o0], px[o1]
            e = x2 - x1
            elen = _norm(e)
            n1 = torch.linalg.cross(x3 - x1, x2 - x1)
            n2 = torch.linalg.cross(x2 - x1, x4 - x1)
            n1n = torch.clamp(_norm(n1), min=1e-9)
            n2n = torch.clamp(_norm(n2), min=1e-9)
            cos_t = torch.clamp((n1 * n2).sum(-1) / (n1n * n2n), -1.0, 1.0)
            sin_t = torch.clamp(
                (torch.linalg.cross(n1, n2) * e).sum(-1)
                / (n1n * n2n * torch.clamp(elen, min=1e-9)), -1.0, 1.0)
            theta = torch.atan2(sin_t, cos_t)
            torque = (model.edge_bending_properties[:, 0]
                      * (theta - model.edge_rest_angle) * valid)[:, None]
            d3 = n1 / n1n[:, None]
            d4 = n2 / n2n[:, None]
            terms += [-torque * d3 * 0.5, -torque * d4 * 0.5,
                      torque * (d3 + d4) * 0.25, torque * (d3 + d4) * 0.25]

        if contacts is not None and contacts.soft_contact_max:
            check_static_slots(contacts, model.structure, soft=True)
            pi = contacts.soft_contact_particle.long()
            n = contacts.soft_contact_normal
            depth = contacts.soft_contact_depth
            act = contacts.soft_contact_mask & (depth > 0)
            vrel = pv[pi]
            vn = (vrel * n).sum(-1)
            vt = vrel - n * vn[:, None]
            fn = model.soft_contact_ke * depth - model.soft_contact_kd * vn
            fn = torch.where(act, torch.clamp(fn, min=0.0), 0.0)
            vt_n = _norm(vt)
            ft = -vt / torch.clamp(vt_n, min=1e-6)[:, None] * torch.minimum(
                model.particle_kf * vt_n, model.soft_contact_mu * fn)[:, None]
            terms.append(n * fn[:, None] + torch.where(act[:, None], ft, 0.0))
        soft = contacts is not None and contacts.soft_contact_max > 0
        if not terms:
            return torch.zeros_like(px)
        return self._force_sum(soft)(torch.cat(terms))

    def _force_sum(self, soft: bool) -> FixedOrderSum:
        """The fixed-order sum of ``_particle_forces``' terms, in their
        order: springs (i, j), triangles (a, b, c), tetrahedra (a, b, c,
        d), bending edges (o0, o1, v0, v1), then, with ``soft``, the
        static pipeline's soft slots (``soft_pairs``)."""
        s = self._sums.get(soft)
        if s is None:
            model = self.model
            dst = list(self._force_dst)
            if soft:
                sp = np.asarray(model.structure.soft_pairs,
                                dtype=np.int64).reshape(-1, 2)
                dst.append(sp[:, 0])
            dst = (np.concatenate(dst) if dst else np.zeros(0, np.int64))
            s = FixedOrderSum(dst, model.particle_count, model.device)
            self._sums[soft] = s
        return s
