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

Waypoint muscles (``ModelBuilder.add_muscle``) pull along their paths with
``act * f0`` (``Control.muscle_activations``), plus a passive tension
``max(ke (L - lm - lt) + kd Ldot, 0)`` past the rest length, as equal and
opposite wrenches on the waypoints' bodies; the per-muscle length sums and
the wrenches into the bodies are fixed-order sums too.

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
from ..math import cross, det3, inv3, quat_rotate, transform_point
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
        self._muscles = self._muscle_plan(model) if st.muscle_count \
            else None
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
        if (self._muscles is not None and control is not None
                and control.muscle_activations is not None):
            state = replace(state, body_f=state.body_f
                            + self._muscle_forces(model, state, control))
        body_q, body_qd = integrate_bodies(model, state, dt,
                                           self.angular_damping,
                                           gravity=self._body_g)
        particle_q, particle_qd = integrate_particles(model, state, dt,
                                                      gravity=self._g)
        return replace(state_in, body_q=body_q, body_qd=body_qd,
                       particle_q=particle_q, particle_qd=particle_qd)

    # ------------------------------------------------------------------
    def _muscle_plan(self, model: Model):
        """Each muscle's segments (consecutive waypoints): their waypoints,
        bodies and muscle, the sum of segment lengths into the muscles and
        of the segments' wrenches into the bodies."""
        st = model.structure
        starts = np.asarray(st.muscle_start, dtype=np.int64)
        w0 = np.concatenate([np.arange(starts[m], starts[m + 1] - 1)
                             for m in range(st.muscle_count)])
        w0 = w0.astype(np.int64)
        seg = np.repeat(np.arange(st.muscle_count),
                        np.maximum(np.diff(starts) - 1, 0))
        bodies = model.muscle_bodies.cpu().numpy().astype(np.int64)
        if (bodies < 0).any():
            raise NotImplementedError(
                "muscle waypoints on the world (body -1) are not ported (the "
                "JAX package reads them as the last body)")
        dev = model.device

        def L(a):
            return torch.as_tensor(a, dtype=torch.long, device=dev)
        b0, b1 = bodies[w0], bodies[w0 + 1]
        return dict(w0=L(w0), w1=L(w0 + 1), seg=L(seg), b0=L(b0), b1=L(b1),
                    len_sum=FixedOrderSum(seg, st.muscle_count, dev),
                    body_sum=FixedOrderSum(np.concatenate([b0, b1]),
                                           model.body_count, dev))

    def _muscle_forces(self, model: Model, state: State, control):
        """Contraction ``act * f0`` along each waypoint segment plus the
        passive tension, as equal and opposite wrenches (B, 6)."""
        p = self._muscles
        bq, bqd = state.body_q, state.body_qd
        b0, b1, seg = p["b0"], p["b1"], p["seg"]
        p0 = transform_point(bq[b0], model.muscle_points[p["w0"]])
        p1 = transform_point(bq[b1], model.muscle_points[p["w1"]])
        d = p1 - p0
        ln = _norm(d)
        n = d / torch.clamp(ln, min=1e-9)[:, None]
        prm = model.muscle_params
        fmag = control.muscle_activations[seg] * prm[seg, 0]
        # passive elasticity past the rest length lm + lt; tendons never
        # push
        xc = bq[:, 0:3] + quat_rotate(bq[:, 3:7], model.body_com)
        v0 = bqd[b0, 0:3] + cross(bqd[b0, 3:6], p0 - xc[b0])
        v1 = bqd[b1, 0:3] + cross(bqd[b1, 3:6], p1 - xc[b1])
        L = p["len_sum"](ln)
        Ldot = p["len_sum"](((v1 - v0) * n).sum(-1))
        f_pass = torch.clamp(prm[:, 5] * (L - (prm[:, 1] + prm[:, 2]))
                             + prm[:, 6] * Ldot, min=0.0)
        fvec = n * (fmag + f_pass[seg])[:, None]       # pulls p0 toward p1
        w0 = torch.cat([fvec, cross(p0 - xc[b0], fvec)], -1)
        w1 = torch.cat([-fvec, cross(p1 - xc[b1], -fvec)], -1)
        return p["body_sum"](torch.cat([w0, w1]))

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
