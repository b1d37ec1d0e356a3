"""VBD solver: vertex block descent for cloth (port of the particle path
of ``newton_tpu/solvers/solver_vbd.py``).

Implicit Euler as graph-coloured Gauss-Seidel: the stretch constraints
(springs and unique triangle edges) colour the vertices; per sweep the
colours run in sequence and all vertices of one colour take one Newton
step at once, each on its own 3x3 system (inertia, the stretch
Gauss-Newton Hessian, bending, self-contact and soft-contact penalties)
gathered through fixed-width incidence tables built at construction. The
colours, and so the Gauss-Seidel order, are the JAX package's
(``sim/graph_coloring.py``). The 3x3 systems are solved in closed form
with a pinned vertex's system replaced by the identity and a zero
gradient: it never moves, and its (possibly singular) Hessian never
reaches the solve. A substep runs a fixed number of device operations with
no host synchronization.

Rigid bodies: only the case without contacts and joints (or without
bodies) is ported, where the bodies integrate freely; AVBD's rigid block
solve raises.
"""

from __future__ import annotations

from dataclasses import replace
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..core.segment_sum import check_static_slots, soft_contact_sum
from ..geometry.hashgrid import HashGrid
from ..math import solve3
from ..sim.contacts import Contacts
from ..sim.control import Control
from ..sim.graph_coloring import ColoringAlgorithm, color_graph
from ..sim.model import Model
from ..sim.state import State
from .solver import SolverBase, body_gravity, integrate_bodies, \
    particle_gravity
from .solver_style3d import _host, cloth_constraints

__all__ = ["SolverVBD"]


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _dihedral(p: torch.Tensor):
    """Dihedral angle and per-vertex gradients of bending quads ``p``
    (..., 4, 3) in edge_indices order (o0, o1, v0, v1): wings p3, p4 and
    the shared edge p1-p2 (Bridson's formulas). Returns (theta (...,),
    grads (..., 4, 3) in the same vertex order)."""
    p3, p4, p1, p2 = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    e = p2 - p1
    elen = _norm(e)
    ehat = e / torch.clamp(elen, min=1e-9)[..., None]
    n1 = torch.linalg.cross(p1 - p3, p2 - p3)
    n2 = torch.linalg.cross(p2 - p4, p1 - p4)
    n1l2 = torch.clamp((n1 * n1).sum(-1), min=1e-18)
    n2l2 = torch.clamp((n2 * n2).sum(-1), min=1e-18)
    n1h = n1 * torch.rsqrt(n1l2)[..., None]
    n2h = n2 * torch.rsqrt(n2l2)[..., None]
    sin_t = (torch.linalg.cross(n1h, n2h) * ehat).sum(-1)
    cos_t = (n1h * n2h).sum(-1)
    theta = torch.atan2(sin_t, cos_t)
    w1 = n1 / n1l2[..., None]
    w2 = n2 / n2l2[..., None]
    G3 = elen[..., None] * w1
    G4 = elen[..., None] * w2
    a1 = ((p3 - p2) * ehat).sum(-1)[..., None]
    a2 = ((p4 - p2) * ehat).sum(-1)[..., None]
    b1 = ((p3 - p1) * ehat).sum(-1)[..., None]
    b2 = ((p4 - p1) * ehat).sum(-1)[..., None]
    G1 = a1 * w1 + a2 * w2
    G2 = -b1 * w1 - b2 * w2
    return theta, torch.stack([G3, G4, G1, G2], -2)


def _chain_bend(p: torch.Tensor):
    """Three-point bend angle of a degenerate bending row (v0 == v1): the
    angle at the middle vertex between o0 - m and o1 - m (the cloth grid's
    collinear triples). Returns (theta, grads (..., 4, 3)), the middle
    vertex's gradient split over roles 2 and 3. An exactly collinear
    triple has no bend plane: a perpendicular of o0 - m stands in for its
    normal."""
    p3, p4, pm = p[..., 0, :], p[..., 1, :], p[..., 2, :]
    u = p3 - pm
    v = p4 - pm
    ul = torch.clamp(_norm(u), min=1e-9)
    vl = torch.clamp(_norm(v), min=1e-9)
    uh = u / ul[..., None]
    vh = v / vl[..., None]
    n = torch.linalg.cross(u, v)
    nl = _norm(n)
    theta = torch.atan2(nl, (u * v).sum(-1))
    zero = torch.zeros_like(uh[..., 0])
    ux, uy, uz = uh.unbind(-1)
    fx = torch.stack([zero, uz, -uy], -1)              # uh x (1, 0, 0)
    fy = torch.stack([-uz, zero, ux], -1)              # uh x (0, 1, 0)
    fallback = torch.where((_norm(fx) > 0.1)[..., None], fx, fy)
    nh = torch.where((nl > 1e-9)[..., None],
                     n / torch.clamp(nl, min=1e-9)[..., None],
                     fallback / torch.clamp(_norm(fallback),
                                            min=1e-9)[..., None])
    G3 = torch.linalg.cross(uh, nh) / ul[..., None]
    G4 = torch.linalg.cross(nh, vh) / vl[..., None]
    Gm = -0.5 * (G3 + G4)
    return theta, torch.stack([G3, G4, Gm, Gm], -2)


def _bend_eval(p: torch.Tensor, is3pt: torch.Tensor):
    """Bending angle and gradients, the dihedral or the three-point form
    per row (``is3pt`` broadcastable bool)."""
    thA, GA = _dihedral(p)
    thB, GB = _chain_bend(p)
    return (torch.where(is3pt, thB, thA),
            torch.where(is3pt[..., None, None], GB, GA))


def _incidence(nodes: np.ndarray, n: int):
    """Slot of each entry of ``nodes`` in its node's row, in order of
    appearance, and the rows' width."""
    order = np.argsort(nodes, kind="stable")
    deg = np.bincount(nodes, minlength=n)
    slot = np.empty(len(nodes), dtype=np.int64)
    slot[order] = np.arange(len(nodes)) - np.repeat(np.cumsum(deg) - deg,
                                                    deg)
    return slot, int(deg.max(initial=0))


class SolverVBD(SolverBase):
    """Vertex block descent for cloth.

    Args:
        iterations: Gauss-Seidel sweeps per substep.
        contact_ke: penalty stiffness of the soft contacts.
        handle_self_contact: vertex-vertex penalty pairs from a hash grid
            of the step's start positions, the stretch 1-ring excluded.
        coloring: the vertex order of the colouring (MCS or greedy).
    """

    def __init__(self, model: Model, iterations: int = 4,
                 contact_ke: float = 1.0e4,
                 handle_self_contact: bool = False,
                 self_contact_ke: float = 2.0e3,
                 self_contact_radius: Optional[float] = None,
                 self_contact_max_per_cell: int = 4,
                 coloring: ColoringAlgorithm = ColoringAlgorithm.MCS):
        super().__init__(model)
        self._soft_sum = None
        self.iterations = int(iterations)
        self.contact_ke = float(contact_ke)
        self.handle_self_contact = bool(handle_self_contact)
        self.self_contact_ke = float(self_contact_ke)
        self.self_contact_max_per_cell = int(self_contact_max_per_cell)
        self._body_g = body_gravity(model) if model.body_count else None
        st = model.structure
        N = st.particle_count
        dev = model.device
        r = self_contact_radius
        if r is None:
            r = 2.0 * float(np.max(_host(model.particle_radius), initial=0.0))
        self.self_contact_radius = float(r)

        pairs, rest, ke = cloth_constraints(model, bending=False)
        self.n_cons = len(pairs)
        self.colors = color_graph(N, pairs, coloring) if N else []

        # (N, D) incidence: the other end, rest length and stiffness of
        # each vertex's constraints in constraint order; padding points at
        # vertex 0 with stiffness 0
        node = pairs.reshape(-1)
        slot, D = _incidence(node, N)
        D = max(D, 1)
        inc_other = np.zeros((N, D), dtype=np.int64)
        inc_rest = np.zeros((N, D), dtype=np.float32)
        inc_ke = np.zeros((N, D), dtype=np.float32)
        inc_other[node, slot] = pairs[:, ::-1].reshape(-1)
        inc_rest[node, slot] = np.repeat(rest, 2)
        inc_ke[node, slot] = np.repeat(ke, 2)
        self.inc_other = inc_other

        # bending: each vertex's (edge, role) pairs over the edges with
        # both wings, -1 padded; rest angles from the build pose
        self.has_bending = False
        ei = _host(model.edge_indices).astype(np.int64)
        wing_ok = (ei[:, 0] >= 0) & (ei[:, 1] >= 0)
        if st.edge_count and wing_ok.any():
            self.has_bending = True
            e_ok = np.nonzero(wing_ok)[0]
            bnode = ei[e_ok].reshape(-1)
            bslot, Bmax = _incidence(bnode, N)
            inc_bedge = -np.ones((N, max(Bmax, 1)), dtype=np.int64)
            inc_brole = np.zeros((N, max(Bmax, 1)), dtype=np.int64)
            inc_bedge[bnode, bslot] = np.repeat(e_ok, 4)
            inc_brole[bnode, bslot] = np.tile(np.arange(4), len(e_ok))
            edge_idx = torch.as_tensor(np.maximum(ei, 0), device=dev)
            bend_3pt = torch.as_tensor(ei[:, 2] == ei[:, 3], device=dev)
            theta0, _ = _bend_eval(model.particle_q[edge_idx], bend_3pt)
            bend_ke = model.edge_bending_properties[:, 0]

        # per colour: the gathered static tables of its vertices
        inv_m = model.particle_inv_mass
        self._groups = []
        for verts in self.colors:
            if not len(verts):
                continue
            v = torch.as_tensor(verts.astype(np.int64), device=dev)
            g = SimpleNamespace(
                verts=v, other=torch.as_tensor(inc_other[verts], device=dev),
                rest=torch.as_tensor(inc_rest[verts], device=dev),
                ke=torch.as_tensor(inc_ke[verts], device=dev),
                h_mass=model.particle_mass[v][:, None],
                pinned=(inv_m[v] == 0)[:, None],
                free=(inv_m[v] > 0)[:, None])
            if self.has_bending:
                eids = torch.as_tensor(np.maximum(inc_bedge[verts], 0),
                                       device=dev)
                valid = torch.as_tensor(inc_bedge[verts] >= 0, device=dev)
                g.quad = edge_idx[eids]                     # (V, Bm, 4)
                g.is3pt = bend_3pt[eids]
                g.bend_ke = bend_ke[eids] * valid
                g.theta0 = theta0[eids]
                g.role = torch.as_tensor(inc_brole[verts], device=dev)[
                    ..., None, None].expand(-1, -1, 1, 3)
            self._groups.append(g)
        self._active = (inv_m > 0)[:, None]
        self._g = particle_gravity(model) if N else None
        self._grid = HashGrid(cell_size=self.self_contact_radius or 1.0,
                              max_per_cell=self.self_contact_max_per_cell)
        if self.handle_self_contact and N:
            self._ring = torch.as_tensor(inc_other, device=dev)

    def _self_pairs(self, x0: torch.Tensor):
        cand, cmask = self._grid.query(x0, self.self_contact_radius)
        adj = (cand[:, :, None] == self._ring[:, None, :]).any(-1)
        return cand, cmask & ~adj

    def _vertex_update(self, x, y, g, h2, eye, nbr, soft):
        """One Newton step of every vertex of colour group ``g``."""
        v = g.verts
        xi = x[v]
        d = xi[:, None, :] - x[g.other]
        dist = _norm(d)
        dist_c = torch.clamp(dist, min=1e-9)
        dhat = d / dist_c[..., None]
        # gradient of 1/2 ke (|d| - L)^2 and its Gauss-Newton Hessian
        grad = ((g.ke * (dist - g.rest))[..., None] * dhat).sum(1)
        op = dhat[..., :, None] * dhat[..., None, :]
        t_coeff = g.ke * torch.clamp(1.0 - g.rest / dist_c, min=0.0)
        H = ((g.ke[..., None, None] * op).sum(1)
             + (t_coeff[..., None, None] * (eye - op)).sum(1))
        grad = grad + h2 * g.h_mass * (xi - y[v])
        H = H + h2 * g.h_mass[..., None] * eye
        if self.has_bending:
            theta, G = _bend_eval(x[g.quad], g.is3pt)
            Gi = torch.gather(G, 2, g.role)[:, :, 0, :]     # (V, Bm, 3)
            grad = grad + ((g.bend_ke * (theta - g.theta0))[..., None]
                           * Gi).sum(1)
            H = H + (g.bend_ke[..., None, None] * Gi[..., :, None]
                     * Gi[..., None, :]).sum(1)
        if nbr is not None:
            cand, cmask = nbr
            dvec = xi[:, None, :] - x[cand[v]]
            dlen = _norm(dvec)
            pen = torch.clamp(self.self_contact_radius - dlen, min=0.0) \
                * cmask[v]
            ddir = dvec / torch.clamp(dlen, min=1e-9)[..., None]
            ks = self.self_contact_ke
            grad = grad - ((ks * pen)[..., None] * ddir).sum(1)
            w_on = (pen > 0).to(x.dtype)
            H = H + ((ks * w_on)[..., None, None] * ddir[..., :, None]
                     * ddir[..., None, :]).sum(1)
        if soft is not None:
            grad = grad + soft[0][v]
            H = H + soft[1][v]
        H = torch.where(g.pinned[..., None], eye, H)
        grad = torch.where(g.pinned, 0.0, grad)
        dx = -solve3(H, grad) * g.free
        return x.index_add(0, v, dx)

    # ------------------------------------------------------------------
    def step(self, state_in: State, state_out: Optional[State] = None,
             control: Optional[Control] = None,
             contacts: Optional[Contacts] = None, dt: float = 1e-3) -> State:
        model = self.model
        N = model.particle_count
        if N == 0:
            body_q, body_qd = self._rigid_avbd(state_in, control, contacts,
                                               dt)
            return replace(state_in, body_q=body_q, body_qd=body_qd)
        inv_m = model.particle_inv_mass[:, None]
        active = self._active
        x0, v0 = state_in.particle_q, state_in.particle_qd
        a_ext = self._g * active + state_in.particle_f * inv_m
        y = x0 + dt * v0 * active + dt * dt * a_ext
        x = torch.where(active, y, x0)
        h2 = 1.0 / (dt * dt)
        eye = torch.eye(3, dtype=x0.dtype, device=x0.device)

        soft = None
        if contacts is not None and contacts.soft_contact_max > 0:
            # the penalty of each particle's active contacts, constant
            # through the sweeps
            depth = contacts.soft_contact_depth
            nrm = contacts.soft_contact_normal
            act = contacts.soft_contact_mask & (depth > 0)
            check_static_slots(contacts, model.structure, soft=True)
            if self._soft_sum is None:
                self._soft_sum = soft_contact_sum(model.structure, N,
                                                  x0.device)
            # gradient and Hessian summed in one fixed-order pass
            gH = torch.cat([
                -self.contact_ke * depth[:, None] * nrm,
                (self.contact_ke * nrm[:, :, None] * nrm[:, None, :]
                 ).flatten(1)], 1)
            gH = self._soft_sum(torch.where(act[:, None], gH, 0.0))
            soft = (gH[:, 0:3], gH[:, 3:12].unflatten(1, (3, 3)))
        nbr = None
        if self.handle_self_contact and N > 1 and \
                self.self_contact_radius > 0:
            nbr = self._self_pairs(x0)

        for _ in range(self.iterations):
            for g in self._groups:
                x = self._vertex_update(x, y, g, h2, eye, nbr, soft)
        v = (x - x0) / dt
        x = torch.where(active, x, x0)
        v = torch.where(active, v, v0)
        body_q, body_qd = self._rigid_avbd(state_in, control, contacts, dt)
        return replace(state_in, particle_q=x, particle_qd=v,
                       body_q=body_q, body_qd=body_qd)

    def _rigid_avbd(self, state_in: State, control, contacts, dt: float):
        """Rigid bodies: without bodies, or without contacts and joints,
        they integrate freely (the JAX package's first branch); AVBD's
        block solve for contacts and joints is not ported."""
        model = self.model
        if model.body_count == 0 or (contacts is None
                                     and model.structure.joint_count == 0):
            return integrate_bodies(model, state_in, dt,
                                    gravity=self._body_g)
        raise NotImplementedError(
            "SolverVBD's rigid bodies with contacts or joints (AVBD) are "
            "not ported yet")
