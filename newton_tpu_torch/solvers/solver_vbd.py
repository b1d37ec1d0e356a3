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

Rigid bodies run the AVBD extension after the particles (the JAX
package's ``_rigid_avbd``): implicit Euler as a per-body block descent.
Each of ``iterations`` sweeps assembles, for every body at once, the
gradient and the 6x6 Hessian of its inertia and of the penalty energies
of its contacts (normal, and friction clamped to the cone, with
augmented-Lagrangian multipliers updated after the sweep) and of its
joints (welds, the rotation lock of FIXED joints, the cables' split
stretch/shear and bend/twist stiffness), and takes one Newton step,
bodies in parallel (the JAX package's batched Jacobi). The 6x6 systems
are symmetric positive definite by construction and go through B1's
solve (``linalg.chol_solve``, the kernel of ``csrc/chol_inv_solve.cu``
on the card); a body without mass gets the identity system and a zero
gradient, so it never moves and its Hessian never reaches the factor.
A velocity pass then removes the normal approach velocity at persisting
contacts. Every per-body sum is a ``FixedOrderSum`` over the joints and
the static pipeline's contact slots (a ``DynamicOrderSum`` for
dynamic-pair Contacts), so two runs of a substep are equal bit for bit.
A bodies' phase without contacts and joints integrates freely, as the
JAX package's first branch.
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
from ..geometry.hashgrid import HashGrid
from ..math import (cross, inv3, quat_conjugate, quat_mul, quat_normalize,
                    quat_rotate, quat_rotate_inv, quat_to_matrix, solve3,
                    transform_multiply)
from ..sim.contacts import Contacts
from ..sim.control import Control
from ..sim.enums import JointType
from ..sim.graph_coloring import ColoringAlgorithm, color_graph
from ..sim.model import Model
from ..sim.state import State
from .solver import SolverBase, body_gravity, integrate_bodies, \
    particle_gravity
from .generalized import linalg
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
        rigid_contact_ke: AVBD's penalty stiffness of the rigid contacts
            (normal and friction).
        rigid_joint_ke: AVBD's stiffness of the joint welds and of the
            FIXED joints' rotation lock (a cable's comes from its
            ``joint_target_ke``).
        handle_self_contact: vertex-vertex penalty pairs from a hash grid
            of the step's start positions, the stretch 1-ring excluded.
        coloring: the vertex order of the colouring (MCS or greedy).
    """

    def __init__(self, model: Model, iterations: int = 4,
                 contact_ke: float = 1.0e4,
                 rigid_contact_ke: float = 1.0e5,
                 rigid_joint_ke: float = 1.0e6,
                 handle_self_contact: bool = False,
                 self_contact_ke: float = 2.0e3,
                 self_contact_radius: Optional[float] = None,
                 self_contact_max_per_cell: int = 4,
                 coloring: ColoringAlgorithm = ColoringAlgorithm.MCS):
        super().__init__(model)
        self._soft_sum = None
        self.iterations = int(iterations)
        self.contact_ke = float(contact_ke)
        self.rigid_contact_ke = float(rigid_contact_ke)
        self.rigid_joint_ke = float(rigid_joint_ke)
        self.handle_self_contact = bool(handle_self_contact)
        self.self_contact_ke = float(self_contact_ke)
        self.self_contact_max_per_cell = int(self_contact_max_per_cell)
        self._body_g = body_gravity(model) if model.body_count else None
        self._rigid = _AVBDPlan(model) if model.body_count else None
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
        """The bodies' phase: without bodies, or without contacts and
        joints, they integrate freely (the JAX package's first branch);
        otherwise ``iterations`` AVBD sweeps and the velocity pass.
        Returns (body_q, body_qd)."""
        model = self.model
        if model.body_count == 0 or (contacts is None
                                     and model.structure.joint_count == 0):
            return integrate_bodies(model, state_in, dt,
                                    gravity=self._body_g)
        return self._rigid.solve(model, state_in, contacts, dt,
                                 self.iterations, self.rigid_contact_ke,
                                 self.rigid_joint_ke)


def _mm(A, B):
    """Batched small matrix product (..., n, k) x (..., k, m), as a
    broadcast product and sum (a batched matmul of 3x3 blocks runs as a
    slow general kernel on the card)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _mv(M, v):
    return (M * v[..., None, :]).sum(-1)


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


def _skew(r):
    """[r]x (..., 3, 3): [r]x v = r x v."""
    x, y, z = r.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _blocks(a, b, c, d):
    """The 6x6 matrices [[a, b], [c, d]] of (..., 3, 3) blocks."""
    return torch.cat([torch.cat([a, b], -1), torch.cat([c, d], -1)], -2)


class _AVBDPlan:
    """The rigid phase of ``SolverVBD``, its static tables built once: the
    joints' bodies and kinds (welds, the rotation lock of FIXED, the
    cables' six stiffness slots), and the fixed-order sums of the
    per-joint and per-slot gradient and Hessian rows into the bodies.
    FREE and DISTANCE joints carry no energy (their rows are zero in the
    JAX package), so they are left out of the tables."""

    def __init__(self, model: Model):
        st = model.structure
        dev = model.device
        self.st, self.dev = st, dev
        self.B = st.body_count
        self.shape_body = torch.as_tensor(
            np.asarray(st.shape_body, dtype=np.int64), device=dev)
        self.gravity = body_gravity(model)
        self.dynamic = model.body_inv_mass > 0                # (B,)
        ft = model.body_mass.dtype
        self.eye6 = torch.eye(6, dtype=ft, device=dev)
        self.identity = torch.tensor([0.0, 0, 0, 0, 0, 0, 1], dtype=ft,
                                     device=dev)
        self._sums = {}
        self.cable = None
        jt = np.asarray(st.joint_type, dtype=np.int64).reshape(-1)
        free = np.isin(jt, (int(JointType.FREE), int(JointType.DISTANCE)))
        sel = np.nonzero(~free)[0]
        self.J = J = len(sel)
        if not J:
            self._jdst = np.zeros(0, np.int64)
            return
        self.sel = torch.as_tensor(sel, device=dev)
        jt = jt[sel]
        parent = np.asarray(st.joint_parent, dtype=np.int64)[sel]
        child = np.asarray(st.joint_child, dtype=np.int64)[sel]
        # the rows' destinations: each joint's row for its child, then
        # for its parent (none for a joint to the world)
        self._jdst = np.concatenate([child, np.where(parent >= 0, parent,
                                                     -1)])
        self.parent = torch.as_tensor(np.maximum(parent, 0), device=dev)
        self.child = torch.as_tensor(child, device=dev)
        self.hasp = torch.as_tensor(parent >= 0, device=dev)[:, None]
        self.lock = torch.as_tensor(jt == int(JointType.FIXED), device=dev)
        is_cable = jt == int(JointType.CABLE)
        if is_cable.any():
            # [shear_x, shear_y, stretch_z, bend_x, bend_y, twist_z]: each
            # joint's six dof slots, clamped into range as a JAX gather is
            D = max(int(st.joint_dof_count), 1)
            d0 = np.asarray(st.joint_qd_start, dtype=np.int64)[sel]
            self.cable = SimpleNamespace(
                mask=torch.as_tensor(is_cable, device=dev),
                dof=torch.as_tensor(np.minimum(d0[:, None] + np.arange(6),
                                               D - 1), device=dev),
                z=torch.tensor([0.0, 0, 1], dtype=ft, device=dev))

    def sums(self, C: int):
        """(the contact rows' sum (2C: body1's, then body0's), the joint
        rows' then the contact rows' sum (2J + 2C)), each into the B
        bodies; built once per C from the static pipeline's slots
        (``slot_shape0/1``), a static side's (zero) row dropped."""
        s = self._sums.get(C)
        if s is None:
            cdst = slot_body_dst(self.st, C, "SolverVBD")
            s = (FixedOrderSum(cdst, self.B, self.dev),
                 FixedOrderSum(np.concatenate([self._jdst, cdst]), self.B,
                               self.dev))
            self._sums[C] = s
        return s

    def world_inertia(self, model: Model, q):
        """R I R^T of every body (B, 3, 3)."""
        R = quat_to_matrix(q)
        return _mm(_mm(R, model.body_inertia), R.transpose(-1, -2))

    def contact_plan(self, model: Model, contacts: Contacts, x_prev,
                     q_prev):
        """Per slot: the bodies (0 where static), dynamic masks, friction,
        the fixed-order sum of its rows, and each side's collide-time
        anchor in its body's COM frame (a static side's: the world
        point)."""
        s0 = torch.clamp(contacts.rigid_contact_shape0.long(), min=0)
        s1 = torch.clamp(contacts.rigid_contact_shape1.long(), min=0)
        b0r, b1r = self.shape_body[s0], self.shape_body[s1]
        dyn0 = (contacts.rigid_contact_shape0 >= 0) & (b0r >= 0)
        dyn1 = (contacts.rigid_contact_shape1 >= 0) & (b1r >= 0)
        b0 = torch.where(dyn0, b0r, 0)
        b1 = torch.where(dyn1, b1r, 0)
        if getattr(contacts, "dynamic", False):
            # the slots' bodies change every call: the order of the sum
            # is planned from this call's destinations, on the device
            csum = DynamicOrderSum(torch.cat([torch.where(dyn1, b1r, -1),
                                              torch.where(dyn0, b0r, -1)]),
                                   self.B)
            dynamic = True
        else:
            check_static_slots(contacts, self.st, rigid=True)
            csum = self.sums(contacts.rigid_contact_max)[0]
            dynamic = False
        n = contacts.rigid_contact_normal
        p = contacts.rigid_contact_position
        half = n * (0.5 * contacts.rigid_contact_depth)[:, None]
        p0, p1 = p + half, p - half
        dyn0c, dyn1c = dyn0[:, None], dyn1[:, None]
        mu = model.shape_material_mu
        return SimpleNamespace(
            b0=b0, b1=b1, dyn0=dyn0c, dyn1=dyn1c, n=n, sum=csum,
            dynamic=dynamic, mask=contacts.rigid_contact_mask,
            mu=0.5 * (mu[s0] + mu[s1]),
            l0=torch.where(dyn0c, quat_rotate_inv(q_prev[b0],
                                                  p0 - x_prev[b0]), p0),
            l1=torch.where(dyn1c, quat_rotate_inv(q_prev[b1],
                                                  p1 - x_prev[b1]), p1))

    @staticmethod
    def anchors(cp, x, q):
        """The slots' anchors at the poses (x, q) and the penetration
        along the normal."""
        a0 = torch.where(cp.dyn0, x[cp.b0] + quat_rotate(q[cp.b0], cp.l0),
                         cp.l0)
        a1 = torch.where(cp.dyn1, x[cp.b1] + quat_rotate(q[cp.b1], cp.l1),
                         cp.l1)
        return a0, a1, -((a1 - a0) * cp.n).sum(-1)

    def contact_rows(self, cp, x, q, lam, kc):
        """Each slot's gradient and Hessian rows [g (6) | H (36)] (2C, 42),
        body1's then body0's: the normal penalty kc max(pen, 0) + lam and
        the tangential anchor drift's, clamped to the mu cone."""
        a0, a1, pen = self.anchors(cp, x, q)
        n = cp.n
        act = cp.mask & ((pen > 0) | (lam > 0))
        f_mag = torch.where(act, kc * torch.clamp(pen, min=0.0) + lam, 0.0)
        r0 = a0 - x[cp.b0]
        r1 = a1 - x[cp.b1]
        J1 = torch.cat([n, cross(r1, n)], -1)
        J0 = torch.cat([n, cross(r0, n)], -1)
        d = a1 - a0
        t_err = d - n * (d * n).sum(-1, keepdim=True)
        t_len = torch.linalg.vector_norm(t_err, dim=-1)
        t_dir = t_err / torch.clamp(t_len, min=1e-9)[:, None]
        ft = torch.minimum(kc * t_len, cp.mu * f_mag)
        ft = torch.where(act, ft, 0.0)
        T1 = torch.cat([t_dir, cross(r1, t_dir)], -1)
        T0 = torch.cat([t_dir, cross(r0, t_dir)], -1)
        g1 = torch.where(cp.dyn1, -f_mag[:, None] * J1 + ft[:, None] * T1,
                         0.0)
        g0 = torch.where(cp.dyn0, f_mag[:, None] * J0 - ft[:, None] * T0,
                         0.0)
        w = act.to(x.dtype)[:, None, None] * kc
        H1 = (w * cp.dyn1[:, :, None]) * (_outer(J1, J1) + _outer(T1, T1))
        H0 = (w * cp.dyn0[:, :, None]) * (_outer(J0, J0) + _outer(T0, T0))
        return torch.cat([torch.cat([g1, H1.flatten(1)], -1),
                          torch.cat([g0, H0.flatten(1)], -1)])

    def joint_rows(self, model: Model, x, q, kj):
        """Each joint's gradient and Hessian rows [g (6) | H (36)] (2J,
        42), the child's then the parent's: the anchor weld (K_lin, kj I;
        a cable's stretch along the parent anchor's +Z and shear across
        it) and the angular penalty (a FIXED
        joint's rotation vector under kj I; a cable's bend, aligning the
        tangents, and twist about them)."""
        J = self.J
        dt_ = x.dtype
        parent, child, hasp = self.parent, self.child, self.hasp
        pose = torch.cat([x - quat_rotate(q, model.body_com), q], -1)
        X_wp = torch.where(hasp, pose[parent], self.identity)
        X_pj = transform_multiply(X_wp, model.joint_X_p[self.sel])
        X_cj = transform_multiply(pose[child], model.joint_X_c[self.sel])
        Cv = X_cj[:, 0:3] - X_pj[:, 0:3]
        rc = X_cj[:, 0:3] - x[child]
        rp = X_pj[:, 0:3] - x[parent]
        top = torch.eye(3, dtype=dt_, device=x.device).expand(J, 3, 3)
        lockf = self.lock.to(dt_)[:, None, None]
        cab = self.cable
        if cab is not None:
            z = cab.z.expand(J, 3)
            t_p = quat_rotate(X_pj[:, 3:7], z)
            t_c = quat_rotate(X_cj[:, 3:7], z)
            ttT = _outer(t_p, t_p)
            ke6 = model.joint_target_ke[cab.dof]
            K_cab = (ke6[:, 2, None, None] * ttT
                     + ke6[:, 0, None, None] * (top - ttT))
            K_lin = torch.where(cab.mask[:, None, None], K_cab, kj * top)
        else:
            K_lin = kj * top
        gl = _mv(K_lin, Cv)
        Rc, Rp = _skew(rc), _skew(rp)
        KRc, KRp = _mm(K_lin, Rc), _mm(K_lin, Rp)
        q_rel = quat_mul(quat_conjugate(X_pj[:, 3:7]), X_cj[:, 3:7])
        q_rel = torch.where(q_rel[:, 3:4] < 0, -q_rel, q_rel)
        dO = quat_rotate(X_pj[:, 3:7], 2.0 * q_rel[:, 0:3]) * lockf[:, 0]
        K_ang = kj * lockf * top
        if cab is not None:
            tau = 2.0 * torch.atan2(q_rel[:, 2], q_rel[:, 3])
            t_mid = t_p + t_c
            t_mid = t_mid / torch.clamp(torch.linalg.vector_norm(
                t_mid, dim=-1, keepdim=True), min=1e-9)
            e_cab = cross(t_p, t_c) + t_mid * tau[:, None]
            dO = torch.where(cab.mask[:, None], e_cab, dO)
            K_ang_cab = (ke6[:, 5, None, None] * ttT
                         + ke6[:, 3, None, None] * (top - ttT))
            K_ang = torch.where(cab.mask[:, None, None], K_ang_cab, K_ang)
        ga = _mv(K_ang, dO)
        Hc = _blocks(K_lin, -KRc, _mm(Rc, K_lin), -_mm(Rc, KRc) + K_ang)
        Hp = _blocks(K_lin, -KRp, _mm(Rp, K_lin), -_mm(Rp, KRp) + K_ang)
        gc = torch.cat([gl, cross(rc, gl) + ga], -1)
        gp = torch.cat([-gl, -cross(rp, gl) - ga], -1)
        return torch.cat([torch.cat([gc, Hc.flatten(1)], -1),
                          torch.cat([gp, Hp.flatten(1)], -1)])

    def solve(self, model: Model, state_in: State, contacts, dt, iterations,
              kc, kj):
        """The AVBD sweeps from the unconstrained prediction, the
        velocities from the poses, the contacts' velocity pass. Returns
        (body_q, body_qd)."""
        B, J = self.B, self.J
        if contacts is not None and contacts.rigid_contact_mask.dim() != 1:
            raise ValueError("SolverVBD.step takes the flat (C,) Contacts "
                             "of a flat State")
        h2 = 1.0 / (dt * dt)
        bq_pred, bqd_pred = integrate_bodies(model, state_in, dt,
                                             gravity=self.gravity)
        x_t = bq_pred[:, 0:3] + quat_rotate(bq_pred[:, 3:7], model.body_com)
        q_t = bq_pred[:, 3:7]
        x_prev = state_in.body_q[:, 0:3] + quat_rotate(
            state_in.body_q[:, 3:7], model.body_com)
        q_prev = state_in.body_q[:, 3:7]
        m = model.body_mass[:, None]
        dyn = self.dynamic[:, None]
        C = contacts.rigid_contact_max if contacts is not None else 0
        cp = self.contact_plan(model, contacts, x_prev, q_prev) if C \
            else None
        zero3 = torch.zeros_like(x_t)[:, :, None].expand(B, 3, 3)
        eye3 = torch.eye(3, dtype=x_t.dtype, device=x_t.device)
        q_t_conj = quat_conjugate(q_t)
        x, q = x_t, q_t
        lam = x_t.new_zeros(C)
        for _ in range(iterations):
            rows = []
            if J:
                rows.append(self.joint_rows(model, x, q, kj))
            if C:
                rows.append(self.contact_rows(cp, x, q, lam, kc))
            if not rows:
                acc = x.new_zeros(B, 42)
            elif C and cp.dynamic:
                acc = cp.sum(rows[-1])
                if J:
                    acc = acc + self.sums(0)[1](rows[0])
            else:
                acc = self.sums(C)[1](torch.cat(rows))
            # the inertia term: h^-2 (m (x - x_t), I_w theta_err)
            Iw = self.world_inertia(model, q)
            qe = quat_mul(q, q_t_conj)
            qe = torch.where(qe[:, 3:4] < 0, -qe, qe)
            g = acc[:, 0:6] + h2 * torch.cat([m * (x - x_t),
                                              _mv(Iw, 2.0 * qe[:, 0:3])], -1)
            H = acc[:, 6:].unflatten(1, (6, 6)) + _blocks(
                h2 * m[:, :, None] * eye3, zero3, zero3, h2 * Iw) \
                + 1e-8 * self.eye6
            # a body without mass: the identity system, a zero step
            H = torch.where(dyn[:, :, None], H, self.eye6)
            g = torch.where(dyn, g, 0.0)
            delta = -linalg.chol_solve(H.contiguous(), g.contiguous())
            x = x + delta[:, 0:3]
            dq = quat_mul(torch.cat([delta[:, 3:6], torch.zeros_like(
                delta[:, :1])], -1), q)
            q = quat_normalize(q + 0.5 * dq)
            if C:
                # the augmented-Lagrangian multipliers
                pen = self.anchors(cp, x, q)[2]
                lam = torch.clamp(lam + kc * pen, min=0.0) * cp.mask
        v = (x - x_prev) / dt
        dq_rel = quat_mul(q, quat_conjugate(q_prev))
        w = 2.0 / dt * dq_rel[:, 0:3]
        w = torch.where(dq_rel[:, 3:4] < 0.0, -w, w)
        v = torch.where(dyn, v, bqd_pred[:, 0:3])
        w = torch.where(dyn, w, bqd_pred[:, 3:6])
        if C:
            v, w = self.velocity_pass(model, cp, x, q, v, w)
        body_q = torch.cat([x - quat_rotate(q, model.body_com), q], -1)
        return body_q, torch.cat([v, w], -1)

    def velocity_pass(self, model: Model, cp, x, q, v, w):
        """The penalty push-out is elastic: the normal approach velocity
        at the persisting contacts (pen > -1e-4) is removed by one
        impulse per slot, inelastic, summed per body."""
        a0, a1, pen = self.anchors(cp, x, q)
        n = cp.n
        act = cp.mask & (pen > -1e-4)
        eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
        Iinv = inv3(self.world_inertia(model, q) + 1e-9 * eye3)
        inv_m = model.body_inv_mass
        b0, b1, dyn0, dyn1 = cp.b0, cp.b1, cp.dyn0, cp.dyn1
        im0 = torch.where(dyn0[:, 0], inv_m[b0], 0.0)
        im1 = torch.where(dyn1[:, 0], inv_m[b1], 0.0)
        I0 = torch.where(dyn0[:, :, None], Iinv[b0], 0.0)
        I1 = torch.where(dyn1[:, :, None], Iinv[b1], 0.0)
        r0 = a0 - x[b0]
        r1 = a1 - x[b1]
        vrel = (torch.where(dyn1, v[b1] + cross(w[b1], r1), 0.0)
                - torch.where(dyn0, v[b0] + cross(w[b0], r0), 0.0))
        vn = (vrel * n).sum(-1)
        r0n, r1n = cross(r0, n), cross(r1, n)
        w_eff = (im0 + im1 + (r0n * _mv(I0, r0n)).sum(-1)
                 + (r1n * _mv(I1, r1n)).sum(-1))
        dlam = torch.where(act, -vn / torch.clamp(w_eff, min=1e-9), 0.0)
        imp = n * dlam[:, None]
        rows = torch.cat([
            torch.where(dyn1, torch.cat([imp * im1[:, None],
                                         _mv(I1, cross(r1, imp))], -1), 0.0),
            torch.where(dyn0, torch.cat([-imp * im0[:, None],
                                         -_mv(I0, cross(r0, imp))], -1),
                        0.0)])
        acc = cp.sum(rows)
        return v + acc[:, 0:3], w + acc[:, 3:6]
