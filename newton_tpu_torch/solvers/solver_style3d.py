"""Style3D solver: projective-dynamics cloth (port of
``newton_tpu/solvers/solver_style3d.py``).

Implicit Euler by local/global alternation. The local step projects every
distance constraint (springs, the unique triangle edges and the bending
rows' wing pairs) to its rest length; the global step solves the constant
system A x = M/h^2 y + sum_c w_c S_c^T p_c, with A = M/h^2 + sum_c w_c
S_c^T S_c, matrix-free by 8 iterations of Jacobi-preconditioned CG
warm-started from the previous iterate (A is the same scalar matrix on the
three axes, so the axes are three right-hand sides of one CG). A matvec is
one gather over each vertex's constraint neighbours, summed in a fixed
order (tables built at construction: two runs of a substep are equal bit
for bit on the card, where ``index_add_`` adds in no fixed order); so is
the right-hand side's sum of projections. Soft contacts add a
penalty force to the inertia target, self-contact (hash-grid vertex pairs
anchored at the start of the step) a penalty force to each iteration's
right-hand side, so A never changes.

A substep runs a fixed number of device operations with no host
synchronization and no data-dependent branch: A's diagonal is computed on
the host once per ``dt``, every index table at construction.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..core.segment_sum import (FixedOrderSum, check_static_slots,
                                soft_contact_sum)
from ..geometry.hashgrid import HashGrid
from ..sim.contacts import Contacts
from ..sim.control import Control
from ..sim.model import Model
from ..sim.state import State
from .solver import SolverBase, body_gravity, integrate_bodies, \
    particle_gravity

__all__ = ["SolverStyle3D", "cloth_constraints"]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _unique_edges(tri: np.ndarray):
    """The triangles' edges (a, b) with a < b, once each in order of first
    appearance (triangle by triangle, edges 01, 12, 20), and the index of
    the triangle that first has each."""
    e = np.stack([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]], 1)
    e = np.sort(e.reshape(-1, 2), axis=1)
    key = e[:, 0] * (int(e.max(initial=0)) + 1) + e[:, 1]
    _, first = np.unique(key, return_index=True)
    first = np.sort(first)
    return e[first], first // 3


def cloth_constraints(model: Model, bend_scale: float = 1.0,
                      bending: bool = True):
    """Distance constraints of a cloth model as the JAX package's
    Style3D and VBD solvers build them: springs first, then the unique
    triangle edges (stiffness of the triangle that first has the edge,
    rest length from the model's particle_q), then, with ``bending``, one
    row per bending edge with both wings and a positive stiffness between
    its two wings. Returns (pairs (C, 2) int64, rest (C,) float32,
    stiffness (C,) float64)."""
    st = model.structure
    q0 = _host(model.particle_q)
    pairs, rest, w = [np.zeros((0, 2), np.int64)], [np.zeros(0, np.float32)], \
        [np.zeros(0)]

    def dist(ab):
        d = q0[ab[:, 0]] - q0[ab[:, 1]]
        return np.sqrt((d * d).sum(-1)).astype(np.float32)
    if st.spring_count:
        pairs.append(_host(model.spring_indices).astype(np.int64))
        rest.append(_host(model.spring_rest_length))
        w.append(_host(model.spring_stiffness).astype(np.float64))
    if st.tri_count:
        e, t = _unique_edges(_host(model.tri_indices).astype(np.int64))
        pairs.append(e)
        rest.append(dist(e))
        w.append(_host(model.tri_materials)[t, 0].astype(np.float64))
    if bending and st.edge_count:
        ei = _host(model.edge_indices).astype(np.int64)
        keb = _host(model.edge_bending_properties)[:, 0] * bend_scale
        ok = (ei[:, 0] >= 0) & (ei[:, 1] >= 0) & (keb > 0)
        e = ei[ok][:, :2]
        pairs.append(e)
        rest.append(dist(e))
        w.append(keb[ok].astype(np.float64))
    return (np.concatenate(pairs), np.concatenate(rest),
            np.concatenate(w))


def one_ring(pairs: np.ndarray, n: int) -> np.ndarray:
    """(n, D) table of each vertex's constraint neighbours, -1 padded."""
    node = np.concatenate([pairs[:, 0], pairs[:, 1]])
    other = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.argsort(node, kind="stable")
    node, other = node[order], other[order]
    deg = np.bincount(node, minlength=n)
    slot = np.arange(len(node)) - np.repeat(np.cumsum(deg) - deg, deg)
    out = np.full((n, max(int(deg.max(initial=0)), 1)), -1, dtype=np.int64)
    out[node, slot] = other
    return out


class SolverStyle3D(SolverBase):
    """Projective-dynamics cloth.

    Args:
        iterations: local/global alternations per substep.
        contact_ke: penalty stiffness of the soft contacts (added to the
            inertia target, so A stays constant).
        bend_scale: factor on the bending rows' stiffness.
        handle_self_contact: vertex-vertex penalty pairs from a hash grid
            of the step's start positions, constraint neighbours excluded.
        self_contact_radius: contact distance (default twice the largest
            particle radius).
    """

    PCG_ITERATIONS = 8

    def __init__(self, model: Model, iterations: int = 8,
                 contact_ke: float = 1.0e4, bend_scale: float = 1.0,
                 handle_self_contact: bool = False,
                 self_contact_ke: float = 2.0e3,
                 self_contact_radius: Optional[float] = None,
                 self_contact_max_per_cell: int = 4):
        super().__init__(model)
        self.iterations = int(iterations)
        self.contact_ke = float(contact_ke)
        self.handle_self_contact = bool(handle_self_contact)
        self.self_contact_ke = float(self_contact_ke)
        self.self_contact_max_per_cell = int(self_contact_max_per_cell)
        self._body_g = body_gravity(model) if model.body_count else None
        self.n_cons = 0
        N = model.particle_count
        if N == 0:
            return
        dev = model.device
        pairs, rest, w = cloth_constraints(model, bend_scale)
        self.n_cons = len(pairs)
        self.ci = pairs
        self.c_w = w
        self._a = torch.as_tensor(pairs[:, 0], device=dev)
        self._b = torch.as_tensor(pairs[:, 1], device=dev)
        self.c_rest = torch.as_tensor(rest, device=dev)
        self.w = torch.as_tensor(w, dtype=torch.float32, device=dev)
        # each vertex's incident constraints in ascending order, padded
        # with weight 0 (constraint 0, neighbour 0): (N, K) neighbour,
        # constraint index and sign (+1 where the vertex is the pair's
        # first end, -1 its second, 0 a pad)
        n = len(pairs)
        T = FixedOrderSum(np.concatenate([pairs[:, 0], pairs[:, 1]]), N,
                          dev).table.cpu().numpy()
        pad = T == 2 * n
        other = np.concatenate([pairs[:, 1], pairs[:, 0], [0]])
        self._nbr = torch.as_tensor(other[T], device=dev)
        self._nbr_con = torch.as_tensor(np.where(pad, 0, T % max(n, 1)),
                                        device=dev)
        self._nbr_sgn = torch.as_tensor(
            np.where(pad, 0.0, np.where(T < n, 1.0, -1.0)),
            dtype=torch.float32, device=dev)[..., None]
        self._nbr_w = self._weights(self.w)
        self._soft_sum = None
        # each vertex's summed constraint weight, in the JAX package's
        # order of accumulation (float64)
        self._deg_w = np.zeros(N)
        np.add.at(self._deg_w, pairs.reshape(-1), np.repeat(w, 2))
        self._diags = {}
        inv_m = model.particle_inv_mass
        self._active = (inv_m > 0)[:, None]
        self._m_eff = torch.where(inv_m > 0, model.particle_mass,
                                  torch.full_like(inv_m, 1e12))
        self._g = particle_gravity(model)
        r = self_contact_radius
        if r is None:
            r = 2.0 * float(np.max(_host(model.particle_radius), initial=0.0))
        self.self_contact_radius = float(r)
        self._grid = HashGrid(cell_size=self.self_contact_radius or 1.0,
                              max_per_cell=self.self_contact_max_per_cell)
        if self.handle_self_contact:
            self._self_excl = torch.as_tensor(one_ring(pairs, N), device=dev)

    def _diag(self, dt: float) -> torch.Tensor:
        """A's diagonal M/h^2 + sum of incident weights (pinned vertices
        take mass 1e12), computed on the host once per ``dt``."""
        d = self._diags.get(dt)
        if d is None:
            m = _host(self.model.particle_mass)
            inv_m = _host(self.model.particle_inv_mass)
            diag_m = np.where(inv_m > 0, m, np.float32(1e12))
            d = torch.as_tensor(diag_m / (dt * dt) + self._deg_w,
                                dtype=torch.float32, device=self.device)
            self._diags[dt] = d
        return d

    def _weights(self, w: torch.Tensor) -> torch.Tensor:
        """(N, K, 1) weights of each vertex's neighbours (0 on pads)."""
        return w[self._nbr_con][..., None] * self._nbr_sgn.abs()

    def _apply_A(self, x: torch.Tensor, diag: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
        """A x for (N, 3) x, matrix-free: each vertex's neighbours summed
        in a fixed order."""
        wn = self._nbr_w if w is self.w else self._weights(w)
        return diag[:, None] * x - (wn * x[self._nbr]).sum(1)

    def _pcg(self, x0: torch.Tensor, rhs: torch.Tensor, diag: torch.Tensor,
             w: torch.Tensor, iters: int) -> torch.Tensor:
        """``iters`` iterations of Jacobi-preconditioned CG from x0 on the
        three axes at once (one step length per axis)."""
        inv_d = (1.0 / diag)[:, None]
        r = rhs - self._apply_A(x0, diag, w)
        z = inv_d * r
        p = z
        rz = (r * z).sum(0)
        x = x0
        for _ in range(iters):
            Ap = self._apply_A(p, diag, w)
            alpha = rz / torch.clamp((p * Ap).sum(0), min=1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = inv_d * r
            rz_new = (r * z).sum(0)
            p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
            rz = rz_new
        return x

    def _self_pairs(self, x0: torch.Tensor):
        idx, msk = self._grid.query(x0, self.self_contact_radius)
        near = (self._self_excl[:, :, None] == idx[:, None, :]).any(1)
        return idx, msk & ~near

    # ------------------------------------------------------------------
    def step(self, state_in: State, state_out: Optional[State] = None,
             control: Optional[Control] = None,
             contacts: Optional[Contacts] = None, dt: float = 1e-3) -> State:
        model = self.model
        N = model.particle_count
        body_q, body_qd = integrate_bodies(model, state_in, dt,
                                           gravity=self._body_g)
        if N == 0 or self.n_cons == 0:
            return replace(state_in, body_q=body_q, body_qd=body_qd)
        inv_m = model.particle_inv_mass[:, None]
        active = self._active
        x0, v0 = state_in.particle_q, state_in.particle_qd
        a_ext = self._g * active + state_in.particle_f * inv_m
        if contacts is not None and contacts.soft_contact_max:
            depth = contacts.soft_contact_depth
            act = contacts.soft_contact_mask & (depth > 0)
            f = torch.where(act[:, None], self.contact_ke * depth[:, None]
                            * contacts.soft_contact_normal, 0.0)
            check_static_slots(contacts, model.structure, soft=True)
            if self._soft_sum is None:
                self._soft_sum = soft_contact_sum(model.structure, N,
                                                  self.device)
            f_con = self._soft_sum(f)
            a_ext = a_ext + f_con * inv_m
        y = x0 + dt * v0 * active + dt * dt * a_ext

        nbr = None
        if self.handle_self_contact and N > 1 and \
                self.self_contact_radius > 0:
            nbr = self._self_pairs(x0)

        diag = self._diag(dt)
        rhs_inertia = (self._m_eff * (1.0 / (dt * dt)))[:, None] * y
        a, b, w = self._a, self._b, self.w
        x = y
        for _ in range(self.iterations):
            d = x[a] - x[b]
            dist = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-9)
            contrib = w[:, None] * (d * (self.c_rest / dist)[:, None])
            rhs = rhs_inertia + (self._nbr_sgn
                                 * contrib[self._nbr_con]).sum(1)
            if nbr is not None:
                idx, msk = nbr
                dd = x[idx] - x[:, None, :]
                dd_len = torch.clamp(torch.linalg.vector_norm(dd, dim=-1),
                                     min=1e-9)
                pen = torch.where(msk, torch.clamp(
                    self.self_contact_radius - dd_len, min=0.0), 0.0)
                push = -dd / dd_len[..., None] * (
                    self.self_contact_ke * pen)[..., None]
                rhs = rhs + push.sum(1)
            x = self._pcg(x, rhs, diag, w, self.PCG_ITERATIONS)
        x = torch.where(active, x, x0)
        v = torch.where(active, (x - x0) / dt, v0)
        return replace(state_in, particle_q=x, particle_qd=v,
                       body_q=body_q, body_qd=body_qd)
