"""``SolverKamino``: proximal ADMM over second-order cones (port of
``_island_partition`` and ``SolverKamino`` in
``newton_tpu/solvers/generalized/solver.py``).

The generalized substep of ``SolverFeatherstone`` with another contact
solve: the frictional contact problem (and the limit rows) by ``iterations``
PADMM sweeps

    lam_hat = (A + rho I)^-1 (rho (z - u) - q)     [Cholesky, exact]
    z       = Pi_K(lam_hat + u)                    [SOC projection]
    u       = u + lam_hat - z

with A = [J; E] M^-1 [J; E]^T + reg (the other body's point inverse mass
on a two-sided row's diagonal), inactive rows decoupled onto the identity,
and rho scaled by the mean of A's diagonal. Where a group's contact plan
splits into several islands (connected components of the dofs that
contacts and limits couple), the rows are taken uncapped and the factor is
one (rb, rb) block per island, planned once on the host at construction;
otherwise the dense (r, r) factor of the capped rows. Friction defaults to
the cone and Baumgarte to 0.3. The factor and solves are
``torch.linalg.cholesky_ex`` (no error check, no host sync) and
``torch.cholesky_solve``: the counterparts of the JAX package's
``jnp.linalg.cholesky`` and ``cho_solve``, library calls, not the port of
a kernel. The port keeps rows in block order [n | t1 | t2 | lim-lo |
lim-hi]; the island tables are planned in the JAX package's interleaved
order and permuted.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...sim.model import Model
from .solver import SolverFeatherstone

__all__ = ["SolverKamino", "island_partition"]


def island_partition(g, plan, limit_plan):
    """Host-side contact-island partition of a group's rows, in the JAX
    package's interleaved layout [3 c contact rows (3 i + {n, t1, t2}) |
    nl lim-lo | nl lim-hi] of an uncapped plan: (P, n_isl, rb), P (n_isl,
    rb) int32 row indices padded with r, or None when the plan is ragged
    or every row couples into one island. Two rows couple where their dof
    supports overlap: dofs of one body chain (M^-1 is block-diagonal across
    them) or the two bodies of one contact."""
    lb0, lb1 = np.asarray(plan.lb0), np.asarray(plan.lb1)
    if lb0.ndim != 1:
        return None
    c = int(plan.c)
    anc = np.asarray(g.anc) != 0               # (b, d)
    d = anc.shape[1]
    parent = np.arange(d + 1)                  # node d: the static world

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb_ = find(a), find(b)
        if ra != rb_:
            parent[rb_] = ra

    body_rep = np.full(anc.shape[0], d, dtype=np.int64)
    for b in range(anc.shape[0]):
        dofs = np.nonzero(anc[b])[0]
        if len(dofs):
            body_rep[b] = dofs[0]
            for j in dofs[1:]:
                union(dofs[0], int(j))
    for i in range(c):
        r0 = body_rep[lb0[i]] if lb0[i] >= 0 else d
        r1 = body_rep[lb1[i]] if lb1[i] >= 0 else d
        if r0 != d and r1 != d:
            union(int(r0), int(r1))
    nl = len(limit_plan[0]) if (limit_plan is not None
                                and len(limit_plan[0])) else 0
    r = 3 * c + 2 * nl
    row_isl = np.empty(r, dtype=np.int64)
    for i in range(c):
        rep = body_rep[lb0[i]] if lb0[i] >= 0 else (
            body_rep[lb1[i]] if lb1[i] >= 0 else d)
        row_isl[3 * i:3 * i + 3] = find(int(rep)) if rep != d else d
    if nl:
        ld = np.asarray(limit_plan[0])
        for j in range(nl):
            rid = find(int(ld[j]))
            row_isl[3 * c + j] = rid
            row_isl[3 * c + nl + j] = rid
    ids = np.unique(row_isl)
    if len(ids) < 2:
        return None
    rows_by = [np.nonzero(row_isl == i)[0] for i in ids]
    rb = max(len(rr) for rr in rows_by)
    P = np.full((len(ids), rb), r, dtype=np.int32)
    for k, rr in enumerate(rows_by):
        P[k, :len(rr)] = rr
    return P, len(ids), rb


def _to_block_order(P, c):
    """Interleaved row indices (3 i + k) -> block order (k c + i); limit
    rows and the pad index r stay."""
    P = np.asarray(P, dtype=np.int64)
    contact = P < 3 * c
    return np.where(contact, (P % 3) * c + P // 3, P)


class SolverKamino(SolverFeatherstone):
    """Constrained multibody solver for kinematic loops and hard frictional
    contact (the JAX package's PADMM ``SolverKamino``): the parent's
    velocity-level step, with the contact and limit impulses from proximal
    ADMM over second-order cones and a direct factorization per env (per
    island where the plan splits). Equality rows (CONNECT, WELD, JOINT
    loops) are solved exactly against the mass matrix, as in the parent."""

    use_admm = True

    def __init__(self, model: Model, iterations: int = 32, rho: float = 0.1,
                 use_islands: bool = True, **kwargs):
        kwargs.setdefault("friction_cone", "cone")
        kwargs.setdefault("baumgarte", 0.3)
        self.admm_rho = float(rho)
        self.use_islands = bool(use_islands)
        self.island_plans = None
        super().__init__(model, contact_iterations=iterations, **kwargs)
        self.contact_solver = "admm"

    def _islands(self, grp):
        """The group's island plan (planned once, on the host), or None: the
        dense factor (one island, a ragged plan, islands off, or a positive
        contact_cap, which takes the dense top-K rows)."""
        if self.island_plans is None:
            cap = self.contact_cap
            self.island_plans = [
                island_partition(g.g, g.plan, g.limit_plan
                                 if self.limit_mode == "constraint" else None)
                if (self.use_islands and g.plan is not None and g.g.d
                    and not (cap and cap > 0)) else None
                for g in self.groups]
        return self.island_plans[grp.index]

    def _plan_cap(self, c: int, grp=None) -> int:
        if grp is not None and self._islands(grp) is not None:
            return c              # the island blocks take every row
        return super()._plan_cap(c, grp)

    def _build_tables(self, grp):
        t = super()._build_tables(grp)
        isl = self._islands(grp)
        t.islands = None
        if isl is not None:
            P, n_isl, rb = isl
            Pb = _to_block_order(P, grp.plan.c)
            dev = self.model.device
            r = 3 * grp.plan.c + 2 * t.nl
            t.islands = (torch.as_tensor(np.minimum(Pb, r - 1), device=dev),
                         torch.as_tensor(Pb >= r, device=dev),
                         torch.as_tensor(Pb.reshape(-1), device=dev),
                         n_isl, rb)
        return t


def solve_contacts_admm(solver, t, J, Minv, qd, b, act, mu, lam0, *, c, E,
                        w_other=None, record: Optional[dict] = None):
    """The PADMM contact and limit solve of one group's rows (operands as
    B2's, block order; ``E`` (nl, d) the limit rows' one-hots). Returns
    (lam (W, r), dqd (W, d))."""
    W, _, d = J.shape
    nl = E.shape[0]
    rows = [J]
    if nl:
        E = E.expand(W, nl, d)
        rows += [E, -E]
    Jf = torch.cat(rows, dim=1)                              # (W, r, d)
    r = Jf.shape[1]
    MinvJt = Minv @ Jf.transpose(1, 2)                       # (W, d, r)
    msk = act.to(J.dtype)
    q = ((Jf @ qd[:, :, None])[..., 0] - b) * msk
    extra = torch.full((W, r), solver.contact_reg, dtype=J.dtype,
                       device=J.device)
    if w_other is not None:
        # the other body's point inverse mass on a two-sided row
        extra[:, :3 * c] = extra[:, :3 * c] + w_other
    if t.islands is not None:
        Pc, pad, P_flat, n_isl, rb = t.islands
        Jb = Jf[:, Pc]                                       # (W, I, rb, d)
        MJb = MinvJt.transpose(1, 2)[:, Pc]                  # (W, I, rb, d)
        A = Jb @ MJb.transpose(-1, -2)                       # (W, I, rb, rb)
        eye = torch.eye(rb, dtype=J.dtype, device=J.device)
        A = A + torch.diag_embed(extra[:, Pc])
        # inactive and pad rows decoupled onto the identity
        mb = msk[:, Pc] * (~pad).to(J.dtype)
        mm = mb[..., :, None] * mb[..., None, :]
        A = A * mm + (1.0 - mm) * eye
        diag = torch.diagonal(A, dim1=-2, dim2=-1)
        diag_mean = (diag * (~pad).to(J.dtype)).sum((1, 2)) / float(r)
        rho = solver.admm_rho * torch.clamp(diag_mean, min=1e-9)   # (W,)
        K = A + rho[:, None, None, None] * eye
        if record is not None:
            record["admm_factor"] = K
        L = torch.linalg.cholesky_ex(K, check_errors=False)[0]

        def dsolve(rhs):
            s = torch.cholesky_solve(rhs[:, Pc][..., None], L)[..., 0]
            out = rhs.new_zeros(W, r + 1)
            out[:, P_flat] = s.reshape(W, n_isl * rb)
            return out[:, :r]
    else:
        A = Jf @ MinvJt + torch.diag_embed(extra)
        eye = torch.eye(r, dtype=J.dtype, device=J.device)
        mm = msk[:, :, None] * msk[:, None, :]
        A = A * mm + (1.0 - mm) * eye
        diag_mean = torch.diagonal(A, dim1=1, dim2=2).mean(-1)
        rho = solver.admm_rho * torch.clamp(diag_mean, min=1e-9)
        K = A + rho[:, None, None] * eye
        if record is not None:
            record["admm_factor"] = K
        L = torch.linalg.cholesky_ex(K, check_errors=False)[0]

        def dsolve(rhs):
            return torch.cholesky_solve(rhs[..., None], L)[..., 0]
    rho = rho[:, None]
    actb = act > 0

    def proj(x):
        """The admissible set: a second-order cone per contact, lam >= 0 on
        the limit rows, 0 on inactive rows."""
        ln, lt1, lt2 = x[:, 0:c], x[:, c:2 * c], x[:, 2 * c:3 * c]
        tmag = torch.sqrt(lt1 * lt1 + lt2 * lt2 + 1e-18)
        inside = tmag <= mu * ln
        below = mu * tmag <= -ln
        lnp = torch.clamp((ln + mu * tmag) / (1.0 + mu * mu), min=0.0)
        scale = torch.where(tmag > 1e-12, mu * lnp / tmag, 0.0)
        ln_o = torch.where(inside, ln, torch.where(below, 0.0, lnp))
        sc_o = torch.where(inside, 1.0, torch.where(below, 0.0, scale))
        parts = [ln_o, lt1 * sc_o, lt2 * sc_o]
        if nl:
            parts.append(torch.clamp(x[:, 3 * c:], min=0.0))
        return torch.where(actb, torch.cat(parts, dim=1), 0.0)

    z = lam0
    u = torch.zeros_like(z)
    for _ in range(solver.contact_iterations):
        lam_hat = dsolve(rho * (z - u) - q)
        z = proj(lam_hat + u)
        u = u + lam_hat - z
    z = torch.where(torch.isfinite(z), z, torch.zeros_like(z))
    return z, (MinvJt @ z[:, :, None])[..., 0]
