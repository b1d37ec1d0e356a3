"""Implicit Drucker-Prager rheology solve on the MPM grid (port of
``newton_tpu/solvers/mpm_rheology.py``; same formulation and constants).

Strain nodes are grid cells: the stress multiplier lives as a dense
``(res-1)^3 x 6`` field, the strain-rate operator E (node velocities ->
cell sym-grad) and its exact adjoint E^T (cell stress -> nodal force) are
half-cell staggered stencils, and the multiplier is iterated by projected
Jacobi with a power-iteration step cap and per-cell diagonal scaling,
warm-started from ``State.custom["mpm:sigma"]``. Grid-only work: no
particle transfer and no kernel of its own. Every scalar stays a 0-d
tensor on the grid's device, so the solve never waits on the host.
"""

from __future__ import annotations

import torch

__all__ = ["solve_rheology_implicit"]

# vec6 layout: [xx, yy, zz, sqrt2*xy, sqrt2*yz, sqrt2*xz]; the sqrt(2)
# scaling makes the Frobenius norm of the symmetric matrix equal the
# euclidean norm of the vec6.
_SQRT2 = 1.4142135623730951


def _lo(f, ax):
    return f.narrow(ax, 0, f.shape[ax] - 1)


def _hi(f, ax):
    return f.narrow(ax, 1, f.shape[ax] - 1)


def _sym_grad(u, inv_dx):
    """E: node velocities (r, r, r, 3) -> cell strain rate (r-1, ..., 6):
    du_a/dx_b at a cell is the forward difference along b averaged over the
    straddling node pairs along the other two axes."""

    def face_avg(f, axis):
        for ax in range(3):
            if ax == axis:
                f = (_hi(f, ax) - _lo(f, ax)) * inv_dx
            else:
                f = 0.5 * (_hi(f, ax) + _lo(f, ax))
        return f

    g = [[face_avg(u[..., a], b) for b in range(3)] for a in range(3)]
    exy = 0.5 * (g[0][1] + g[1][0])
    eyz = 0.5 * (g[1][2] + g[2][1])
    exz = 0.5 * (g[0][2] + g[2][0])
    return torch.stack([g[0][0], g[1][1], g[2][2], _SQRT2 * exy,
                        _SQRT2 * eyz, _SQRT2 * exz], dim=-1)


def _div(sig, inv_dx):
    """E^T: cell stress (r-1, ..., 6) -> nodal force (r, r, r, 3), the
    exact adjoint of ``_sym_grad`` (zero pad + reversed stencils), so the
    Delassus operator E M^-1 E^T is symmetric PSD."""

    def scatter(f, axis):
        for ax in range(2, -1, -1):
            z = torch.zeros_like(f.narrow(ax, 0, 1))
            fp = torch.cat([z, f, z], dim=ax)
            if ax == axis:
                f = (_lo(fp, ax) - _hi(fp, ax)) * inv_dx
            else:
                f = 0.5 * (_lo(fp, ax) + _hi(fp, ax))
        return f

    off = {(0, 1): 3, (1, 0): 3, (1, 2): 4, (2, 1): 4, (0, 2): 5, (2, 0): 5}
    out = []
    for a in range(3):
        acc = scatter(sig[..., a], a)
        for b in range(3):
            if b != a:
                acc = acc + (_SQRT2 / 2.0) * scatter(sig[..., off[(a, b)]],
                                                     b)
        out.append(acc)
    return torch.stack(out, dim=-1)


def _proj_dp(sig, mu_f, cohesion):
    """Project vec6 multipliers (lam = -sigma_physical, compression has
    positive trace) onto the Drucker-Prager cone q = tr/3 >= 0,
    |dev|_F <= mu_f q + c: the analytic second-order-cone projection."""
    q = (sig[..., 0] + sig[..., 1] + sig[..., 2]) / 3.0
    dev = torch.cat([sig[..., :3] - q[..., None], sig[..., 3:]], dim=-1)
    sn = torch.sqrt(torch.sum(dev * dev, dim=-1) + 1e-30)
    mu = max(mu_f, 1e-6)
    q0 = cohesion / mu
    qs = q + q0
    inside = sn <= mu * qs
    apex = qs + mu * sn <= 0.0
    t = (qs + mu * sn) / (1.0 + mu * mu)
    q_new = torch.where(inside, qs, torch.where(apex, 0.0, t)) - q0
    scale = torch.where(inside, 1.0,
                        torch.where(apex, 0.0,
                                    mu * t / torch.clamp(sn, min=1e-30)))
    out = dev * scale[..., None]
    return torch.cat([out[..., :3] + q_new[..., None], out[..., 3:]], dim=-1)


def solve_rheology_implicit(gv_free, grid_mass, has_mass, proj, res,
                            inv_dx, dt, vol_cell, mu_f, cohesion,
                            sigma0=None, iterations=16, relaxation=1.0,
                            compliance=0.0):
    """Implicit DP grid solve: returns (grid velocities (ncell, 3), stress
    multiplier field (res-1, res-1, res-1, 6)).

    gv_free: (ncell, 3) free grid velocities (after gravity and the wall
    clamp); grid_mass (ncell,); proj: the caller's LINEAR wall/mass
    projector; sigma0: warm start or None; ``compliance`` adds a diagonal
    visco-plastic term (0 = rigid-plastic). The fixed point is
    ``lam = proj_DP(lam - step * E u(lam))`` with
    ``u(lam) = proj(gv_free + dt * vol / m * E^T lam)``.
    """
    dtype, device = gv_free.dtype, gv_free.device
    rc = res - 1
    m_safe = torch.clamp(grid_mass, min=1e-10)[:, None]
    coeff = dt * vol_cell

    def u_of(sig):
        f = _div(sig, inv_dx).reshape(-1, 3)
        return proj(gv_free + coeff * f / m_safe).reshape(res, res, res, 3)

    def Dop(sig):
        f = _div(sig, inv_dx).reshape(-1, 3)
        du = proj(coeff * f / m_safe).reshape(res, res, res, 3)
        return _sym_grad(du, inv_dx) + compliance * sig

    sigma = (torch.zeros((rc, rc, rc, 6), dtype=dtype, device=device)
             if sigma0 is None else sigma0)

    # exact Delassus diagonal: coeff * inv_dx^2 / 16 * sum of 1/m over the
    # cell's 8 corner nodes (massless nodes contribute 0)
    inv_m = torch.where(grid_mass > 1e-10, 1.0 / m_safe[:, 0], 0.0)
    inv_m3 = inv_m.reshape(res, res, res)
    for ax in range(3):
        inv_m3 = _lo(inv_m3, ax) + _hi(inv_m3, ax)
    diag = (coeff * inv_dx * inv_dx / 16.0) * inv_m3 + compliance
    diag = torch.clamp(diag, min=1e-20)[..., None]

    # spectral cap of the diagonally scaled operator: 3 power iterations
    # from Dop of a deterministic non-uniform field (a uniform stress is in
    # the null space of E^T)
    inv_sqrt_d = torch.rsqrt(diag)
    seed = torch.sin(torch.arange(rc * rc * rc * 6, dtype=dtype,
                                  device=device) * 12.9898)
    u = Dop(seed.reshape(rc, rc, rc, 6))
    u = u / torch.clamp(torch.sqrt(torch.sum(u * u)), min=1e-30)
    lam_max = None
    for it in range(3):
        u2 = inv_sqrt_d * Dop(inv_sqrt_d * u)
        nrm = torch.sqrt(torch.sum(u2 * u2))
        if it == 2:
            lam_max = nrm
        u = u2 / torch.clamp(nrm, min=1e-30)
    scale = torch.clamp(1.8 / torch.clamp(1.1 * lam_max, min=1e-9), max=1.0)
    step = (relaxation * scale) / diag

    for _ in range(iterations):
        uu = u_of(sigma)
        e = _sym_grad(uu, inv_dx) + compliance * sigma
        sigma = _proj_dp(sigma - step * e, mu_f, cohesion)
        sigma = torch.where(torch.isfinite(sigma), sigma, 0.0)
    return u_of(sigma).reshape(-1, 3), sigma
