"""MPM solver: MLS-MPM on a fixed dense grid with Drucker-Prager sand (port
of ``newton_tpu/solvers/solver_mpm.py``).

Every phase is batched tensor work on a static ``res^3`` grid: stress and
plasticity per particle, P2G, the grid update (gravity, wall clamp and
optionally the semi-implicit CG solve or the implicit rheology solve),
G2P. The particle<->grid transfers go through ``mpm_transfer``'s wrappers:
the hand-written CUDA kernels on the card, their plain PyTorch versions on
the CPU (or with ``kernels=False``).

The port has one transfer layout, the one the JAX package's transfer
kernels use. P2G scatters 13 channels ``[mass | m v - dx A xp | dx A]`` and
recombines the APIC momentum on the grid with the node coordinates; G2P
gathers 12 channels ``[gv | gv I | gv J | gv K]`` and separates the affine
update the same way. Particle state beyond the Model arrays (F, C, Jp, the
rheology multiplier) lives in ``State.custom["mpm:..."]``; call
:meth:`SolverImplicitMPM.init_state` once after ``model.state()``.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from ..sim.contacts import Contacts
from ..sim.control import Control
from ..sim.model import Model
from ..sim.state import State
from . import mpm_transfer
from .mpm_rheology import solve_rheology_implicit
from .solver import SolverBase

__all__ = ["SolverImplicitMPM", "SolverMPM"]


def _bmm3(a, b):
    """Batched 3x3 product as elementwise work: (..., 3, 3) @ (..., 3, 3)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _usv(U, sig, Vt):
    return _bmm3(U * sig[..., None, :], Vt)


class SolverImplicitMPM(SolverBase):
    """MLS-MPM granular/elastic media solver; same arguments and defaults
    as the JAX package's ``SolverImplicitMPM``.

    Args:
        grid_lower/grid_upper: fixed world-space grid bounds.
        resolution: cells per axis.
        young/poisson: elastic moduli.
        friction_angle: Drucker-Prager friction angle (radians); None for
            purely elastic material.
        material: "sand", "snow" (singular-value clamp + hardening) or
            "viscous" (deviatoric relaxation); ``material_id`` (N,) with
            0 = sand, 1 = snow, 2 = viscous selects per particle ("mixed").
        implicit_iterations: CG iterations of the semi-implicit grid
            velocity solve (0 = explicit).
        rheology: "explicit", or "implicit" for the grid Drucker-Prager
            solve of ``mpm_rheology`` (sand only).
    """

    def __init__(self, model: Model,
                 grid_lower=(-1.0, -1.0, 0.0), grid_upper=(1.0, 1.0, 2.0),
                 resolution: int = 64, young: float = 1.0e5,
                 poisson: float = 0.3, friction_angle: Optional[float] = 0.5,
                 cohesion: float = 0.0, implicit_iterations: int = 0,
                 material: str = "sand",
                 snow_theta_c: float = 2.5e-2, snow_theta_s: float = 7.5e-3,
                 snow_hardening: float = 10.0,
                 viscous_relax: float = 0.5,
                 material_id=None,
                 rheology: str = "explicit",
                 rheology_iterations: int = 16,
                 rheology_compliance: float = 0.0):
        if material not in ("sand", "snow", "viscous"):
            raise ValueError(f"unknown material {material!r}")
        if rheology not in ("explicit", "implicit"):
            raise ValueError(f"unknown rheology {rheology!r}")
        if rheology == "implicit" and material != "sand":
            raise ValueError("rheology='implicit' is the granular "
                             "Drucker-Prager grid solve; it requires "
                             "material='sand'")
        super().__init__(model)
        dev = model.device
        self.material = material
        self.material_id = None
        if material_id is not None:
            self.material_id = torch.as_tensor(
                np.asarray(material_id, dtype=np.int32), device=dev)
            self.material = "mixed"
        self.snow_theta_c = float(snow_theta_c)
        self.snow_theta_s = float(snow_theta_s)
        self.snow_hardening = float(snow_hardening)
        self.viscous_relax = float(viscous_relax)
        self.implicit_iterations = int(implicit_iterations)
        self.rheology = rheology
        self.rheology_iterations = int(rheology_iterations)
        self.rheology_compliance = float(rheology_compliance)
        lower = np.asarray(grid_lower, dtype=np.float64)
        upper = np.asarray(grid_upper, dtype=np.float64)
        self.res = res = int(resolution)
        self.dx = float((upper - lower).max() / res)
        self.inv_dx = 1.0 / self.dx
        E, nu = float(young), float(poisson)
        self.mu0 = E / (2 * (1 + nu))
        self.lam0 = E * nu / ((1 + nu) * (1 - 2 * nu))
        self.friction_angle = friction_angle
        self.cohesion = float(cohesion)

        # static grid tensors: node coordinates (in cells), the wall bands
        # of the sign-aware clamp, and the mean gravity over the particles'
        # worlds (global particles read world 0)
        f32 = torch.float32
        self._lower = torch.as_tensor(lower, dtype=f32, device=dev)
        ii = torch.arange(res, device=dev)
        g = torch.stack(torch.meshgrid(ii, ii, ii, indexing="ij"),
                        dim=-1).reshape(-1, 3)
        self._crd = g.to(f32)                                  # (ncell, 3)
        bound = 3
        self._wall_lo = g < bound
        self._wall_hi = g >= res - bound
        self._wall = self._wall_lo | self._wall_hi
        w_idx = np.maximum(model.structure.particle_world, 0)
        self._gravity = model.gravity[torch.as_tensor(
            w_idx, dtype=torch.long, device=dev)].mean(dim=0) \
            if len(w_idx) else model.gravity[0]
        self._eye = torch.eye(3, dtype=f32, device=dev)

    # ------------------------------------------------------------------
    def init_state(self, state: State) -> State:
        N = self.model.particle_count
        x = state.particle_q
        custom = dict(state.custom)
        custom["mpm:F"] = torch.eye(3, dtype=x.dtype, device=x.device) \
            .expand(N, 3, 3).clone()
        custom["mpm:C"] = torch.zeros((N, 3, 3), dtype=x.dtype,
                                      device=x.device)
        if self.material in ("snow", "mixed"):
            custom["mpm:Jp"] = torch.ones((N,), dtype=x.dtype,
                                          device=x.device)
        if self.rheology == "implicit":
            rc = self.res - 1
            custom["mpm:sigma"] = torch.zeros((rc, rc, rc, 6), dtype=x.dtype,
                                              device=x.device)
        return replace(state, custom=custom)

    def stencil(self, x: torch.Tensor, binned: bool = False):
        """Grid coordinates ``xp`` (N, 3), lower stencil nodes ``base``
        (N, 3) int32, quadratic B-spline weights ``w_ax`` (N, 3 offsets,
        3 axes) of particle positions ``x`` and, with ``binned``, the
        particles' tile binning ``mpm_transfer.bin_particles(base, res)``
        (else None): the transfers' operands."""
        xp = (x - self._lower) * self.inv_dx
        base = torch.floor(xp - 0.5).to(torch.int32)
        fx = xp - base.to(x.dtype)                     # in [0.5, 1.5]
        w_ax = torch.stack([0.5 * (1.5 - fx) ** 2, 0.75 - (fx - 1.0) ** 2,
                            0.5 * (fx - 0.5) ** 2], dim=1).contiguous()
        bins = mpm_transfer.bin_particles(base, self.res) if binned else None
        return xp, base, w_ax, bins

    # ------------------------------------------------------------------
    def _projected_stress(self, F_in, Jp):
        """(F_projected, P(F) F^T, Jp_new) with the material's plasticity."""
        U, sig, Vt = _svd3(F_in)
        mu_p, lam_p, Jp_new = self.mu0, self.lam0, Jp

        def snow(sig):
            sig_c = torch.clamp(sig, 1.0 - self.snow_theta_c,
                                1.0 + self.snow_theta_s)
            Jp_s = torch.clamp(Jp * sig.prod(-1) / torch.clamp(
                sig_c.prod(-1), min=1e-9), 0.1, 10.0)
            h = torch.exp(torch.clamp(self.snow_hardening * (1.0 - Jp_s),
                                      -5.0, 5.0))
            return sig_c, Jp_s, h

        def viscous(sig):
            mean = sig.prod(-1, keepdim=True) ** (1.0 / 3.0)
            return sig + self.viscous_relax * (mean - sig)

        if self.material == "snow":
            sig, Jp_new, h = snow(sig)
            mu_p, lam_p = self.mu0 * h, self.lam0 * h
            F_p = _usv(U, sig, Vt)
        elif self.material == "viscous":
            sig = viscous(sig)
            F_p = _usv(U, sig, Vt)
        elif self.material == "mixed":
            mid = self.material_id
            fa = 0.5 if self.friction_angle is None else self.friction_angle
            sig_sand = _drucker_prager_project(sig, fa, self.cohesion)
            sig_c, Jp_snow, h = snow(sig)
            sig_v = viscous(sig)
            sig = torch.where((mid == 1)[:, None], sig_c,
                              torch.where((mid == 2)[:, None], sig_v,
                                          sig_sand))
            Jp_new = torch.where(mid == 1, Jp_snow, Jp)
            hmul = torch.where(mid == 1, h, 1.0)
            mu_p, lam_p = self.mu0 * hmul, self.lam0 * hmul
            F_p = _usv(U, sig, Vt)
        elif self.friction_angle is not None:
            sig = _drucker_prager_project(sig, self.friction_angle,
                                          self.cohesion)
            F_p = _usv(U, sig, Vt)
        else:
            F_p = F_in
        J = sig.prod(-1)
        R = _bmm3(U, Vt)
        if isinstance(mu_p, float):
            mu_p = torch.full_like(J, mu_p)
            lam_p = torch.full_like(J, lam_p)
        PFt = (2 * mu_p[:, None, None] * _bmm3(F_p - R, F_p.transpose(1, 2))
               + (lam_p * J * (J - 1.0))[:, None, None] * self._eye)
        return F_p, PFt, Jp_new

    # ------------------------------------------------------------------
    def step(self, state_in: State, state_out: Optional[State] = None,
             control: Optional[Control] = None,
             contacts: Optional[Contacts] = None, dt: float = 1e-3, *,
             kernels: bool = True) -> State:
        """One MPM step. With ``kernels`` (the default) the particles are
        binned by grid tile once and the bins passed to every transfer;
        ``kernels=False`` runs the plain PyTorch transfer versions instead
        of the CUDA kernels (the comparison path on the card; on the CPU
        both are the plain versions)."""
        model = self.model
        N = model.particle_count
        if N == 0:
            return state_in
        if "mpm:F" not in state_in.custom:
            state_in = self.init_state(state_in)
        x = state_in.particle_q
        v = state_in.particle_qd
        C = state_in.custom["mpm:C"]
        m = model.particle_mass
        dtype = x.dtype
        res = self.res
        ncell = res ** 3
        dx, inv_dx = self.dx, self.inv_dx
        vol0 = (0.5 * dx) ** 3
        crd = self._crd

        F, PFt, Jp_new = self._projected_stress(
            state_in.custom["mpm:F"], state_in.custom.get("mpm:Jp"))
        stress_coeff = -dt * vol0 * 4.0 * inv_dx * inv_dx
        if self.rheology == "implicit":
            # the granular stress lives on the grid (solve below)
            affine = m[:, None, None] * C
        else:
            affine = stress_coeff * PFt + m[:, None, None] * C

        # one binning per step, shared by every transfer of the step
        xp, base, w_ax, bins = self.stencil(x, binned=kernels)
        if kernels:
            def p2g(base, w_ax, vals, res):
                return mpm_transfer.p2g_apply(base, w_ax, vals, res, bins)

            def g2p(base, w_ax, grid):
                return mpm_transfer.g2p_apply(base, w_ax, grid, bins)
        else:
            p2g = mpm_transfer.p2g_apply_plain
            g2p = mpm_transfer.g2p_apply_plain

        def p2g_grid(affine, with_mass_vel):
            """P2G of the per-particle affine term (plus mass and momentum):
            (grid mass or None, grid momentum (ncell, 3))."""
            c0 = -dx * (affine * xp[:, None, :]).sum(-1)
            if with_mass_vel:
                c0 = c0 + m[:, None] * v
                mass_ch = m[:, None]
            else:
                mass_ch = torch.zeros((N, 1), dtype=dtype, device=x.device)
            vals = torch.cat([mass_ch, c0, (dx * affine).reshape(N, 9)],
                             dim=1)
            G = p2g(base, w_ax, vals, res).reshape(ncell, 13)
            A_g = G[:, 4:13].reshape(ncell, 3, 3)
            grid_mom = G[:, 1:4] + (A_g * crd[:, None, :]).sum(-1)
            return (G[:, 0] if with_mass_vel else None), grid_mom

        def bc(gv):
            """Wall clamp: zero the inward normal velocity in the bands."""
            inward = (self._wall_lo & (gv < 0)) | (self._wall_hi & (gv > 0))
            return torch.where(inward, 0.0, gv)

        def g2p_vel(gv):
            """G2P: particle velocities and affine velocity gradients."""
            gv_grid = gv.reshape(res, res, res, 3)
            crd4 = crd.reshape(res, res, res, 3)
            gch = torch.cat([gv_grid] + [gv_grid * crd4[..., e:e + 1]
                                         for e in range(3)], dim=-1)
            P = g2p(base, w_ax, gch)
            v_new = P[:, 0:3]
            S_ne = P[:, 3:12].reshape(N, 3, 3)              # [e, d]
            C_new = (4.0 * inv_dx * inv_dx * dx
                     * (S_ne.transpose(1, 2)
                        - v_new[:, :, None] * xp[:, None, :]))
            return v_new, C_new

        grid_mass, grid_mom = p2g_grid(affine, with_mass_vel=True)
        has_mass = grid_mass > 1e-10
        gv = grid_mom / torch.clamp(grid_mass, min=1e-10)[:, None]
        gv = gv + dt * self._gravity[None, :]
        gv = torch.where(has_mass[:, None], gv, 0.0)
        gv = bc(gv)

        def lin_proj(u):
            """LINEAR wall/mass projector of both implicit solves: zero
            normal components in the wall bands and on massless nodes (the
            sign-aware clamp would break the operators' symmetry)."""
            u = u * has_mass[:, None]
            return torch.where(self._wall, 0.0, u)

        sigma_new = None
        if self.rheology == "implicit":
            fa = 0.5 if self.friction_angle is None else \
                float(self.friction_angle)
            gv, sigma_new = solve_rheology_implicit(
                lin_proj(gv), grid_mass, has_mass, lin_proj, res,
                inv_dx, dt, vol_cell=dx ** 3,
                mu_f=float(np.tan(fa)), cohesion=self.cohesion,
                sigma0=state_in.custom.get("mpm:sigma"),
                iterations=self.rheology_iterations,
                compliance=self.rheology_compliance)
            gv = bc(gv)

        if self.implicit_iterations > 0 and self.rheology != "implicit":
            # semi-implicit velocity solve: CG on
            #   A(u) = P(m u - D(P u)) + (I - P) u,
            #   D(u) = P2G(coeff * sigma_lin(grad u)),
            # sigma_lin the small-strain elastic tangent, P = lin_proj.
            # alpha and beta stay 0-d device tensors: no host sync.
            m_safe = torch.clamp(grid_mass, min=1e-10)[:, None]

            def D_op(u):
                _, C_u = g2p_vel(u)
                sym = 0.5 * (C_u + C_u.transpose(1, 2))
                trc = (C_u[:, 0, 0] + C_u[:, 1, 1]
                       + C_u[:, 2, 2])[:, None, None]
                sig_lin = dt * (2.0 * self.mu0 * sym
                                + self.lam0 * trc * self._eye)
                return p2g_grid(stress_coeff * sig_lin, False)[1]

            def A_op(u):
                pu = lin_proj(u)
                return lin_proj(m_safe * pu - D_op(pu)) + (u - pu)

            b_rhs = lin_proj(m_safe * gv)
            u = lin_proj(gv)
            r = b_rhs - A_op(u)
            p = r
            rs = torch.sum(r * r)
            for _ in range(self.implicit_iterations):
                Ap = A_op(p)
                alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-20)
                u = u + alpha * p
                r = r - alpha * Ap
                rs_new = torch.sum(r * r)
                beta = rs_new / torch.clamp(rs, min=1e-20)
                p = r + beta * p
                rs = rs_new
            gv = lin_proj(u)

        v_new, C_new = g2p_vel(gv)
        x_new = x + dt * v_new
        F_new = _bmm3(self._eye + dt * C_new, F)

        # fixed (inv_mass == 0) particles keep their state
        active = (model.particle_inv_mass > 0)[:, None]
        x_new = torch.where(active, x_new, x)
        v_new = torch.where(active, v_new, v)

        custom = dict(state_in.custom)
        custom["mpm:F"] = F_new
        custom["mpm:C"] = C_new
        if self.material in ("snow", "mixed"):
            custom["mpm:Jp"] = Jp_new
        if sigma_new is not None:
            custom["mpm:sigma"] = sigma_new
        return replace(state_in, particle_q=x_new, particle_qd=v_new,
                       custom=custom)


SolverMPM = SolverImplicitMPM


def _det3(M):
    """Determinant of (..., 3, 3) matrices by cofactors."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _svd3(F):
    """Batched 3x3 SVD (``torch.linalg.svd``) with the JAX package's sign
    correction: U and V proper rotations, the sign of det F moved into the
    last singular value. The same on both devices; ``_svd3_jacobi`` is the
    elementwise alternative, kept off the path (in eager mode its ~900
    elementwise ops would be ~900 launches per step). A matrix with a
    non-finite entry (a diverged particle) gives NaN factors, as the JAX
    package's SVD does, where ``torch.linalg.svd`` would raise."""
    bad = ~torch.isfinite(F).all(dim=-1).all(dim=-1)
    F = torch.where(bad[:, None, None], torch.eye(3, dtype=F.dtype,
                                                  device=F.device), F)
    U, s, Vt = torch.linalg.svd(F)
    nan = torch.full((), float("nan"), dtype=F.dtype, device=F.device)
    U = torch.where(bad[:, None, None], nan, U)
    Vt = torch.where(bad[:, None, None], nan, Vt)
    s = torch.where(bad[:, None], nan, s)
    su = torch.sign(_det3(U))
    sv = torch.sign(_det3(Vt))
    one = torch.ones_like(su)
    U = U * torch.stack([one, one, su], dim=-1)[:, None, :]
    Vt = Vt * torch.stack([one, one, sv], dim=-1)[:, :, None]
    s = s * torch.stack([one, one, su * sv], dim=-1)
    return U, s, Vt


def _svd3_jacobi(F):
    """Componentwise fixed-sweep Jacobi SVD (port of the JAX package's
    ``_svd3_jacobi``): 4 cyclic Jacobi sweeps on F^T F, sorted singular
    values, U from F V by Gram-Schmidt with the sign of det F in sig[2]."""
    f = [[F[:, i, j] for j in range(3)] for i in range(3)]
    s00 = f[0][0] * f[0][0] + f[1][0] * f[1][0] + f[2][0] * f[2][0]
    s11 = f[0][1] * f[0][1] + f[1][1] * f[1][1] + f[2][1] * f[2][1]
    s22 = f[0][2] * f[0][2] + f[1][2] * f[1][2] + f[2][2] * f[2][2]
    s01 = f[0][0] * f[0][1] + f[1][0] * f[1][1] + f[2][0] * f[2][1]
    s02 = f[0][0] * f[0][2] + f[1][0] * f[1][2] + f[2][0] * f[2][2]
    s12 = f[0][1] * f[0][2] + f[1][1] * f[1][2] + f[2][1] * f[2][2]
    one = torch.ones_like(s00)
    zero = torch.zeros_like(s00)
    V = [[one, zero, zero], [zero, one, zero], [zero, zero, one]]

    def rotate(a, b, d, e, fq):
        """One Jacobi rotation zeroing d in [[a, d], [d, b]]; e, fq are the
        two off-pivot entries that mix. Returns (a, b, d, e, fq, c, s)."""
        th = 0.5 * torch.atan2(2.0 * d, b - a)
        c, s = torch.cos(th), torch.sin(th)
        return (c * c * a - 2 * c * s * d + s * s * b,
                s * s * a + 2 * c * s * d + c * c * b,
                c * s * (a - b) + (c * c - s * s) * d,
                c * e - s * fq, s * e + c * fq, c, s)

    def rot_cols(p, q, c, s):
        for i in range(3):
            a, b = V[i][p], V[i][q]
            V[i][p], V[i][q] = c * a - s * b, s * a + c * b

    for _ in range(4):
        s00, s11, s01, s02, s12, c, s = rotate(s00, s11, s01, s02, s12)
        rot_cols(0, 1, c, s)
        s00, s22, s02, s01, s12, c, s = rotate(s00, s22, s02, s01, s12)
        rot_cols(0, 2, c, s)
        s11, s22, s12, s01, s02, c, s = rotate(s11, s22, s12, s01, s02)
        rot_cols(1, 2, c, s)
    eig = [s00, s11, s22]

    def colswap(i, j):
        do = eig[i] < eig[j]
        eig[i], eig[j] = (torch.where(do, eig[j], eig[i]),
                          torch.where(do, eig[i], eig[j]))
        for r in range(3):
            vi, vj = V[r][i], V[r][j]
            V[r][i] = torch.where(do, vj, vi)
            V[r][j] = torch.where(do, vi, vj)

    colswap(0, 1)
    colswap(0, 2)
    colswap(1, 2)
    sig = [torch.sqrt(torch.clamp(e, min=0.0)) for e in eig]
    detV = (V[0][0] * (V[1][1] * V[2][2] - V[1][2] * V[2][1])
            - V[0][1] * (V[1][0] * V[2][2] - V[1][2] * V[2][0])
            + V[0][2] * (V[1][0] * V[2][1] - V[1][1] * V[2][0]))
    sgn = torch.where(detV < 0.0, -1.0, 1.0)
    for r in range(3):
        V[r][2] = V[r][2] * sgn

    def matcol(M, col):
        return [sum(M[r][k] * col[k] for k in range(3)) for r in range(3)]

    FV = [matcol(f, [V[0][j], V[1][j], V[2][j]]) for j in range(3)]

    def norm3(v):
        return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])

    u0 = [x / torch.clamp(sig[0], min=1e-9) for x in FV[0]]
    n0 = torch.clamp(norm3(u0), min=1e-9)
    u0 = [x / n0 for x in u0]
    d01 = sum(a * b for a, b in zip(FV[1], u0))
    u1 = [a - d01 * b for a, b in zip(FV[1], u0)]
    n1 = torch.clamp(norm3(u1), min=1e-9)
    u1 = [x / n1 for x in u1]
    u2 = [u0[1] * u1[2] - u0[2] * u1[1],
          u0[2] * u1[0] - u0[0] * u1[2],
          u0[0] * u1[1] - u0[1] * u1[0]]
    s2_sign = torch.where(sum(a * b for a, b in zip(u2, FV[2])) < 0.0,
                          -1.0, 1.0)
    U = torch.stack([torch.stack(u0, dim=-1), torch.stack(u1, dim=-1),
                     torch.stack(u2, dim=-1)], dim=-1)
    sig_out = torch.stack([sig[0], sig[1], sig[2] * s2_sign], dim=-1)
    Vt = torch.stack([torch.stack([V[0][j], V[1][j], V[2][j]], dim=-1)
                      for j in range(3)], dim=1)
    return U, sig_out, Vt


def _drucker_prager_project(sig, friction_angle, cohesion):
    """Return-map the principal stretches onto the Drucker-Prager cone
    (Klar et al. 2016): in log-strain space, expansion projects to the tip
    and yielding scales the deviator back to the cone."""
    sin_fa = float(np.sin(friction_angle))
    alpha = float(np.sqrt(2.0 / 3.0)) * 2.0 * sin_fa / (3.0 - sin_fa)
    eps = torch.log(torch.clamp(sig, min=1e-6)) - cohesion
    tr = eps.sum(-1, keepdim=True)
    dev = eps - tr / 3.0
    dev_norm = torch.linalg.vector_norm(dev, dim=-1, keepdim=True)
    dg = dev_norm + alpha * tr
    scale = torch.where(dev_norm > 1e-9,
                        torch.clamp(1.0 - dg / torch.clamp(dev_norm,
                                                           min=1e-9),
                                    min=0.0),
                        0.0)
    eps_proj = torch.where(tr > 0, torch.zeros_like(eps),
                           torch.where(dg > 0, dev * scale + tr / 3.0, eps))
    return torch.exp(eps_proj + cohesion)
