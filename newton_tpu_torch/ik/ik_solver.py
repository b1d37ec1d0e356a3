"""Batched inverse kinematics (port of ``newton_tpu/ik/ik_solver.py``).

Levenberg-Marquardt over (problems x seeds) at once: every (problem,
seed) row is one leading batch entry of the forward kinematics, with its
own damping lambda. The residual is a function of the coordinates through
``fk_bodies``; its Jacobian comes from forward-mode AD
(``torch.autograd.forward_ad``) with the Q tangent directions laid on a
batch axis, so one FK pass gives all Q columns (the JAX package's
``jax.jacfwd``). The LM system is formed and solved by LU in float64
(``torch.linalg.solve_ex`` without its error check, so the loop never
waits for the device): J^T J squares J's condition number, and along a
redundant chain's null space only lambda damps the step, so float32
rounding there would move q by ~1e-4 in one step (the JAX package forms
it in float32; the two agree where the step is well conditioned).
``method="bfgs"`` runs a batched copy of the BFGS algorithm behind
``jax.scipy.optimize.minimize(method="BFGS")`` (Wright and Nocedal,
Algorithm 6.1, with the strong-Wolfe zoom line search of Algorithms 3.5 and
3.6): one function-and-gradient evaluation per tick for every row, each
row in its own phase of the line search, gradients by ``torch.autograd``.
No TPU kernel lies on this path.

Objectives are duck-typed: anything with ``n_residuals`` and
``residual(model, body_q, target)`` joins the stack. ``body_q`` carries
leading batch dims, ``(..., B, 7)``, and ``target`` broadcasts against
them, ``(..., t)``; the residual is ``(..., n_residuals)``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch
import torch.autograd.forward_ad as fwAD

from ..math import (
    quat_conjugate,
    quat_mul,
    quat_to_axis_angle,
    transform_point,
)
from ..sim.articulation import fk_bodies
from ..sim.model import Model

__all__ = ["IKSolver", "IKSampling", "IKObjectivePosition",
           "IKObjectiveRotation", "IKObjectiveJointLimit"]


class IKSampling(enum.Enum):
    """Seed sampling strategies."""

    NONE = 0
    GAUSS = 1
    UNIFORM = 2
    ROBERTS = 3


@dataclass
class IKObjectivePosition:
    """End-effector position: the point ``offset`` of body ``link`` at
    the problem's target (3 rows, times ``weight``)."""

    link: int
    offset: Sequence[float] = (0.0, 0.0, 0.0)
    weight: float = 1.0
    n_residuals: int = 3
    # the offset as a tensor per device: made once, so a residual copies
    # nothing from the host (a copy would wait for the device)
    _offsets: dict = field(default_factory=dict, init=False, repr=False,
                           compare=False)

    def residual(self, model, body_q, target):
        key = (body_q.device, body_q.dtype)
        if key not in self._offsets:
            self._offsets[key] = torch.tensor(self.offset, dtype=body_q.dtype,
                                              device=body_q.device)
        p = transform_point(body_q[..., self.link, :], self._offsets[key])
        return self.weight * (p - target)


@dataclass
class IKObjectiveRotation:
    """End-effector orientation: the axis-angle vector of ``target *
    q_link^-1`` (3 rows, times ``weight``)."""

    link: int
    weight: float = 1.0
    n_residuals: int = 3

    def residual(self, model, body_q, target):
        q = body_q[..., self.link, 3:7]
        axis, ang = quat_to_axis_angle(quat_mul(target, quat_conjugate(q)))
        return self.weight * axis * ang[..., None]


@dataclass
class IKObjectiveJointLimit:
    """Soft joint-limit residuals (enabled by ``joint_limit_weight``)."""

    weight: float = 0.1

    def residuals_for(self, model):
        return model.joint_coord_count


class IKSolver:
    """Multi-seed batched IK (the JAX package's ``IKSolver``).

    Args:
        model: finalized one-world model (FK runs on all of it).
        objectives: position/rotation/custom objectives.
        joint_limit_weight: weight of the soft limit rows on the 1-dof
            coordinates (0 disables).
        iterations, lambda_init: LM controls (``iterations`` is BFGS's
            ``maxiter`` under ``method="bfgs"``).
        n_seeds, sampling, seed_scale: the initial guesses: q0 and
            ``n_seeds - 1`` perturbations of it, shared by every problem.
        generator: the ``torch.Generator`` GAUSS and UNIFORM draw from
            (default: one on the model's device seeded 0).
        method: ``"lm"`` or ``"bfgs"``.

    ``solve(q0, targets)``: q0 (Q,); targets, one per objective, each
    (P, t) or (t,); every problem starts from each row of ``seeds(q0)``.
    Returns (P, Q) (or (Q,) for unbatched targets), each problem's best
    seed (lowest cost, the first on ties).
    """

    def __init__(self, model: Model, objectives: List,
                 joint_limit_weight: float = 0.0, iterations: int = 16,
                 lambda_init: float = 1e-2, n_seeds: int = 1,
                 sampling: IKSampling = IKSampling.GAUSS,
                 seed_scale: float = 0.3,
                 generator: Optional[torch.Generator] = None,
                 method: str = "lm"):
        if method not in ("lm", "bfgs"):
            raise ValueError(f"unknown IK method {method!r}")
        self.model = model
        self.objectives = objectives
        self.joint_limit_weight = float(joint_limit_weight)
        self.iterations = int(iterations)
        self.lambda_init = float(lambda_init)
        self.n_seeds = int(n_seeds)
        self.sampling = sampling
        self.seed_scale = float(seed_scale)
        if generator is None:
            generator = torch.Generator(device=model.device)
            generator.manual_seed(0)
        self.generator = generator
        self.method = method
        self._limits = None
        if self.joint_limit_weight > 0:
            from ..solvers.generalized.dynamics import get_generalized_cache
            gc = get_generalized_cache(model.structure)
            li = torch.as_tensor(gc.lin_coord_idx, dtype=torch.long,
                                 device=model.device)
            ld = torch.as_tensor(gc.lin_coord_dof, dtype=torch.long,
                                 device=model.device)
            self._limits = (li, model.joint_limit_lower[ld],
                            model.joint_limit_upper[ld])

    # ------------------------------------------------------------------
    def residual(self, q: torch.Tensor, targets) -> torch.Tensor:
        """Residual rows (..., R) of coordinates (..., Q); each target
        broadcasts against q's batch dims."""
        model = self.model
        batch = q.shape[:-1]
        B = model.body_count
        body_q, _ = fk_bodies(model, q, torch.zeros_like(q),
                              model.body_q.expand(*batch, B, 7),
                              model.body_qd.expand(*batch, B, 6))
        parts = [obj.residual(model, body_q, t)
                 for obj, t in zip(self.objectives, targets)]
        if self._limits is not None:
            li, lo, hi = self._limits
            ql = q[..., li]
            parts.append(self.joint_limit_weight
                         * (torch.clamp(ql - lo, max=0.0)
                            + torch.clamp(ql - hi, min=0.0)))
        return torch.cat([p.expand(*batch, p.shape[-1]) for p in parts], -1)

    def residual_and_jacobian(self, q: torch.Tensor, targets):
        """(r (..., R), J (..., R, Q)) by forward-mode AD: q repeated Q
        times on a new axis, each copy with one unit tangent."""
        Q = q.shape[-1]
        eye = torch.eye(Q, dtype=q.dtype, device=q.device)
        q_rep = q[..., None, :].expand(*q.shape[:-1], Q, Q).contiguous()
        tg = [t[..., None, :] for t in targets]
        with fwAD.dual_level():
            r = self.residual(fwAD.make_dual(
                q_rep, eye.expand_as(q_rep).contiguous()), tg)
            primal, tangent = fwAD.unpack_dual(r)
        return primal[..., 0, :], tangent.transpose(-1, -2)

    # ------------------------------------------------------------------
    def seeds(self, q0: torch.Tensor) -> torch.Tensor:
        """(S, Q) initial guesses: q0, then q0 plus the sampled noise."""
        S, Q = self.n_seeds, q0.shape[-1]
        if S <= 1:
            return q0[None]
        if self.sampling == IKSampling.GAUSS:
            noise = self.seed_scale * torch.randn(
                S - 1, Q, generator=self.generator, dtype=q0.dtype,
                device=q0.device)
        elif self.sampling == IKSampling.UNIFORM:
            u = torch.rand(S - 1, Q, generator=self.generator,
                           dtype=q0.dtype, device=q0.device)
            noise = self.seed_scale * (2.0 * u - 1.0)
        elif self.sampling == IKSampling.ROBERTS:
            noise = roberts_noise(S, Q, self.seed_scale, q0.dtype, q0.device)
        else:
            noise = torch.zeros(S - 1, Q, dtype=q0.dtype, device=q0.device)
        return torch.cat([q0[None], q0[None] + noise], 0)

    def solve(self, q0, targets):
        """See the class docstring."""
        dev = self.model.device
        q0 = torch.as_tensor(q0, dtype=torch.float32, device=dev)
        targets = [torch.as_tensor(t, dtype=torch.float32, device=dev)
                   for t in targets]
        single = targets[0].dim() == 1
        if single:
            targets = [t[None] for t in targets]
        S0 = self.seeds(q0)
        P, S = targets[0].shape[0], S0.shape[0]
        q = S0[None].expand(P, S, -1).contiguous()          # (P, S, Q)
        tg = [t[:, None, :] for t in targets]               # (P, 1, t)
        if self.method == "bfgs":
            q, cost = _bfgs(lambda x: (self.residual(x, tg) ** 2).sum(-1),
                            q, self.iterations)
        else:
            q, cost = self._lm(q, tg)
        best = torch.argmin(cost, dim=1)                    # (P,)
        out = q[torch.arange(P, device=dev), best]
        return out[0] if single else out

    def _lm(self, q, targets):
        """``iterations`` LM steps of every row (the JAX ``lm_step``):
        accept a step that lowers the cost and halve lambda, else keep q
        and quadruple it, within [1e-8, 1e6]."""
        Q = q.shape[-1]
        eye = torch.eye(Q, dtype=torch.float64, device=q.device)
        lam = torch.full(q.shape[:-1], self.lambda_init, dtype=q.dtype,
                         device=q.device)
        for _ in range(self.iterations):
            r, J = self.residual_and_jacobian(q, targets)
            J, r64 = J.double(), r.double()
            Jt = J.transpose(-1, -2)
            A = Jt @ J + lam.double()[..., None, None] * eye
            g = (Jt @ r64[..., None])[..., 0]
            dq = -torch.linalg.solve_ex(A, g, check_errors=False)[0].to(
                q.dtype)
            q_new = q + dq
            cost_new = (self.residual(q_new, targets) ** 2).sum(-1)
            improved = cost_new < (r ** 2).sum(-1)
            q = torch.where(improved[..., None], q_new, q)
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0),
                              1e-8, 1e6)
        return q, (self.residual(q, targets) ** 2).sum(-1)


def roberts_noise(S: int, Q: int, scale: float, dtype, device):
    """The ROBERTS quasi-random perturbations (S - 1, Q), computed as the
    JAX package computes them in float32: alpha_k = (1/g)^k from the
    correctly rounded power, then scale * (frac(i alpha) - 0.5) * 2."""
    g = 1.6180339887498949
    inv = torch.tensor(1.0 / g, dtype=dtype, device=device)
    k = torch.arange(1, Q + 1, dtype=dtype, device=device)
    alphas = (inv.double() ** k.double()).to(dtype)
    idx = torch.arange(1, S, dtype=dtype, device=device)[:, None]
    return scale * (torch.remainder(idx * alphas, 1.0) - 0.5) * 2


# ----------------------------------------------------------------------
# batched BFGS with the strong-Wolfe zoom line search
# ----------------------------------------------------------------------

_POLL = 16          # ticks between checks that every row has finished


def _value_and_grad(fun, x):
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        f = fun(x)
        g, = torch.autograd.grad(f.sum(), x)
    return f.detach(), g


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    d2a, d2b = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * d2a + (-db ** 2) * d2b) / denom
    B = ((-dc ** 3) * d2a + db ** 3 * d2b) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _bfgs(fun, x0, maxiter: int, gtol: float = 1e-5, ls_maxiter: int = 10,
          c1: float = 1e-4, c2: float = 0.9):
    """Minimize ``fun`` (..., Q) -> (...) from x0 row by row; returns
    (x, f). Every row runs its own copy of the algorithm: a row's state is
    one of the line search's main loop, its zoom, or finished, and each
    tick evaluates the function and its gradient once for every row at
    the row's trial point."""
    shape = x0.shape[:-1]
    Q = x0.shape[-1]
    dt, dev = x0.dtype, x0.device
    eye = torch.eye(Q, dtype=dt, device=dev)
    F = torch.zeros(shape, dtype=torch.bool, device=dev)

    def where(m, a, b):
        while m.dim() < a.dim():
            m = m[..., None]
        return torch.where(m, a, b)

    def dot(a, b):
        return (a * b).sum(-1)

    x = x0.clone()
    f, g = _value_and_grad(fun, x)
    H = eye.expand(*shape, Q, Q).clone()
    conv = g.abs().amax(-1) < gtol
    failed = F.clone()
    k = torch.zeros(shape, dtype=torch.long, device=dev)
    old_old = f + torch.linalg.vector_norm(g, dim=-1) / 2
    zf = torch.zeros_like(f)
    # every row's line-search and zoom state
    s = dict(p=torch.zeros_like(x), g0=g, phi0=f, dphi0=zf, start=zf,
             i=k, a1=zf, phi1=f, dphi1=zf, a_st=zf, phi_st=f, dphi_st=zf,
             g_st=g, done=F, lsfail=F, zoom=F, zj=k, a_lo=zf, phi_lo=zf,
             dphi_lo=zf, a_hi=zf, phi_hi=zf, dphi_hi=zf, a_rec=zf,
             phi_rec=zf, z_a=zf, z_phi=zf, z_dphi=zf, z_g=g, z_done=F,
             z_fail=F)

    def begin_line_search(m):
        """Rows ``m`` start an iteration: direction, start value and the
        line search's state."""
        p = -(H @ g[..., None])[..., 0]
        d0 = dot(g, p)
        cand = 1.01 * 2 * (f - old_old) / d0
        init = dict(p=p, g0=g, phi0=f, dphi0=d0,
                    start=torch.where(cand > 1, torch.ones_like(cand), cand),
                    i=torch.ones_like(k), a1=zf, phi1=f, dphi1=d0, a_st=zf,
                    phi_st=f, dphi_st=d0, g_st=g, done=F, lsfail=F, zoom=F)
        for key, v in init.items():
            s[key] = where(m, v, s[key])

    def begin_zoom(m, lo, hi):
        """Rows ``m`` enter the zoom between (a, phi, dphi) ``lo`` and
        ``hi``."""
        init = dict(zoom=~F, zj=torch.zeros_like(k), a_lo=lo[0],
                    phi_lo=lo[1], dphi_lo=lo[2], a_hi=hi[0], phi_hi=hi[1],
                    dphi_hi=hi[2], a_rec=(lo[0] + hi[0]) / 2.0,
                    phi_rec=(lo[1] + hi[1]) / 2.0, z_a=torch.ones_like(f),
                    z_phi=lo[1], z_dphi=lo[2], z_g=s["g0"], z_done=F,
                    z_fail=F)
        for key, v in init.items():
            s[key] = where(m, v, s[key])

    active = ~conv & ~failed & (k < maxiter)
    begin_line_search(~F)
    tick = 0
    while True:
        tick += 1
        zoom = s["zoom"]
        # the trial step of each row
        dalpha = s["a_hi"] - s["a_lo"]
        a_min = torch.minimum(s["a_hi"], s["a_lo"])
        a_max = torch.maximum(s["a_hi"], s["a_lo"])
        z_fail = s["z_fail"] | (zoom & (dalpha <= 1e-5))
        a_cub = _cubicmin(s["a_lo"], s["phi_lo"], s["dphi_lo"], s["a_hi"],
                          s["phi_hi"], s["a_rec"], s["phi_rec"])
        use_cub = ((s["zj"] > 0) & (a_cub > a_min + 0.2 * dalpha)
                   & (a_cub < a_max - 0.2 * dalpha))
        a_quad = _quadmin(s["a_lo"], s["phi_lo"], s["dphi_lo"], s["a_hi"],
                          s["phi_hi"])
        use_quad = (~use_cub & (a_quad > a_min + 0.1 * dalpha)
                    & (a_quad < a_max - 0.1 * dalpha))
        a_z = torch.where(use_cub, a_cub, s["a_rec"])
        a_z = torch.where(use_quad, a_quad, a_z)
        a_z = torch.where(~use_cub & ~use_quad, (s["a_lo"] + s["a_hi"]) / 2.0,
                          a_z)
        a_m = torch.where(s["i"] == 1, s["start"], s["a1"] * 2.0)
        a = torch.where(zoom, a_z, a_m)
        phi, gr = _value_and_grad(fun, x + a[..., None] * s["p"])
        dphi = dot(gr, s["p"])

        def wolfe_one(a_i, phi_i):
            return phi_i > s["phi0"] + c1 * a_i * s["dphi0"]

        def wolfe_two(dphi_i):
            return dphi_i.abs() <= -c2 * s["dphi0"]

        # --- rows in the zoom (Algorithm 3.6) ---
        zm = active & zoom
        hi_to_j = wolfe_one(a, phi) | (phi >= s["phi_lo"])
        star_to_j = wolfe_two(dphi) & ~hi_to_j
        hi_to_lo = ((dphi * (s["a_hi"] - s["a_lo"]) >= 0.0) & ~hi_to_j
                    & ~star_to_j)
        lo_to_j = ~hi_to_j & ~star_to_j
        z = {key: s[key] for key in ("a_lo", "phi_lo", "dphi_lo", "a_hi",
                                     "phi_hi", "dphi_hi", "a_rec", "phi_rec",
                                     "z_a", "z_phi", "z_dphi", "z_g")}
        m = hi_to_j
        z["a_rec"] = torch.where(m, z["a_hi"], z["a_rec"])
        z["phi_rec"] = torch.where(m, z["phi_hi"], z["phi_rec"])
        z["a_hi"] = torch.where(m, a, z["a_hi"])
        z["phi_hi"] = torch.where(m, phi, z["phi_hi"])
        z["dphi_hi"] = torch.where(m, dphi, z["dphi_hi"])
        m = star_to_j
        z["z_a"] = torch.where(m, a, z["z_a"])
        z["z_phi"] = torch.where(m, phi, z["z_phi"])
        z["z_dphi"] = torch.where(m, dphi, z["z_dphi"])
        z["z_g"] = where(m, gr, z["z_g"])
        m = hi_to_lo
        a_hi0, phi_hi0 = z["a_hi"], z["phi_hi"]
        z["a_hi"] = torch.where(m, z["a_lo"], z["a_hi"])
        z["phi_hi"] = torch.where(m, z["phi_lo"], z["phi_hi"])
        z["dphi_hi"] = torch.where(m, z["dphi_lo"], z["dphi_hi"])
        z["a_rec"] = torch.where(m, a_hi0, z["a_rec"])
        z["phi_rec"] = torch.where(m, phi_hi0, z["phi_rec"])
        m = lo_to_j & ~hi_to_lo
        z["a_rec"] = torch.where(m, z["a_lo"], z["a_rec"])
        z["phi_rec"] = torch.where(m, z["phi_lo"], z["phi_rec"])
        m = lo_to_j
        z["a_lo"] = torch.where(m, a, z["a_lo"])
        z["phi_lo"] = torch.where(m, phi, z["phi_lo"])
        z["dphi_lo"] = torch.where(m, dphi, z["dphi_lo"])
        zj = s["zj"] + 1
        z_done = s["z_done"] | star_to_j
        z_fail = z_fail | (zj >= 30)
        for key, v in z.items():
            s[key] = where(zm, v, s[key])
        s["zj"] = torch.where(zm, zj, s["zj"])
        s["z_done"] = torch.where(zm, z_done, s["z_done"])
        s["z_fail"] = torch.where(zm, z_fail, s["z_fail"])
        zoom_end = zm & (s["z_done"] | s["z_fail"])
        # the line search takes the zoom's result and is done
        s["a_st"] = torch.where(zoom_end, s["z_a"], s["a_st"])
        s["phi_st"] = torch.where(zoom_end, s["z_phi"], s["phi_st"])
        s["dphi_st"] = torch.where(zoom_end, s["z_dphi"], s["dphi_st"])
        s["g_st"] = where(zoom_end, s["z_g"], s["g_st"])
        s["lsfail"] = s["lsfail"] | (zoom_end & s["z_fail"])
        s["done"] = s["done"] | zoom_end
        s["zoom"] = s["zoom"] & ~zoom_end

        # --- rows in the line search's main loop (Algorithm 3.5) ---
        mm = active & ~zoom
        to_zoom1 = wolfe_one(a, phi) | ((phi >= s["phi1"]) & (s["i"] > 1))
        to_i = wolfe_two(dphi) & ~to_zoom1
        to_zoom2 = (dphi >= 0.0) & ~to_zoom1 & ~to_i
        m = mm & to_i
        s["a_st"] = torch.where(m, a, s["a_st"])
        s["phi_st"] = torch.where(m, phi, s["phi_st"])
        s["dphi_st"] = torch.where(m, dphi, s["dphi_st"])
        s["g_st"] = where(m, gr, s["g_st"])
        s["done"] = s["done"] | m
        begin_zoom(mm & to_zoom1, (s["a1"], s["phi1"], s["dphi1"]),
                   (a, phi, dphi))
        begin_zoom(mm & to_zoom2, (a, phi, dphi),
                   (s["a1"], s["phi1"], s["dphi1"]))
        step = mm & ~to_zoom1 & ~to_i & ~to_zoom2
        s["i"] = torch.where(mm, s["i"] + 1, s["i"])
        s["a1"] = torch.where(mm, a, s["a1"])
        s["phi1"] = torch.where(mm, phi, s["phi1"])
        s["dphi1"] = torch.where(mm, dphi, s["dphi1"])
        # a main loop that runs out of iterations ends not done (failed)
        ls_end = (active & s["done"]) | (step & (s["i"] > ls_maxiter))

        # --- rows whose line search ended: the BFGS update ---
        a_k = s["a_st"]
        a_k = torch.where(a_k.abs() < 1e-8, torch.sign(a_k) * 1e-8, a_k)
        failed = failed | (ls_end & (s["lsfail"] | ~s["done"]))
        sk = a_k[..., None] * s["p"]
        y = s["g_st"] - g
        rho = 1.0 / dot(y, sk)
        w = eye - rho[..., None, None] * (sk[..., :, None] * y[..., None, :])
        H1 = (w @ H @ w.transpose(-1, -2)
              + (rho[..., None, None] * sk[..., :, None]) * sk[..., None, :])
        H1 = where(torch.isfinite(rho), H1, H)
        H = where(ls_end, H1, H)
        old_old = torch.where(ls_end, f, old_old)
        x = where(ls_end, x + sk, x)
        f = torch.where(ls_end, s["phi_st"], f)
        g = where(ls_end, s["g_st"], g)
        conv = torch.where(ls_end, g.abs().amax(-1) < gtol, conv)
        k = torch.where(ls_end, k + 1, k)
        active = ~conv & ~failed & (k < maxiter)
        begin_line_search(ls_end & active)
        s["zoom"] = s["zoom"] & active
        if tick % _POLL == 0 and not bool(active.any()):
            break
    return x, f
