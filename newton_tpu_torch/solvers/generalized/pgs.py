"""Fused Delassus assembly + projected-Jacobi contact solve (port of the TPU
kernel ``newton_tpu/solvers/generalized/pgs_pallas.py``).

``pgs_solve_fused`` is the wrapper the batched step calls once per substep
with contacts: on CUDA tensors it launches the hand-written kernel in
``csrc/pgs_solve.cu``; on CPU tensors it runs ``pgs_solve_fused_plain``,
the plain PyTorch version (the JAX package's XLA-branch assembly,
batched.py:833-849, followed by ``pgs_core`` / ``spectral_lam_max``).

Rows are in BLOCK order ``[normals (c) | t1 (c) | t2 (c) | lim-lo (nl) |
lim-hi (nl)]``; joint-limit rows are signed one-hots on the dofs ``ld`` and
are never materialized. Layout is env-major: ``J (W, 3c, d)``,
``Minv (W, d, d)``, ``qd (W, d)``, ``b / act / lam0 (W, r)``,
``mu (W, c)``, ``ld`` an int tensor of limited local dofs (nl,). Every
shape has a kernel instance (``kernel_instance`` mirrors the kernel's choice
from the shape alone).

``w_other (W, 3c)``, optional, is a per-row addend of the Delassus operator
on the contact rows: the point inverse mass of the body on a contact's other
side when that body lies in another articulation or world (a two-sided
contact, solved in both cells). It adds to the diagonal before the
``diag_scale``/``reg`` softening and acts diagonally in every matvec,
``A x + w_other * x`` (the JAX package's ``w_extra``); zero on limit rows.

``symmetric=False`` is the form for a ``Minv`` that is not symmetric (the
implicit integrator's inverse of ``M + dt (Kd + D + dbias/dqd)``): the
contact rows use ``Minv J^T`` as the reference does (``MJ = J Minv^T``,
the kernel stages ``Minv`` transposed) and the limit rows the columns
``Minv[:, ld]``, so the Delassus operator is ``[J; E] Minv [J; E]^T`` and
``dqd = Minv [J; E]^T lam``. The default, ``symmetric=True``, forms ``MJ =
J Minv`` as every symmetric call did before the option existed.

Gradients: on the CPU autograd runs through the plain version, whose
``maximum``/``minimum`` give half the gradient to each side at a tie, as
the JAX package's ``jnp.maximum``/``jnp.clip`` do. On the card the wrapper
is a ``torch.autograd.Function``: where an input requires grad, B2 also
writes its iterates (``save_floats`` per env, kept for the backward), and
the backward is the kernel in ``csrc/pgs_backward.cu``
(``pgs_backward.launches`` counts it), which forms from them what
autograd of the plain version forms for J, Minv, qd, b, mu, lam0 and
w_other (act and the halvings carry none): the gradient of the iterates
and guard halvings the card took.
"""

from __future__ import annotations

import torch

__all__ = ["pgs_solve_fused", "pgs_solve_fused_plain", "pgs_core",
           "pgs_backward", "backward_instance", "backward_scratch_floats",
           "save_floats",
           "spectral_lam_max", "spectral_iters", "kernel_instance",
           "smem_bytes", "scratch_floats", "INSTANCE_CODES"]

_SMEM_BYTES = 227 * 1024                # shared memory of one H100 block

# the kernel's instance codes (csrc/pgs_solve.cu: instance())
INSTANCE_CODES = {"reg16": 16, "reg24": 24, "smem128": 128, "smem256": 256,
                  "global128": 1128, "global256": 1256}


def _dims(c: int, nl: int, d: int):
    """The kernel's layout (csrc/pgs_solve.cu: make_dims): threads, row
    stride s, phase-1 row blocks P and rows per block R."""
    r = 3 * c + 2 * nl
    threads = 128 if r <= 160 else 256
    s = (d + 3) & ~3
    dp = 1
    while dp < d and dp < 32:
        dp *= 2
    P = threads // 32 * (32 // dp)
    R = ((3 * c + nl + P - 1) // P + 3) & ~3
    return threads, s, P, R, r


def _reg_width(c: int, nl: int, s: int) -> int:
    return s if c <= 32 and nl <= 32 and s in (16, 24) else 0


def smem_bytes(c: int, nl: int, d: int) -> int:
    """Bytes of one env's block state (csrc/pgs_solve.cu: pgs_smem_bytes):
    the float4-read arrays, phase-1 partials, the row state of the
    shared-memory path, mu, the norm slots and the int ld."""
    threads, s, P, R, r = _dims(c, nl, d)
    n = (2 * s + P * R + (3 * c + P * R + s) * s + P * d
         + 2 * (threads // 32))
    if not _reg_width(c, nl, s):
        n += 6 * r + c
    return 4 * n + 4 * nl


def kernel_instance(c: int, nl: int, d: int) -> str:
    """The kernel instance that runs (c, nl, d): ``reg16``/``reg24`` (rows
    in registers), ``smem128``/``smem256`` (row state in shared memory,
    threads per block) or ``global128``/``global256`` (the same sweep in a
    per-env global scratch, for a block state above 227 KB)."""
    if c < 0 or nl < 0 or d < 1 or 3 * c + 2 * nl < 1:
        raise ValueError(f"pgs_solve_fused: no system at (c, nl, d) = "
                         f"({c}, {nl}, {d})")
    threads, s, _, _, _ = _dims(c, nl, d)
    if smem_bytes(c, nl, d) > _SMEM_BYTES:
        return f"global{threads}"
    w = _reg_width(c, nl, s)
    return f"reg{w}" if w else f"smem{threads}"


def scratch_floats(c: int, nl: int, d: int) -> int:
    """Floats of global scratch per env (0 unless the global instance):
    the block state rounded up to 16 bytes."""
    if not kernel_instance(c, nl, d).startswith("global"):
        return 0
    return (smem_bytes(c, nl, d) // 4 + 3) & ~3


def spectral_iters(rows: int) -> int:
    """Power-iteration count for the step bound, keyed on the static row
    count (3 below 192 rows, else 8), as in the JAX package."""
    return 3 if rows < 192 else 8


def spectral_lam_max(Avec, diag, act, iters: int = 3):
    """Matrix-free lower estimate of lambda_max(D^-1/2 A D^-1/2): ``iters``
    power iterations from the active-row indicator; the estimate is
    ||A u_k|| of the last normalized iterate. Rows on the last axis."""
    inv_sqrt_d = torch.rsqrt(diag)
    u = act / torch.clamp(torch.linalg.vector_norm(act, dim=-1,
                                                   keepdim=True), min=1.0)
    lam_max = None
    for _ in range(iters):
        u2 = inv_sqrt_d * Avec(inv_sqrt_d * u) * act
        nrm = torch.linalg.vector_norm(u2, dim=-1, keepdim=True)
        lam_max = nrm[..., 0]
        u = u2 / torch.maximum(nrm, _const(1e-9, nrm))
    return lam_max


def _const(v, like):
    """A 0-d constant for ``torch.maximum``/``minimum``, whose gradient,
    unlike ``clamp``'s, splits evenly at a tie (as JAX's does)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def pgs_core(J, MJ, cols, diag, v_free, b, act, mu, lam0, *, c, ld, iters,
             omega, use_cone, w_other=None):
    """Power-iteration step cap + projected-Jacobi sweep with the per-env
    divergence guard. J/MJ hold the 3c contact rows (W, 3c, d); ``cols`` =
    Minv[:, :, ld] (W, d, nl) or None; ``w_other`` (W, 3c) or None the
    diagonal addend of the contact rows (``diag`` already holds it).
    Returns (lam (W, r), dqd (W, d), halvings (W,) int32)."""
    r3 = 3 * c
    nl = 0 if cols is None else cols.shape[-1]

    def Avec(x):
        tmp = torch.bmm(MJ.transpose(1, 2), x[:, :r3, None])[..., 0]
        if nl:
            w = x[:, r3:r3 + nl] - x[:, r3 + nl:]
            tmp = tmp + torch.bmm(cols, w[:, :, None])[..., 0]
        y = torch.bmm(J, tmp[:, :, None])[..., 0]
        if w_other is not None:
            y = y + w_other * x[:, :r3]
        if nl:
            tl = tmp[:, ld]
            y = torch.cat([y, tl, -tl], dim=1)
        return y

    lam_max = spectral_lam_max(Avec, diag, act,
                               iters=spectral_iters(act.shape[1]))
    step = torch.minimum(
        1.8 / torch.maximum(1.1 * lam_max, _const(1e-9, lam_max)),
        _const(1.0, lam_max))
    scale = omega * step                                  # (W,)
    halvings = torch.zeros_like(scale, dtype=torch.int32)

    lam = lam0
    prev_dn = None
    zero, eps, one = (_const(v, diag) for v in (0.0, 1e-9, 1.0))
    for _ in range(iters):
        res = Avec(lam) + v_free - b
        lam_full = lam - (scale[:, None] / diag) * res
        ln = torch.maximum(lam_full[:, 0:c], zero)
        cap = mu * ln
        lt1 = lam_full[:, c:2 * c]
        lt2 = lam_full[:, 2 * c:r3]
        if use_cone:
            tmag = torch.sqrt(lt1 * lt1 + lt2 * lt2)
            sc = torch.minimum(cap / torch.maximum(tmag, eps), one)
            lt1, lt2 = lt1 * sc, lt2 * sc
        else:
            lt1 = torch.minimum(torch.maximum(lt1, -cap), cap)
            lt2 = torch.minimum(torch.maximum(lt2, -cap), cap)
        parts = [ln, lt1, lt2]
        if nl:
            parts.append(torch.maximum(lam_full[:, r3:], zero))
        lam_new = torch.cat(parts, dim=1) * act
        lam_new = torch.where(torch.isfinite(lam_new), lam_new,
                              torch.zeros_like(lam_new))
        dlt = lam_new - lam
        dn = (dlt * dlt).sum(dim=1)
        if prev_dn is not None:
            # 2% tolerance: float jitter near the fixed point must not bleed
            # the step; true divergence grows ||dlam|| geometrically
            grow = dn > prev_dn * 1.02
            scale = torch.where(grow, scale * 0.5, scale)
            halvings = halvings + grow.to(torch.int32)
        prev_dn = dn
        lam = lam_new
    dqd = torch.bmm(MJ.transpose(1, 2), lam[:, :r3, None])[..., 0]
    if nl:
        wl = lam[:, r3:r3 + nl] - lam[:, r3 + nl:]
        dqd = dqd + torch.bmm(cols, wl[:, :, None])[..., 0]
    return lam, dqd, halvings


def pgs_solve_fused_plain(J, Minv, qd, b, act, mu, lam0, *, c, ld, iters,
                          omega, use_cone, diag_scale, reg, w_other=None,
                          return_halvings=False, symmetric=True):
    """Plain PyTorch version: Delassus pieces assembled outside, then
    ``pgs_core``. Returns (lam, dqd[, halvings])."""
    nl = int(ld.numel())
    MJ = torch.bmm(J, Minv if symmetric else Minv.transpose(1, 2))
    diag = (J * MJ).sum(dim=2)
    if w_other is not None:
        diag = diag + w_other
    diag = diag * diag_scale + reg
    v_free = (J * qd[:, None, :]).sum(dim=2)
    cols = None
    if nl:
        cols = Minv[:, :, ld]                             # (W, d, nl)
        dlim = Minv[:, ld, ld] * diag_scale + reg
        diag = torch.cat([diag, dlim, dlim], dim=1)
        vlim = qd[:, ld]
        v_free = torch.cat([v_free, vlim, -vlim], dim=1)
    lam, dqd, halv = pgs_core(J, MJ, cols, diag, v_free, b, act, mu, lam0,
                              c=c, ld=ld, iters=iters, omega=omega,
                              use_cone=use_cone, w_other=w_other)
    return (lam, dqd, halv) if return_halvings else (lam, dqd)


def save_floats(c: int, nl: int, d: int, iters: int) -> int:
    """Floats per env of the forward that B2 saves for K4
    (csrc/pgs_save.cuh): each sweep's new lambda, residual and
    pre-projection lambda (3 r), its d-vector (d) and guard flag, each
    power iteration's Delassus product (r), d-vector (d) and norm."""
    r = 3 * c + 2 * nl
    K = spectral_iters(r)
    return iters * (3 * r + d + 1) + K * (r + d + 1)


def backward_scratch_floats(c: int, nl: int, d: int, iters: int) -> int:
    """Floats of one env's workspace in K4 (csrc/pgs_backward.cu:
    make_layout): J and MJ extended by the limit rows, Minv, eight row
    vectors, w_other's and mu's gradients and mu, each product's x (the
    saved lambdas staged there), g_tmp and g_y (and g_qd's), the g_tmp
    partials, the norm slots, ld, and the rest of B2's saved forward (its
    res and yf in a head that MJ's gradient takes over at the end), each
    array rounded up to 4 floats."""
    def up(n):
        return (n + 3) & ~3
    r3, r = 3 * c, 3 * c + 2 * nl
    rows = r3 + nl
    K = spectral_iters(r)
    threads = 128 if r <= 160 else 256
    dp = 1
    while dp < d and dp < 32:
        dp *= 2
    P = threads // 32 * (32 // dp)
    ny = iters + K
    head = 2 * iters * r
    saved = up(max(head, rows * d)) + save_floats(c, nl, d, iters) \
        - 3 * iters * r
    return (2 * up(rows * d) + up(d * d) + 8 * up(r) + up(r3) + 2 * up(c)
            + up((ny + 1) * r) + up((ny + 2) * d) + up((ny + 1) * rows)
            + up(P * d) + up(16) + up(nl) + up(saved))


def backward_instance(c: int, nl: int, d: int, iters: int) -> str:
    """K4's instance: ``smem`` (the env's workspace in shared memory) or
    ``global`` (in a per-env slice of a global scratch)."""
    kernel_instance(c, nl, d)                     # validates the shape
    return ("smem" if 4 * backward_scratch_floats(c, nl, d, iters)
            <= _SMEM_BYTES else "global")


def pgs_backward(J, Minv, qd, b, act, mu, lam0, ld, w_other, glam, gdqd,
                 save, *, c, iters, omega, use_cone, diag_scale, reg,
                 symmetric):
    """One launch of K4 (``csrc/pgs_backward.cu``), counted in
    ``pgs_backward.launches``: the gradients (gJ, gMinv, gqd, gb, gmu,
    glam0, gw_other or None) of ``pgs_solve_fused``'s inputs from the
    cotangents of lam and dqd (either may be None, a zero cotangent) and
    ``save`` (W, save_floats), the forward that B2 saved."""
    if J.device.type != "cuda":
        raise ValueError(f"pgs_backward: unsupported device {J.device}")
    W, r3, d = J.shape
    nl = int(ld.numel())
    r = r3 + 2 * nl
    glam = None if glam is None else glam.contiguous()
    gdqd = None if gdqd is None else gdqd.contiguous()
    from ... import _kernels
    gJ = torch.empty_like(J)
    gMinv = torch.empty_like(Minv)
    gqd = torch.empty_like(qd)
    gb = torch.empty((W, r), dtype=J.dtype, device=J.device)
    gmu = torch.empty_like(mu)
    glam0 = torch.empty((W, r), dtype=J.dtype, device=J.device)
    gw = None if w_other is None else torch.empty_like(w_other)
    scratch = None
    if W and backward_instance(c, nl, d, iters) == "global":
        scratch = torch.empty((W, backward_scratch_floats(c, nl, d, iters)),
                              dtype=J.dtype, device=J.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(J.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().pgs_solve_backward_f32(
            J.data_ptr(), Minv.data_ptr(), qd.data_ptr(), b.data_ptr(),
            act.data_ptr(), mu.data_ptr(), lam0.data_ptr(), ld.data_ptr(),
            ptr(w_other), ptr(glam), ptr(gdqd), save.data_ptr(),
            gJ.data_ptr(),
            gMinv.data_ptr(), gqd.data_ptr(), gb.data_ptr(), gmu.data_ptr(),
            glam0.data_ptr(), ptr(gw), W, c, nl, d, int(iters),
            float(omega), int(bool(use_cone)), float(diag_scale),
            float(reg), ptr(scratch), int(not symmetric), stream)
    pgs_backward.launches += 1
    _kernels.check(err, "pgs_backward")
    return gJ, gMinv, gqd, gb, gmu, glam0, gw


class _PGSSolve(torch.autograd.Function):
    """B2 forward (the instance that saves its iterates), K4 backward; used
    where grad is on and an input requires it. act and the halvings carry
    no gradient."""

    @staticmethod
    def forward(ctx, J, Minv, qd, b, act, mu, lam0, w_other, ld, kw):
        W, r3, d = J.shape
        save = torch.empty(
            (W, save_floats(r3 // 3, int(ld.numel()), d, kw["iters"])),
            dtype=J.dtype, device=J.device)
        lam, dqd, halv = _launch(J, Minv, qd, b, act, mu, lam0, ld,
                                 w_other, save=save, **kw)
        ctx.save_for_backward(J, Minv, qd, b, act, mu, lam0, w_other, ld,
                              save)
        ctx.kw = kw
        ctx.mark_non_differentiable(halv)
        ctx.set_materialize_grads(False)
        return lam, dqd, halv

    @staticmethod
    def backward(ctx, glam, gdqd, _ghalv):
        J, Minv, qd, b, act, mu, lam0, w_other, ld, save = ctx.saved_tensors
        if glam is None and gdqd is None:
            return (None,) * 10
        kw = ctx.kw
        gJ, gMinv, gqd, gb, gmu, glam0, gw = pgs_backward(
            J, Minv, qd, b, act, mu, lam0, ld, w_other, glam, gdqd, save,
            c=kw["c"], iters=kw["iters"], omega=kw["omega"],
            use_cone=kw["use_cone"], diag_scale=kw["diag_scale"],
            reg=kw["reg"], symmetric=kw["symmetric"])
        need = ctx.needs_input_grad
        out = (gJ, gMinv, gqd, gb, None, gmu, glam0, gw)
        return tuple(g if n else None for g, n in zip(out, need)) \
            + (None, None)


def _check(J, Minv, qd, b, act, mu, lam0, ld, c, w_other):
    W, r3, d = J.shape
    nl = int(ld.numel())
    r = r3 + 2 * nl
    want = dict(J=(W, 3 * c, d), Minv=(W, d, d), qd=(W, d), b=(W, r),
                act=(W, r), mu=(W, c), lam0=(W, r), w_other=(W, 3 * c))
    got = dict(J=J, Minv=Minv, qd=qd, b=b, act=act, mu=mu, lam0=lam0)
    if w_other is not None:
        got["w_other"] = w_other
    # the kernel is float32; the plain version also runs float64 on the
    # CPU (the float64 witness of a card-vs-CPU check)
    dtype = torch.float64 if (J.device.type == "cpu"
                              and J.dtype == torch.float64) else torch.float32
    for name, t in got.items():
        if t.dtype != dtype:
            raise TypeError(f"pgs_solve_fused: {name} must be float32 "
                            "(float64 on the CPU, all alike)")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"pgs_solve_fused: {name} must be "
                             f"{want[name]}, got {tuple(t.shape)}")
        if t.device != J.device:
            raise ValueError("pgs_solve_fused: all tensors on one device")
    if ld.dim() != 1 or ld.device != J.device:
        raise ValueError("pgs_solve_fused: ld must be a 1-D index tensor "
                         "on the operands' device")
    return W, d, nl, r


def pgs_solve_fused(J, Minv, qd, b, act, mu, lam0, *, c, ld, iters, omega,
                    use_cone, diag_scale, reg, w_other=None,
                    return_halvings=False, symmetric=True):
    """Assemble the Delassus pieces and run the projected-Jacobi solve.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version. ``pgs_solve_fused.launches`` counts kernel launches.
    Returns (lam (W, r), dqd (W, d)) and, with ``return_halvings``, the
    per-env count of divergence-guard halvings (W,) int32."""
    _check(J, Minv, qd, b, act, mu, lam0, ld, c, w_other)
    if J.device.type == "cpu":
        return pgs_solve_fused_plain(
            J, Minv, qd, b, act, mu, lam0, c=c, ld=ld, iters=iters,
            omega=omega, use_cone=use_cone, diag_scale=diag_scale, reg=reg,
            w_other=w_other, return_halvings=return_halvings,
            symmetric=symmetric)
    if J.device.type != "cuda":
        raise ValueError(f"pgs_solve_fused: unsupported device {J.device}")
    kw = dict(c=c, iters=iters, omega=omega, use_cone=use_cone,
              diag_scale=diag_scale, reg=reg, symmetric=symmetric)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (J, Minv, qd, b, act, mu, lam0, w_other)):
        lam, dqd, halv = _PGSSolve.apply(J, Minv, qd, b, act, mu, lam0,
                                         w_other, ld, kw)
    else:
        lam, dqd, halv = _launch(J, Minv, qd, b, act, mu, lam0, ld, w_other,
                                 **kw)
    return (lam, dqd, halv) if return_halvings else (lam, dqd)


def _launch(J, Minv, qd, b, act, mu, lam0, ld, w_other, *, c, iters, omega,
            use_cone, diag_scale, reg, symmetric, save=None):
    """One launch of B2, counted in ``pgs_solve_fused.launches``; with
    ``save`` (W, save_floats) the instance that also saves its forward."""
    W, r3, d = J.shape
    nl = int(ld.numel())
    r = r3 + 2 * nl
    ts = (J, Minv, qd, b, act, mu, lam0) + (
        () if w_other is None else (w_other,))
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("pgs_solve_fused kernel takes contiguous tensors")
    if ld.dtype != torch.int32 or not ld.is_contiguous():
        raise TypeError("pgs_solve_fused kernel takes ld as contiguous int32")
    from ... import _kernels
    lam = torch.empty((W, r), dtype=J.dtype, device=J.device)
    dqd = torch.empty((W, d), dtype=J.dtype, device=J.device)
    halv = torch.empty((W,), dtype=torch.int32, device=J.device)
    n_scratch = scratch_floats(c, nl, d) if W else 0
    scratch = (torch.empty((W, n_scratch), dtype=J.dtype, device=J.device)
               if n_scratch else None)
    lib = _kernels.lib()
    with torch.cuda.device(J.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = (J.data_ptr(), Minv.data_ptr(), qd.data_ptr(), b.data_ptr(),
                act.data_ptr(), mu.data_ptr(), lam0.data_ptr(),
                ld.data_ptr(),
                None if w_other is None else w_other.data_ptr(),
                lam.data_ptr(), dqd.data_ptr(), halv.data_ptr(),
                W, c, nl, d, int(iters), float(omega), int(bool(use_cone)),
                float(diag_scale), float(reg),
                None if scratch is None else scratch.data_ptr(),
                int(not symmetric))
        if save is None:
            err = lib.pgs_solve_fused_f32(*args, stream)
        else:
            err = lib.pgs_solve_fused_save_f32(*args, save.data_ptr(),
                                               stream)
    pgs_solve_fused.launches += 1
    _kernels.check(err, "pgs_solve_fused")
    return lam, dqd, halv


pgs_solve_fused.launches = 0
pgs_backward.launches = 0
