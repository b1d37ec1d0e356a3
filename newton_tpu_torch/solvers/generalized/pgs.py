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
"""

from __future__ import annotations

import torch

__all__ = ["pgs_solve_fused", "pgs_solve_fused_plain", "pgs_core",
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
        u = u2 / torch.clamp(nrm, min=1e-9)
    return lam_max


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
    step = torch.clamp(1.8 / torch.clamp(1.1 * lam_max, min=1e-9), max=1.0)
    scale = omega * step                                  # (W,)
    halvings = torch.zeros_like(scale, dtype=torch.int32)

    lam = lam0
    prev_dn = None
    for _ in range(iters):
        res = Avec(lam) + v_free - b
        lam_full = lam - (scale[:, None] / diag) * res
        ln = torch.clamp(lam_full[:, 0:c], min=0.0)
        cap = mu * ln
        lt1 = lam_full[:, c:2 * c]
        lt2 = lam_full[:, 2 * c:r3]
        if use_cone:
            tmag = torch.sqrt(lt1 * lt1 + lt2 * lt2)
            sc = torch.clamp(cap / torch.clamp(tmag, min=1e-9), max=1.0)
            lt1, lt2 = lt1 * sc, lt2 * sc
        else:
            lt1 = torch.minimum(torch.maximum(lt1, -cap), cap)
            lt2 = torch.minimum(torch.maximum(lt2, -cap), cap)
        parts = [ln, lt1, lt2]
        if nl:
            parts.append(torch.clamp(lam_full[:, r3:], min=0.0))
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
    W, d, nl, r = _check(J, Minv, qd, b, act, mu, lam0, ld, c, w_other)
    kw = dict(c=c, ld=ld, iters=iters, omega=omega, use_cone=use_cone,
              diag_scale=diag_scale, reg=reg, w_other=w_other,
              return_halvings=return_halvings, symmetric=symmetric)
    if J.device.type == "cpu":
        return pgs_solve_fused_plain(J, Minv, qd, b, act, mu, lam0, **kw)
    if J.device.type != "cuda":
        raise ValueError(f"pgs_solve_fused: unsupported device {J.device}")
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
    with torch.cuda.device(J.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().pgs_solve_fused_f32(
            J.data_ptr(), Minv.data_ptr(), qd.data_ptr(), b.data_ptr(),
            act.data_ptr(), mu.data_ptr(), lam0.data_ptr(), ld.data_ptr(),
            None if w_other is None else w_other.data_ptr(),
            lam.data_ptr(), dqd.data_ptr(), halv.data_ptr(),
            W, c, nl, d, int(iters), float(omega), int(bool(use_cone)),
            float(diag_scale), float(reg),
            None if scratch is None else scratch.data_ptr(),
            int(not symmetric), stream)
    pgs_solve_fused.launches += 1
    _kernels.check(err, "pgs_solve_fused")
    return (lam, dqd, halv) if return_halvings else (lam, dqd)


pgs_solve_fused.launches = 0
