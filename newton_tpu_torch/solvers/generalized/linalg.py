"""Batched small SPD factor + solve + explicit inverse (port of the TPU
kernel ``newton_tpu/solvers/generalized/linalg_pallas.py``).

``chol_inv_solve`` is the wrapper the batched step calls once per substep:
on CUDA tensors it launches the hand-written kernel in
``csrc/chol_inv_solve.cu``; on CPU tensors it runs the plain PyTorch
version beside it, ``chol_inv_solve_plain``, which is the counterpart of the
JAX package's ``batched._chol_t`` / ``batched._cho_solve_t`` (in float32,
or in float64 on the CPU; the kernel takes float32 only). Layout is
env-major: ``Mi (W, d, d)``, ``rhs (W, d)``. Every d has a kernel instance
(``kernel_instance`` mirrors the kernel's choice from the shape alone).
``chol_solve`` launches the same kernel for x alone (the equality rows'
system, whose inverse nothing reads; the JAX package's ``solve_psd``); its
x equals ``chol_inv_solve``'s bit for bit.

Gradients: on the CPU autograd runs through the plain version. On the card
both wrappers are ``torch.autograd.Function``s whose backward is the
kernel in ``csrc/chol_backward.cu`` (``chol_backward.launches`` counts it):
from the saved Minv and x it forms grhs = Minv gx and the Mi gradient
-(grhs x^T + Minv gMinv Minv), folded onto the lower triangle as autograd
of the plain factor gives it (the factor reads only that triangle). It
runs B1's register size at d <= 32 (``backward_instance`` names it), a
warp holding one to four envs in shared memory, and a generic instance
with a per-env global scratch above.
``chol_solve`` keeps no inverse: its backward gets grhs from one more
``chol_solve`` launch (counted in ``chol_solve.launches``), then the
kernel forms -grhs x^T.
"""

from __future__ import annotations

import torch

__all__ = ["chol_inv_solve", "chol_inv_solve_plain", "chol_solve",
           "chol_solve_plain", "cholesky_plain", "cho_solve_plain",
           "chol_backward", "fold_lower",
           "kernel_instance", "backward_instance", "generic_floats",
           "INSTANCE_CODES"]

_REG_SIZES = (8, 14, 16, 23, 24, 32)    # one warp per env, D registers
_SMEM_BYTES = 227 * 1024                # shared memory of one H100 block

# the kernel's instance codes (csrc/chol_inv_solve.cu: instance())
INSTANCE_CODES = {**{f"reg{D}": D for D in _REG_SIZES},
                  "generic_smem": 100, "generic_global": 101}


def generic_floats(d: int) -> int:
    """Floats of one env in the generic instance: the factor, 1/L_jj and
    the d + 1 columns of [I | rhs]."""
    return d * d + d + d * (d + 1)


def kernel_instance(d: int) -> str:
    """The kernel instance that runs a d x d system: ``reg<D>`` (one warp
    per env, the smallest register size D >= d, with 14 and 23 exact),
    ``generic_smem`` (one block per env, in shared memory) or
    ``generic_global`` (one block per env, in global scratch)."""
    if d < 1:
        raise ValueError(f"chol_inv_solve: d must be >= 1, got {d}")
    if d <= 32:
        D = (8 if d <= 8 else 14 if d == 14 else 16 if d <= 16
             else 23 if d == 23 else 24 if d <= 24 else 32)
        return f"reg{D}"
    return ("generic_smem" if 4 * generic_floats(d) <= _SMEM_BYTES
            else "generic_global")


def backward_instance(d: int) -> str:
    """The name of the K3 instance that runs a d x d backward (the kernel
    takes B1's choice itself): B1's register size ``reg<D>`` for d <= 32
    (envs of a warp in shared memory), else ``generic_global`` (one warp
    per env, a per-env global scratch)."""
    if d < 1:
        raise ValueError(f"chol_backward: d must be >= 1, got {d}")
    return kernel_instance(d) if d <= 32 else "generic_global"


def cholesky_plain(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky of (W, d, d) SPD matrices; the diagonal is clamped
    as sqrt(max(L_jj, 1e-12)) (batched._chol_t)."""
    d = A.shape[-1]
    idx = torch.arange(d, device=A.device)
    L = A.clone()
    for j in range(d):
        diag = torch.sqrt(torch.clamp(L[:, j, j], min=1e-12))
        col = L[:, :, j] / diag[:, None]
        col = torch.where(idx >= j, col, torch.zeros_like(col))
        col[:, j] = diag
        mask = ((idx > j)[:, None] & (idx > j)[None, :]).to(A.dtype)
        L = L - mask * (col[:, :, None] * col[:, None, :])
        L[:, :, j] = col
    return L * torch.tril(torch.ones(d, d, dtype=A.dtype, device=A.device))


def cho_solve_plain(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b with L = cholesky_plain(A); b (W, d, k)
    (batched._cho_solve_t)."""
    d = L.shape[-1]
    idx = torch.arange(d, device=L.device)
    y = b.clone()
    for i in range(d):
        yi = y[:, i] / L[:, i, i][:, None]                      # (W, k)
        lower = (idx > i).to(L.dtype)[None, :, None]
        y = y - (lower * L[:, :, i][:, :, None]) * yi[:, None, :]
        y[:, i] = yi
    x = y
    for i in reversed(range(d)):
        xi = x[:, i] / L[:, i, i][:, None]
        upper = (idx < i).to(L.dtype)[None, :, None]
        x = x - (upper * L[:, i, :][:, :, None]) * xi[:, None, :]
        x[:, i] = xi
    return x


def chol_inv_solve_plain(Mi: torch.Tensor, rhs: torch.Tensor):
    """Plain PyTorch version: (Minv (W, d, d), x (W, d))."""
    W, d, _ = Mi.shape
    eye = torch.eye(d, dtype=Mi.dtype, device=Mi.device).expand(W, d, d)
    x = cho_solve_plain(cholesky_plain(Mi),
                        torch.cat([eye, rhs[:, :, None]], dim=2))
    return x[:, :, :d].contiguous(), x[:, :, d].contiguous()


def chol_solve_plain(Mi: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``chol_solve``: x (W, d)."""
    L = cholesky_plain(Mi)
    return cho_solve_plain(L, rhs[:, :, None])[:, :, 0].contiguous()


def _check(Mi: torch.Tensor, rhs: torch.Tensor):
    # the kernel is float32; the plain version also runs float64 on the
    # CPU (the float64 witness of a card-vs-CPU check)
    ok = (torch.float32, torch.float64) if Mi.device.type == "cpu" \
        else (torch.float32,)
    if Mi.dtype not in ok or rhs.dtype != Mi.dtype:
        raise TypeError("chol_inv_solve takes float32 tensors (float64 on "
                        "the CPU)")
    if Mi.dim() != 3 or Mi.shape[1] != Mi.shape[2]:
        raise ValueError(f"Mi must be (W, d, d), got {tuple(Mi.shape)}")
    if rhs.shape != Mi.shape[:2]:
        raise ValueError(f"rhs must be (W, d) = {tuple(Mi.shape[:2])}, "
                         f"got {tuple(rhs.shape)}")
    if Mi.device != rhs.device:
        raise ValueError("Mi and rhs must be on the same device")


def _launch(Mi: torch.Tensor, rhs: torch.Tensor, wrapper):
    """One launch of the kernel for ``wrapper`` (``chol_inv_solve``:
    (Minv, x); ``chol_solve``: (None, x)), counted in
    ``wrapper.launches``."""
    if Mi.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device "
                         f"{Mi.device}")
    W, d, _ = Mi.shape
    if not (Mi.is_contiguous() and rhs.is_contiguous()):
        raise ValueError(f"{wrapper.__name__} kernel takes contiguous "
                         "tensors")
    from ... import _kernels
    Minv = torch.empty_like(Mi) if wrapper is chol_inv_solve else None
    x = torch.empty_like(rhs)
    scratch = None
    if W and kernel_instance(d) == "generic_global":
        scratch = torch.empty((W, generic_floats(d)), dtype=Mi.dtype,
                              device=Mi.device)
    with torch.cuda.device(Mi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().chol_inv_solve_f32(
            Mi.data_ptr(), rhs.data_ptr(),
            None if Minv is None else Minv.data_ptr(), x.data_ptr(),
            W, d, None if scratch is None else scratch.data_ptr(), stream)
    wrapper.launches += 1
    _kernels.check(err, wrapper.__name__)
    return Minv, x


def fold_lower(G: torch.Tensor) -> torch.Tensor:
    """The gradient of a function of the lower triangle of a symmetric
    matrix, from its gradient G as a function of the whole matrix: G_ij +
    G_ji below the diagonal, G_ii on it, 0 above (what autograd of
    ``cholesky_plain`` gives; the kernel writes the same)."""
    low = torch.tril(G, -1) + torch.tril(G.transpose(-1, -2), -1)
    return low + torch.diag_embed(torch.diagonal(G, dim1=-2, dim2=-1))


def chol_backward(Minv, x, gx, gMinv, grhs=None):
    """One launch of K3 (``csrc/chol_backward.cu``), counted in
    ``chol_backward.launches``: returns (gMi (W, d, d), grhs (W, d)).
    With Minv, grhs = Minv gx is formed (gx or gMinv may be None, a zero
    cotangent); without it (``chol_solve``) grhs is given."""
    if x.device.type != "cuda":
        raise ValueError(f"chol_backward: unsupported device {x.device}")
    W, d = x.shape
    Minv, x, gx, gMinv, grhs = (None if t is None else t.contiguous()
                                for t in (Minv, x, gx, gMinv, grhs))
    if not all(t.dtype == torch.float32 and t.device == x.device
               for t in (Minv, x, gx, gMinv, grhs) if t is not None):
        raise TypeError("chol_backward takes float32 tensors on one device")
    if Minv is None and grhs is None:
        raise ValueError("chol_backward: Minv or grhs is needed")
    from ... import _kernels
    gMi = torch.empty((W, d, d), dtype=x.dtype, device=x.device)
    if grhs is None:
        grhs = torch.empty_like(x)
    scratch = (torch.empty((W, d, d), dtype=x.dtype, device=x.device)
               if gMinv is not None and W and d > 32 else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels.lib().chol_inv_solve_backward_f32(
            ptr(Minv), x.data_ptr(), ptr(gx), ptr(gMinv), grhs.data_ptr(),
            gMi.data_ptr(), W, d, ptr(scratch), stream)
    chol_backward.launches += 1
    _kernels.check(err, "chol_backward")
    return gMi, grhs


class _CholInvSolve(torch.autograd.Function):
    """B1 forward, K3 backward."""

    @staticmethod
    def forward(ctx, Mi, rhs):
        Minv, x = _launch(Mi, rhs, chol_inv_solve)
        ctx.save_for_backward(Minv, x)
        ctx.set_materialize_grads(False)
        return Minv, x

    @staticmethod
    def backward(ctx, gMinv, gx):
        Minv, x = ctx.saved_tensors
        if gMinv is None and gx is None:
            return None, None
        gMi, grhs = chol_backward(Minv, x, gx, gMinv)
        return gMi, (grhs if gx is not None else None)


class _CholSolve(torch.autograd.Function):
    """B1 forward without the inverse; backward: one more B1 solve for
    grhs, then K3."""

    @staticmethod
    def forward(ctx, Mi, rhs):
        x = _launch(Mi, rhs, chol_solve)[1]
        ctx.save_for_backward(Mi, x)
        ctx.set_materialize_grads(False)
        return x

    @staticmethod
    def backward(ctx, gx):
        if gx is None:
            return None, None
        Mi, x = ctx.saved_tensors
        grhs = _launch(Mi, gx.contiguous(), chol_solve)[1]
        gMi = chol_backward(None, x, None, None, grhs)[0] \
            if ctx.needs_input_grad[0] else None
        return gMi, grhs


def chol_inv_solve(Mi: torch.Tensor, rhs: torch.Tensor):
    """Factor Mi = L L^T and return (Minv, x = Mi^-1 rhs), env-major.

    CUDA tensors go to the kernel (or raise), its backward to K3; CPU
    tensors to the plain version, under autograd.
    ``chol_inv_solve.launches`` counts kernel launches."""
    _check(Mi, rhs)
    if Mi.device.type == "cpu":
        return chol_inv_solve_plain(Mi, rhs)
    return _CholInvSolve.apply(Mi, rhs)


def chol_solve(Mi: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x = Mi^-1 rhs alone, through the same kernel without the inverse.

    CUDA tensors go to the kernel (or raise), its backward to one more
    launch and K3; CPU tensors to the plain version, under autograd.
    ``chol_solve.launches`` counts kernel launches."""
    _check(Mi, rhs)
    if Mi.device.type == "cpu":
        return chol_solve_plain(Mi, rhs)
    return _CholSolve.apply(Mi, rhs)


chol_inv_solve.launches = 0
chol_solve.launches = 0
chol_backward.launches = 0
