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
"""

from __future__ import annotations

import torch

__all__ = ["chol_inv_solve", "chol_inv_solve_plain", "chol_solve",
           "chol_solve_plain", "cholesky_plain", "cho_solve_plain",
           "kernel_instance", "generic_floats", "INSTANCE_CODES"]

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


def chol_inv_solve(Mi: torch.Tensor, rhs: torch.Tensor):
    """Factor Mi = L L^T and return (Minv, x = Mi^-1 rhs), env-major.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version. ``chol_inv_solve.launches`` counts kernel launches."""
    _check(Mi, rhs)
    if Mi.device.type == "cpu":
        return chol_inv_solve_plain(Mi, rhs)
    return _launch(Mi, rhs, chol_inv_solve)


def chol_solve(Mi: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x = Mi^-1 rhs alone, through the same kernel without the inverse.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version. ``chol_solve.launches`` counts kernel launches."""
    _check(Mi, rhs)
    if Mi.device.type == "cpu":
        return chol_solve_plain(Mi, rhs)
    return _launch(Mi, rhs, chol_solve)[1]


chol_inv_solve.launches = 0
chol_solve.launches = 0
