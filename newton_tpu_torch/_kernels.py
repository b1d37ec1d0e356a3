"""Build and load the hand-written CUDA kernels in ``csrc/``.

The sources compile with ``nvcc`` for ``sm_90a``, one ``nvcc`` per source
and all at once, and link into one shared library with a plain C
interface, loaded through ``ctypes``. The build happens at
first use, from the package's own sources, into ``_build/<hash>/`` inside
the package (the hash covers the sources, headers and flags), so a second call
in the same checkout reuses it. Nothing here runs at import time: the CPU
tests import every module and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["lib", "build", "check", "refuse_grad"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_SOURCES = ("chol_inv_solve.cu", "pgs_solve.cu", "mpm_transfer.cu",
            "raycast.cu", "chol_backward.cu", "pgs_backward.cu")
_HEADERS = ("exact_math.cuh", "pgs_save.cuh")

_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # Mi, rhs, Minv, x, W, d, scratch, stream
    "chol_inv_solve_f32": [_P, _P, _P, _P, _I, _I, _P, _P],
    # d -> instance code (linalg.INSTANCE_CODES)
    "chol_kernel_instance": [_I],
    # J, Minv, qd, b, act, mu, lam0, ld, w_other (or NULL), lam, dqd,
    # halvings, W, c, nl, d, iters, omega, use_cone, diag_scale, reg,
    # scratch, minv_t (1: Minv is not symmetric, MJ = J Minv^T), stream
    "pgs_solve_fused_f32": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _F, _I, _F, _F, _P, _I,
                            _P],
    # the same with the forward saved: ..., minv_t, save, stream
    "pgs_solve_fused_save_f32": [_P] * 12 + [_I, _I, _I, _I, _I, _F, _I, _F,
                                             _F, _P, _I, _P, _P],
    # c, nl, d, iters -> floats per env of the saved forward
    "pgs_save_floats": [_I, _I, _I, _I],
    # c, nl, d, &registers, &blocks per SM of the save instance
    "pgs_save_kernel_info": [_I, _I, _I, _P, _P],
    # c, nl, d -> bytes of one pgs block's state
    "pgs_smem_bytes": [_I, _I, _I],
    # c, nl, d -> instance code (pgs.INSTANCE_CODES)
    "pgs_kernel_instance": [_I, _I, _I],
    # d, &registers, &blocks per SM (occupancy of the launch at d)
    "chol_kernel_info": [_I, _P, _P],
    # c, nl, d, &registers, &blocks per SM
    "pgs_kernel_info": [_I, _I, _I, _P, _P],
    # res -> int32 entries of the bins' meta
    "mpm_meta_ints": [_I],
    # base, meta, sorted, N, res, stream
    "mpm_bin_particles": [_P, _P, _P, _I, _I, _P],
    # w_ax, vals, meta, sorted, scratch, grid, N, C, res, stream
    "mpm_p2g_binned_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # w_ax, grid, meta, sorted, out, N, C, res, stream
    "mpm_g2p_binned_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # which, &registers, &shared bytes, &blocks per SM
    "mpm_kernel_info": [_I, _P, _P, _P],
    # d -> floats of global scratch per env
    "chol_scratch_floats": [_I],
    # c, nl, d -> floats of global scratch per env
    "pgs_scratch_floats": [_I, _I, _I],
    # o, d, R, X, scale, cls, order, counts, gbox, tbox, max_dist, t,
    # shape, n, stats (or NULL), stream
    "raycast_closest_f32": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _F, _P,
                            _P, _P, _P, _P],
    # o, d, R, X (or NULL), scale (or NULL), bvh_of, M, boxes, slots,
    # counts, params, K, t, n, stats (or NULL), stream
    "raycast_mesh_f32": [_P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _I, _P,
                         _P, _P, _P],
    # which (0: K1; 1: K2, 2: K2's counting instance), &registers, &blocks
    # per SM
    "raycast_kernel_info": [_I, _P, _P],
    # K3: Minv (or NULL), x, gx (or NULL), gMinv (or NULL), grhs (written
    # with Minv, read without), gMi, W, d, scratch (W d d with gMinv at
    # d > 32, else NULL), stream
    "chol_inv_solve_backward_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    # d, &registers, &blocks per SM of K3's instance at d
    "chol_backward_kernel_info": [_I, _P, _P],
    # K4: J, Minv, qd, b, act, mu, lam0, ld, w_other (or NULL), glam (or
    # NULL), gdqd (or NULL), save (B2's saved forward), gJ, gMinv, gqd,
    # gb, gmu, glam0, gw (NULL without w_other), W, c, nl, d, iters,
    # omega, use_cone, diag_scale, reg, scratch (the global instance),
    # minv_t, stream
    "pgs_solve_backward_f32": [_P] * 19 + [_I] * 5 + [_F, _I, _F, _F, _P,
                                                     _I, _P],
    # c, nl, d, iters -> K4's instance (0: shared memory, 1: global)
    "pgs_backward_instance": [_I, _I, _I, _I],
    # c, nl, d, iters -> floats of one env's K4 workspace
    "pgs_backward_scratch_floats": [_I, _I, _I, _I],
    # c, nl, d, iters, &registers, &blocks per SM of K4's launch
    "pgs_backward_kernel_info": [_I, _I, _I, _I, _P, _P],
}
_RESTYPES = {"chol_scratch_floats": ctypes.c_longlong,
             "pgs_scratch_floats": ctypes.c_longlong,
             "pgs_backward_scratch_floats": ctypes.c_longlong,
             "pgs_save_floats": ctypes.c_longlong}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the kernels if this checkout has no build of the current
    sources; returns the path of the shared library. nvcc's report
    (registers, shared memory, spills per kernel) goes to ``ptxas.log``
    beside it."""
    out_dir = os.path.join(_BUILD, _digest())
    so = os.path.join(out_dir, "libnewton_tpu_torch_kernels.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir)
    nvcc = _nvcc()
    procs = []
    for name in _SOURCES:
        obj = os.path.join(work, name + ".o")
        cmd = [nvcc, *_FLAGS, "-c", "-o", obj, os.path.join(_CSRC, name)]
        procs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    report, failed = [], []
    for obj, proc in procs:
        _, err = proc.communicate()
        report.append(err)
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(obj)} ({proc.returncode}):\n"
                          f"{err}")
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    tmp = os.path.join(work, "lib.so")
    res = subprocess.run([nvcc, "-shared", "-o", tmp,
                          *[obj for obj, _ in procs]],
                         capture_output=True, text=True)
    if res.returncode != 0:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    with open(os.path.join(out_dir, "ptxas.log"), "w") as f:
        f.write("".join(report))
    os.replace(tmp, so)            # atomic: a reader never sees half a file
    shutil.rmtree(work, ignore_errors=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        handle.ntt_error_string.argtypes = [_I]
        handle.ntt_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel launch reported a CUDA error."""
    if err != 0:
        msg = lib().ntt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel without a backward would drop a gradient: grad
    mode is on and an input requires grad."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: an input requires grad, and this "
                           "kernel's backward is not ported yet; run it "
                           "under torch.no_grad() or detach its inputs")
