"""SDF baking and sampling (port of ``newton_tpu/geometry/sdf.py``).

Baking is host work, once at ``finalize``: the signed distance of every
corner of a regular grid over a mesh's padded box. It runs the C++ bake of
``csrc/sdf_bake.cpp``, built with ``g++`` at first use into the package's
``_build/`` (a failed build raises), or, with ``native=False``, its plain
numpy twin (the JAX package's loop, for a machine without g++ and for the
tests). The two agree to rounding; they differ only where a grid corner's
parity ray grazes an edge, because their ray origins are jittered
differently (the JAX package's own two bakes differ the same way).

Sampling runs on the model's device in PyTorch: trilinear interpolation
of one grid, or of grids in a pool ``(n, R, R, R)`` where each point names
its grid, gathering only the 8 corners of each point's cell by their flat
index (a per-pair gather of whole grids would move gigabytes for
thousands of pairs). The gradient is the JAX package's central
difference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np
import torch

__all__ = ["bake_mesh_sdf", "bake_dense", "sample_sdf_grid",
           "sample_sdf_grad", "host_lib"]

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_HERE, "csrc", "sdf_bake.cpp")
_BUILD = os.path.join(_HERE, "_build")
# the JAX package's flags: no -march, so no FMA contraction on x86-64 and
# the same corners on every host
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lib = None


def host_lib() -> ctypes.CDLL:
    """The C++ bake library, built at first call into ``_build/host-<hash>/``
    (the hash covers the source and flags; the build goes to a temporary
    name and is renamed into place, so concurrent builders never load half
    a file). Raises if ``g++`` fails."""
    global _lib
    if _lib is not None:
        return _lib
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(" ".join(_FLAGS).encode() + f.read()
                                ).hexdigest()[:16]
    out_dir = os.path.join(_BUILD, "host-" + digest)
    so = os.path.join(out_dir, "libnewton_tpu_torch_host.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
        os.close(fd)
        res = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed to build {_SRC} "
                               f"({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    P = ctypes.POINTER
    lib.bake_sdf.argtypes = [P(ctypes.c_double), ctypes.c_int64,
                             P(ctypes.c_int32), ctypes.c_int64,
                             ctypes.c_int32, P(ctypes.c_double),
                             P(ctypes.c_double), P(ctypes.c_float)]
    lib.bake_sdf.restype = None
    _lib = lib
    return lib


def _native_bake(v, f, n, lo, hi) -> np.ndarray:
    lib = host_lib()
    v = np.ascontiguousarray(v, dtype=np.float64)
    f = np.ascontiguousarray(f, dtype=np.int32).reshape(-1)
    lo = np.ascontiguousarray(lo, dtype=np.float64)
    hi = np.ascontiguousarray(hi, dtype=np.float64)
    out = np.empty(n ** 3, dtype=np.float32)

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))
    lib.bake_sdf(ptr(v, ctypes.c_double), len(v), ptr(f, ctypes.c_int32),
                 len(f) // 3, n, ptr(lo, ctypes.c_double),
                 ptr(hi, ctypes.c_double), ptr(out, ctypes.c_float))
    return out.reshape(n, n, n)


def _point_tri_distance_sq(p, a, b, c):
    """Squared distance from points p (N, 1, 3) to triangles a, b, c
    (1, M, 3): (N, M)."""
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = np.einsum("nmk,nmk->nm", np.broadcast_arrays(ab, ap)[0], ap)
    d2 = np.einsum("nmk,nmk->nm", np.broadcast_arrays(ac, ap)[0], ap)
    bp = p - b
    d3 = np.einsum("nmk,nmk->nm", np.broadcast_arrays(ab, bp)[0], bp)
    d4 = np.einsum("nmk,nmk->nm", np.broadcast_arrays(ac, bp)[0], bp)
    cp = p - c
    d5 = np.einsum("nmk,nmk->nm", np.broadcast_arrays(ab, cp)[0], cp)
    d6 = np.einsum("nmk,nmk->nm", np.broadcast_arrays(ac, cp)[0], cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = va + vb + vc
    v = vb / np.where(np.abs(denom) < 1e-30, 1e-30, denom)
    w = vc / np.where(np.abs(denom) < 1e-30, 1e-30, denom)
    closest = a + v[..., None] * ab + w[..., None] * ac
    # vertex and edge regions
    mask = (d1 <= 0) & (d2 <= 0)
    closest = np.where(mask[..., None], np.broadcast_to(a, closest.shape),
                       closest)
    m = (d3 >= 0) & (d4 <= d3)
    closest = np.where(m[..., None], np.broadcast_to(b, closest.shape),
                       closest)
    m = (d6 >= 0) & (d5 <= d6)
    closest = np.where(m[..., None], np.broadcast_to(c, closest.shape),
                       closest)
    m = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    t = d1 / np.where(np.abs(d1 - d3) < 1e-30, 1e-30, d1 - d3)
    closest = np.where(m[..., None], a + t[..., None] * ab, closest)
    m = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    t = d2 / np.where(np.abs(d2 - d6) < 1e-30, 1e-30, d2 - d6)
    closest = np.where(m[..., None], a + t[..., None] * ac, closest)
    m = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    t = (d4 - d3) / np.where(
        np.abs((d4 - d3) + (d5 - d6)) < 1e-30, 1e-30, (d4 - d3) + (d5 - d6))
    closest = np.where(m[..., None], b + t[..., None] * (c - b), closest)
    diff = p - closest
    return np.einsum("nmk,nmk->nm", diff, diff)


def _ray_parity_sign(points: np.ndarray, v0, v1, v2) -> np.ndarray:
    """-1 inside, +1 outside, by the parity of a +x ray's crossings
    (Moller-Trumbore); the origins are jittered by an irrational sub-cell
    offset so that a ray through a shared edge is not counted twice."""
    scale = max(float(np.abs(v0).max()), 1e-9)
    points = points + scale * np.array([0.0, 1.17e-5, 2.71e-5])
    e1 = v1 - v0
    e2 = v2 - v0
    d = np.array([1.0, 0.0, 0.0])
    pvec = np.cross(d, e2)
    det = np.einsum("mk,mk->m", e1, pvec)
    inv_det = 1.0 / np.where(np.abs(det) < 1e-12, 1e-12, det)
    tvec = points[:, None, :] - v0[None, :, :]
    u = np.einsum("nmk,mk->nm", tvec, pvec) * inv_det
    qvec = np.cross(tvec, e1[None, :, :])
    v = qvec[..., 0] * inv_det
    t = np.einsum("nmk,mk->nm", qvec, e2) * inv_det
    hit = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0) & \
        (np.abs(det) > 1e-12)[None, :]
    return np.where(hit.sum(axis=1) % 2 == 1, -1.0, 1.0)


def bake_dense(vertices, indices, n: int, lower, upper,
               native: bool = True) -> np.ndarray:
    """Signed distance (n, n, n) float32 at the corners of the grid over
    [lower, upper] (x slowest): the C++ bake, or its numpy twin."""
    v = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    f = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    if native:
        return _native_bake(v, f, n, lower, upper)
    xs = [np.linspace(lower[k], upper[k], n) for k in range(3)]
    pts = np.stack(np.meshgrid(*xs, indexing="ij"), axis=-1).reshape(-1, 3)
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    out = np.empty(len(pts))
    chunk = max(1, 4_000_000 // max(len(f), 1))
    for s in range(0, len(pts), chunk):
        e = min(s + chunk, len(pts))
        d2 = _point_tri_distance_sq(pts[s:e, None, :], v0[None], v1[None],
                                    v2[None])
        out[s:e] = (np.sqrt(d2.min(axis=1))
                    * _ray_parity_sign(pts[s:e], v0, v1, v2))
    return out.reshape(n, n, n).astype(np.float32)


def bake_mesh_sdf(mesh, resolution: int = 32, margin: float = 0.1,
                  native: bool = True):
    """A dense ``SDF`` of a triangle mesh over its box padded by ``margin``
    times its largest extent."""
    from .types import SDF
    v = mesh.vertices
    lo, hi = v.min(axis=0), v.max(axis=0)
    pad = margin * max(float((hi - lo).max()), 1e-6)
    lo, hi = lo - pad, hi + pad
    data = bake_dense(v, mesh.indices, resolution, lo, hi, native=native)
    return SDF(data=data, lower=lo, upper=hi)


# ---------------------------------------------------------------------------
# sampling on the device
# ---------------------------------------------------------------------------
_COUNTS = {}


def _axis_counts(shape, device, dtype):
    """A grid's corner counts per axis as int64 and float tensors on the
    device, made once per (shape, device, dtype): a copy from host memory
    in every call would make the host wait for the card."""
    key = (shape, str(device), dtype)
    if key not in _COUNTS:
        n = torch.tensor(shape, dtype=torch.int64, device=device)
        _COUNTS[key] = (n, n.to(dtype))
    return _COUNTS[key]


def sample_sdf_grid(grid, lower, upper, points, gid=None):
    """Trilinear SDF at ``points`` (..., 3), clamped to the grid (the
    distance only grows inside it; callers cull first). ``grid`` is one
    (nx, ny, nz) grid, or with ``gid`` (...,) a pool (n, R, R, R) and each
    point's grid; ``lower``/``upper`` broadcast against the points."""
    shape = grid.shape[-3:]
    n, nf = _axis_counts(tuple(shape), points.device, points.dtype)
    u = (points - lower) / (upper - lower) * (nf - 1)
    u = torch.minimum(torch.clamp(u, min=0.0), nf - 1.001)
    i0 = torch.floor(u).to(torch.int64)
    frac = u - i0.to(u.dtype)
    i1 = torch.minimum(i0 + 1, n - 1)
    flat = grid.reshape(-1)
    base = 0 if gid is None else gid.to(torch.int64) * (
        shape[0] * shape[1] * shape[2])
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]

    def g(ix, iy, iz):
        return flat[base + (ix * shape[1] + iy) * shape[2] + iz]
    c00 = g(x0, y0, z0) * (1 - fx) + g(x1, y0, z0) * fx
    c10 = g(x0, y1, z0) * (1 - fx) + g(x1, y1, z0) * fx
    c01 = g(x0, y0, z1) * (1 - fx) + g(x1, y0, z1) * fx
    c11 = g(x0, y1, z1) * (1 - fx) + g(x1, y1, z1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def central_difference(f, points, eps: float = 1e-3):
    """(f(p + eps e_j) - f(p - eps e_j)) / (2 eps), the three j stacked
    last: the JAX package's SDF gradient."""
    e = torch.eye(3, dtype=points.dtype, device=points.device) * eps
    cols = [f(points + e[j]) - f(points - e[j]) for j in range(3)]
    return torch.stack(cols, -1) / (2 * eps)


def sample_sdf_grad(grid, lower, upper, points, gid=None, eps: float = 1e-3):
    """Central-difference gradient of :func:`sample_sdf_grid` (..., 3)."""
    return central_difference(
        lambda p: sample_sdf_grid(grid, lower, upper, p, gid), points, eps)
