"""On-disk cache of baked SDFs, dense grids and sparse textures (port of
``newton_tpu/geometry/sdf_cache.py``).

Baking is the costly part of ``finalize`` for mesh scenes and meshes
recur across runs, so a bake is kept under a key hashing the mesh's
vertices and indices and every bake parameter. The cache lives in the
port's own directory, ``newton_tpu_torch/_build/sdf_cache`` (inside the
checkout, git-ignored), or in ``$NEWTON_TPU_TORCH_SDF_CACHE_DIR`` (an
empty directory there gives fresh bakes). A write goes to a temporary
file renamed into place, so concurrent processes are safe.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Optional

import numpy as np

__all__ = ["cache_dir", "mesh_bake_key", "load", "store",
           "cached_bake_mesh_sdf", "cached_bake_texture_sdf"]

_ENV_DIR = "NEWTON_TPU_TORCH_SDF_CACHE_DIR"
_VERSION = 1
_DEFAULT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build", "sdf_cache")


def cache_dir() -> str:
    return os.environ.get(_ENV_DIR) or _DEFAULT


def mesh_bake_key(vertices: np.ndarray, indices: np.ndarray,
                  **params) -> str:
    h = hashlib.sha1()
    h.update(b"newton_tpu_torch_sdf_v%d" % _VERSION)
    h.update(np.ascontiguousarray(np.asarray(vertices, dtype=np.float64))
             .tobytes())
    h.update(np.ascontiguousarray(np.asarray(indices, dtype=np.int64))
             .tobytes())
    for k in sorted(params):
        h.update(f"{k}={params[k]!r}".encode())
    return h.hexdigest()


def load(key: str) -> Optional[dict]:
    path = os.path.join(cache_dir(), key + ".npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception:          # a damaged entry is baked again
        return None


def store(key: str, arrays: dict) -> None:
    d = cache_dir()
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, os.path.join(d, key + ".npz"))


def cached_bake_mesh_sdf(mesh, resolution: int, margin: float = 0.1):
    """``bake_mesh_sdf`` memoized on disk."""
    from .sdf import bake_mesh_sdf
    from .types import SDF
    key = mesh_bake_key(mesh.vertices, mesh.indices, kind="dense",
                        resolution=int(resolution), margin=float(margin))
    hit = load(key)
    if hit is not None:
        return SDF(data=hit["data"], lower=hit["lower"], upper=hit["upper"])
    sdf = bake_mesh_sdf(mesh, resolution=resolution, margin=margin)
    store(key, {"data": sdf.data, "lower": sdf.lower, "upper": sdf.upper})
    return sdf


def cached_bake_texture_sdf(mesh, resolution: int, margin: float = 0.1,
                            band_cells: float = 3.0):
    """``bake_texture_sdf`` memoized on disk."""
    from .sdf_texture import TextureSDF, bake_texture_sdf
    key = mesh_bake_key(mesh.vertices, mesh.indices, kind="texture",
                        resolution=int(resolution), margin=float(margin),
                        band_cells=float(band_cells))
    hit = load(key)
    if hit is not None:
        return TextureSDF(**{k: hit[k] for k in (
            "block_index", "blocks", "block_scale", "block_offset",
            "coarse", "lower", "upper")})
    tex = bake_texture_sdf(mesh, resolution=resolution, margin=margin,
                           band_cells=band_cells)
    store(key, {"block_index": tex.block_index, "blocks": tex.blocks,
                "block_scale": tex.block_scale,
                "block_offset": tex.block_offset, "coarse": tex.coarse,
                "lower": tex.lower, "upper": tex.upper})
    return tex
