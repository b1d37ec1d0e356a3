"""State checkpoint and resume (port of ``newton_tpu/utils/checkpoint.py``).

A State (or Control, Contacts: any dataclass of tensors with a ``custom``
dict) is saved as an ``.npz`` keyed by its field names, ``custom`` entries
as ``custom/<key>``. ``load_state`` restores onto the device and dtypes of
a ``like`` object; it also reads a checkpoint that the JAX package's
``save_state`` wrote (positional ``arr_i`` leaves beside a ``.tree`` file),
whose leaves come in the JAX State's flattening order: the fields in
declaration order, then ``custom`` by sorted key. ``state_digest`` is a
sha256 over the same leaves, each with its name, dtype and shape, for
bit-exact repeat-run checks.
"""

from __future__ import annotations

import hashlib
from dataclasses import fields, is_dataclass, replace
from typing import Any, List, Tuple

import numpy as np
import torch

__all__ = ["save_state", "load_state", "state_digest", "state_leaves"]


def state_leaves(obj: Any) -> List[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of every tensor field of a dataclass in
    declaration order (None fields skipped), then its ``custom`` tensors
    by sorted key, named ``custom/<key>``."""
    if not is_dataclass(obj):
        raise TypeError(f"expected a dataclass of tensors, got {type(obj)}")
    out = []
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out.append((f.name, v))
        elif f.name == "custom":
            out += [(f"custom/{k}", v[k]) for k in sorted(v)
                    if isinstance(v[k], torch.Tensor)]
    return out


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(path: str, state: Any) -> None:
    """Write ``state``'s tensors to ``path`` (``.npz`` appended when
    missing), keyed by field name."""
    np.savez(_npz_path(path), **{name: t.detach().cpu().numpy()
                                 for name, t in state_leaves(state)})


def load_state(path: str, like: Any) -> Any:
    """``like`` with every tensor replaced by the checkpoint's, on
    ``like``'s device and in its dtype (shapes come from the file: a
    batched checkpoint loads into an unbatched ``model.state()``); a
    ``custom`` entry that ``like`` lacks is restored in the file's dtype."""
    with np.load(_npz_path(path)) as data:
        names = [n for n, _ in state_leaves(like)]
        keys = list(data.files)
        if names and all(k == f"arr_{i}" for i, k in enumerate(keys)):
            # the JAX package's positional leaves, in its flattening order
            if len(keys) != len(names):
                raise ValueError(
                    f"{path}: {len(keys)} leaves, the State has "
                    f"{len(names)} ({names})")
            arrays = {n: data[k] for n, k in zip(names, keys)}
        else:
            missing = [n for n in names if n not in keys]
            if missing:
                raise KeyError(f"{path} lacks {missing}")
            # custom entries that ``like`` lacks (a solver's state added
            # after model.state()) come back too, in the file's dtype
            names += [k for k in keys
                      if k.startswith("custom/") and k not in names]
            arrays = {n: data[n] for n in names}
    like_t = dict(state_leaves(like))
    device = next(iter(like_t.values())).device if like_t else "cpu"

    def restored(name):
        t = like_t.get(name)
        x = torch.from_numpy(np.ascontiguousarray(arrays[name]))
        return x.to(device) if t is None else x.to(device=t.device,
                                                   dtype=t.dtype)

    kw = {n: restored(n) for n in names if not n.startswith("custom/")}
    if any(n.startswith("custom/") for n in names):
        custom = dict(like.custom)
        for n in names:
            if n.startswith("custom/"):
                custom[n[len("custom/"):]] = restored(n)
        kw["custom"] = custom
    return replace(like, **kw)


def state_digest(state: Any) -> str:
    """sha256 over ``state``'s leaves in a fixed order, each leaf's name,
    dtype and shape hashed in before its bytes; reads the tensors back to
    the host."""
    h = hashlib.sha256()
    for name, t in state_leaves(state):
        t = t.detach().contiguous().cpu()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()
