"""Environment batching (port of ``batch_state``, ``unbatch_env`` and
``vmap_step`` in ``newton_tpu/parallel/envs.py``): physics is defined on a
one-world model and every state tensor gains a leading env axis W, the
layout the batched collision pipeline and ``step_batched`` take.

``vmap_step`` maps a one-world step written in plain PyTorch over the env
axis with ``torch.func.vmap``. The generalized solvers' steps do not run
under it (ROADMAP "Not ported"): their batched form is ``step_batched``.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..sim.state import State, map_tensors
from ..utils.checkpoint import state_leaves

__all__ = ["batch_state", "unbatch_env", "vmap_step"]


def batch_state(state: State, n_envs: int) -> State:
    """Tile a single-world State into a contiguous ``(n_envs, ...)`` State."""
    return map_tensors(
        state, lambda x: x.unsqueeze(0).expand(n_envs, *x.shape).clone())


def unbatch_env(state: State, env: int) -> State:
    """Env ``env`` of a batched State, as a one-world State of its own
    (copies: later changes of either do not reach the other)."""
    return map_tensors(state, lambda x: x[env].clone())


def _with_leaves(template, names, tensors):
    kw, custom = {}, dict(getattr(template, "custom", {}))
    for n, t in zip(names, tensors):
        if n.startswith("custom/"):
            custom[n[len("custom/"):]] = t
        else:
            kw[n] = t
    if hasattr(template, "custom"):
        kw["custom"] = custom
    return template.replace(**kw)


def vmap_step(step_fn: Callable[[State], State]) -> Callable[[State], State]:
    """Vectorize a one-world ``step_fn(State) -> State`` over the leading
    env axis of every tensor of its input (``torch.func.vmap``)."""

    def batched(state: State) -> State:
        names = [n for n, _ in state_leaves(state)]
        out = {}

        def one(*tensors):
            res = step_fn(_with_leaves(state, names, tensors))
            out["template"], leaves = res, state_leaves(res)
            out["names"] = [n for n, _ in leaves]
            return tuple(t for _, t in leaves)

        result = torch.func.vmap(one)(*(t for _, t in state_leaves(state)))
        return _with_leaves(out["template"], out["names"], result)

    return batched
