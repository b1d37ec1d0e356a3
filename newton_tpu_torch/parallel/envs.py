"""Environment batching (port of ``batch_state`` in
``newton_tpu/parallel/envs.py``): physics is defined on a one-world model
and every state tensor gains a leading env axis W, the layout the batched
collision pipeline and ``step_batched`` take."""

from __future__ import annotations

from ..sim.state import State, map_tensors

__all__ = ["batch_state"]


def batch_state(state: State, n_envs: int) -> State:
    """Tile a single-world State into a contiguous ``(n_envs, ...)`` State."""
    return map_tensors(
        state, lambda x: x.unsqueeze(0).expand(n_envs, *x.shape).clone())
