"""Gains and index tables of the controllers, moved to the state's device
once and reused."""

from __future__ import annotations

import numpy as np
import torch


class DeviceValue:
    """A number, an array or a tensor, handed out as a tensor on the
    device and dtype asked for (converted at the first request for that
    pair, then cached)."""

    def __init__(self, value, dtype=None):
        self.value = value
        self.dtype = dtype
        self._on = {}

    def on(self, like: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or like.dtype
        key = (like.device, dtype)
        t = self._on.get(key)
        if t is None:
            v = self.value
            if isinstance(v, torch.Tensor):
                t = v.to(device=like.device, dtype=dtype)
            else:
                t = torch.as_tensor(np.asarray(v), dtype=dtype,
                                    device=like.device)
            self._on[key] = t
        return t


def coords_and_dofs(ci, dof_indices, like: torch.Tensor):
    """(coordinate, dof) index tensors: ``ci`` (a DeviceValue or None: the
    dof indices) and ``dof_indices``, on ``like``'s device."""
    di = dof_indices if isinstance(dof_indices, torch.Tensor) \
        else torch.as_tensor(np.asarray(dof_indices, dtype=np.int64),
                             device=like.device)
    return (di if ci is None else ci.on(like)), di


def targets(command, qd):
    """(q_target, qd_target): a (n,) command is the position target with
    velocity target 0, a (2, n) one stacks both."""
    command = torch.as_tensor(command, device=qd.device)
    if command.dim() == 2:
        return command[0], command[1]
    return command, torch.zeros_like(qd)
