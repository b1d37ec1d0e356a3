"""Actuator pipeline: delay -> controller -> clamping -> joint_f (port of
``newton_tpu/actuators/actuator.py``).

The actuator is a function with an explicit carry: the delay ring, a
device tensor, and its head, a host int (the step count, never read back
from the device). It returns a new Control and leaves its inputs as they
are.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..sim.control import Control
from ..sim.model import Model
from ..sim.state import State

__all__ = ["Actuator", "Delay", "DelayState"]


class DelayState(NamedTuple):
    buffer: torch.Tensor  # (steps, n)
    head: int


class Delay:
    """Fixed-step transport delay over actuator commands. As in the JAX
    package, the command written at step k is read back at step
    k + steps - 1: ``Delay(1)`` does not delay and ``Delay(2)`` delays by
    one step (ROADMAP C.35)."""

    def __init__(self, steps: int, n: int, dtype=torch.float32,
                 device=None):
        self.steps = int(steps)
        self.n = int(n)
        self.dtype = dtype
        self.device = device

    def init(self) -> DelayState:
        return DelayState(torch.zeros((max(self.steps, 1), self.n),
                                      dtype=self.dtype, device=self.device),
                          0)

    def __call__(self, ds: DelayState, u: torch.Tensor):
        if self.steps == 0:
            return ds, u
        buf = ds.buffer.clone()
        buf[ds.head % self.steps] = u
        return (DelayState(buf, ds.head + 1),
                buf[(ds.head + 1) % self.steps])


class Actuator:
    """delay -> controller -> clamp, added into ``control.joint_f`` at
    ``dof_indices``.

    Args:
        model: finalized model.
        dof_indices: generalized dof indices this actuator drives.
        controller: callable (model, state, command, dof_indices) ->
            effort, e.g. a PD from :mod:`newton_tpu_torch.controllers`.
        clamping: callable (model, state, effort, dof_indices) -> effort.
        delay_steps: transport delay in control steps (see ``Delay``).
    """

    def __init__(self, model: Model, dof_indices,
                 controller: Callable, clamping: Optional[Callable] = None,
                 delay_steps: int = 0):
        self.model = model
        self.dof_indices = torch.as_tensor(
            dof_indices, dtype=torch.long, device=model.device).reshape(-1)
        self.controller = controller
        self.clamping = clamping
        self.delay = Delay(delay_steps, len(self.dof_indices),
                           device=model.device)

    def init_carry(self):
        return self.delay.init()

    def __call__(self, carry, state: State, control: Control,
                 command: torch.Tensor) -> Tuple[Any, Control]:
        carry, cmd = self.delay(carry, torch.as_tensor(
            command, device=self.model.device))
        effort = self.controller(self.model, state, cmd, self.dof_indices)
        if self.clamping is not None:
            effort = self.clamping(self.model, state, effort,
                                   self.dof_indices)
        # the dof indices do not repeat: a plain indexed add
        joint_f = control.joint_f.clone()
        joint_f[self.dof_indices] += effort
        return carry, replace(control, joint_f=joint_f)
