"""Common solver interface (port of ``SolverBase`` in
``newton_tpu/solvers/solver.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from ..sim.contacts import Contacts
from ..sim.control import Control
from ..sim.model import Model
from ..sim.state import State

__all__ = ["SolverBase"]


class SolverBase:
    """Subclasses implement :meth:`step`, which returns the post-step State
    and leaves its inputs unchanged."""

    def __init__(self, model: Model):
        self.model = model

    @property
    def device(self) -> torch.device:
        return self.model.device

    def step(self, state_in: State, state_out: Optional[State],
             control: Optional[Control], contacts: Optional[Contacts],
             dt: float) -> State:
        raise NotImplementedError
