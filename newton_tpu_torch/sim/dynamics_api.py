"""Articulation dynamics API (port of ``eval_mass_matrix`` in
``newton_tpu/sim/dynamics_api.py``)."""

from __future__ import annotations

from typing import List

import torch

from .model import Model
from .state import State

__all__ = ["eval_mass_matrix"]


def eval_mass_matrix(model: Model, state: State) -> List[torch.Tensor]:
    """Joint-space mass matrices, one ``(n, d, d)`` tensor per articulation
    group of the generalized solver (a group without dofs is left out), at
    the flat ``state``'s poses."""
    from ..solvers.generalized.solver import SolverFeatherstone
    Ms = SolverFeatherstone(model).group_mass_matrices(state)
    return [M for M in Ms if M is not None]
