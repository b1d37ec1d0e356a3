"""Control inputs (port of ``newton_tpu/sim/control.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from dataclasses import replace as dataclass_replace
from typing import Any, Dict, Optional

import torch

from .state import map_tensors

__all__ = ["Control"]


@dataclass
class Control:
    """Per-step control inputs, optionally with leading batch dims.

    Attributes:
        joint_target_q: position targets ``(..., joint_coord_count)``.
        joint_target_qd: velocity targets ``(..., joint_dof_count)``.
        joint_f: generalized force input ``(..., joint_dof_count)``.
        tendon_f: force added to each fixed tendon ``(..., T)``, or None.
        muscle_activations: each waypoint muscle's activation in [0, 1]
            ``(..., M)`` (``SolverSemiImplicit``), or None.
        custom: namespaced solver controls (``mjc:ctrl``: MJCF actuator
            inputs ``(..., A)``; a multi-world model's is flat, ``(N A,)``,
            world i's actuators at ``[i A, (i + 1) A)``).
    """

    joint_target_q: torch.Tensor
    joint_target_qd: torch.Tensor
    joint_f: torch.Tensor
    tendon_f: Optional[torch.Tensor] = None
    muscle_activations: Optional[torch.Tensor] = None
    custom: Dict[str, Any] = field(default_factory=dict)

    def replace(self, **kw) -> "Control":
        """A copy with the given fields replaced (the JAX package's
        ``replace``); the tensors are not copied, so a graph through them
        is kept."""
        return dataclass_replace(self, **kw)

    def clear(self) -> "Control":
        """A control with ``joint_f`` zeroed (the JAX package's
        ``clear``)."""
        return self.replace(joint_f=torch.zeros_like(self.joint_f))

    def to(self, device) -> "Control":
        return map_tensors(self, lambda t: t.to(device))
