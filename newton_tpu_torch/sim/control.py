"""Control inputs (port of ``newton_tpu/sim/control.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
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
        custom: namespaced solver controls (``mjc:ctrl``: MJCF actuator
            inputs ``(..., A)``; a multi-world model's is flat, ``(N A,)``,
            world i's actuators at ``[i A, (i + 1) A)``).
    """

    joint_target_q: torch.Tensor
    joint_target_qd: torch.Tensor
    joint_f: torch.Tensor
    tendon_f: Optional[torch.Tensor] = None
    custom: Dict[str, Any] = field(default_factory=dict)

    def to(self, device) -> "Control":
        return map_tensors(self, lambda t: t.to(device))
