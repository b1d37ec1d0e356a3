"""Simulation state (port of ``newton_tpu/sim/state.py``).

A dataclass of tensors. A multi-world model's State is flat, every world
at once (``joint_q (N nq,)``, ``body_q (N B, 7)`` for N replicated worlds
of nq coordinates and B bodies), the layout ``SolverMuJoCo.step`` and
``collide`` take. Leading batch dims are allowed too: ``batch_state``
tiles a one-world State to the env-major layout ``(W, ...)`` that
``step_batched`` and the collision pipeline take.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict

import torch

__all__ = ["State", "map_tensors"]


def map_tensors(obj, fn):
    """Dataclass copy with ``fn`` applied to every tensor field and every
    tensor value of its ``custom`` dict."""
    kw = {}
    for f in fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = fn(v)
        elif f.name == "custom":
            kw[f.name] = {k: fn(x) if isinstance(x, torch.Tensor) else x
                          for k, x in v.items()}
    return replace(obj, **kw)


@dataclass
class State:
    """Time-varying simulation state.

    Attributes:
        body_q: body transforms ``(..., B, 7)`` [p, q_xyzw].
        body_qd: body twists ``(..., B, 6)`` [v_com, omega], world frame.
        body_f: external wrenches ``(..., B, 6)`` [f, tau] at the COM, world.
        joint_q: generalized coordinates ``(..., joint_coord_count)``.
        joint_qd: generalized velocities ``(..., joint_dof_count)``.
        particle_q: particle positions ``(..., particle_count, 3)``.
        particle_qd: particle velocities ``(..., particle_count, 3)``.
        particle_f: external particle forces ``(..., particle_count, 3)``.
        custom: namespaced solver state (e.g. ``mjc:act``, ``mpm:F``).
    """

    body_q: torch.Tensor
    body_qd: torch.Tensor
    body_f: torch.Tensor
    joint_q: torch.Tensor
    joint_qd: torch.Tensor
    particle_q: torch.Tensor
    particle_qd: torch.Tensor
    particle_f: torch.Tensor
    custom: Dict[str, Any] = field(default_factory=dict)

    def to(self, device) -> "State":
        return map_tensors(self, lambda t: t.to(device))

    def clone(self) -> "State":
        return map_tensors(self, torch.clone)
