"""Slot-indexed rigid contact buffers (port of ``newton_tpu/sim/contacts.py``).

Each candidate shape pair owns a fixed number of slots; inactive slots
carry ``mask = False`` and zero depth. The normal points from shape0 toward
shape1; depth is positive when overlapping. Leading batch dims are allowed
(``(W, C, ...)`` from the batched collision pipeline).

Soft (particle-shape) contacts have one slot per candidate (particle,
shape) pair of ``ModelStructure.soft_pairs``; their normal points out of
the shape (the direction that pushes the particle free) and their depth is
the particle radius minus its signed distance. A Contacts built without
soft capacity leaves the soft fields ``None`` (``soft_contact_max == 0``).

``broad_phase_dropped`` counts the overlapping candidate pairs that the
dynamic-pair pipeline's budgets had no slot for this call, and
``mesh_samples_dropped`` the mesh samples beyond a pair's slots (0 until
mesh contacts are ported): device scalars, read only when the caller
asks. ``custom`` carries namespaced per-slot data, such as the
persistent manifolds' anchors ``manifold:a0/a1/n0``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch

from .state import map_tensors

__all__ = ["Contacts"]


@dataclass
class Contacts:
    rigid_contact_mask: torch.Tensor      # (..., C) bool
    rigid_contact_shape0: torch.Tensor    # (..., C) int32, -1 when unused
    rigid_contact_shape1: torch.Tensor    # (..., C) int32
    rigid_contact_position: torch.Tensor  # (..., C, 3) world contact point
    rigid_contact_normal: torch.Tensor    # (..., C, 3) shape0 -> shape1
    rigid_contact_depth: torch.Tensor     # (..., C) > 0 overlapping
    rigid_contact_force: torch.Tensor     # (..., C, 3)
    soft_contact_mask: Optional[torch.Tensor] = None      # (P,) bool
    soft_contact_particle: Optional[torch.Tensor] = None  # (P,) int32
    soft_contact_shape: Optional[torch.Tensor] = None     # (P,) int32
    soft_contact_position: Optional[torch.Tensor] = None  # (P, 3)
    soft_contact_normal: Optional[torch.Tensor] = None    # (P, 3) outward
    soft_contact_depth: Optional[torch.Tensor] = None     # (P,) > 0 inside
    broad_phase_dropped: Optional[torch.Tensor] = None    # () int32
    mesh_samples_dropped: Optional[torch.Tensor] = None   # () int32
    custom: Dict[str, Any] = field(default_factory=dict)
    # the ModelStructure whose static pipeline (CollisionPipeline) filled
    # these slots, in its slot order; None for Contacts made any other way
    slots: Optional[object] = field(default=None, repr=False,
                                    compare=False)
    # True where the dynamic-pair pipeline filled the slots: which shape
    # pair a slot holds changes from call to call
    dynamic: bool = field(default=False, repr=False, compare=False)

    @property
    def rigid_contact_max(self) -> int:
        return self.rigid_contact_mask.shape[-1]

    @property
    def soft_contact_max(self) -> int:
        m = self.soft_contact_mask
        return 0 if m is None else m.shape[-1]

    @classmethod
    def zeros(cls, capacity: int, batch=(), dtype=torch.float32,
              device=None) -> "Contacts":
        """Empty rigid slots and no soft capacity (``collide`` fills in
        the soft fields)."""
        C = int(capacity)
        z = dict(dtype=dtype, device=device)
        return cls(
            rigid_contact_mask=torch.zeros((*batch, C), dtype=torch.bool,
                                           device=device),
            rigid_contact_shape0=torch.full((*batch, C), -1,
                                            dtype=torch.int32, device=device),
            rigid_contact_shape1=torch.full((*batch, C), -1,
                                            dtype=torch.int32, device=device),
            rigid_contact_position=torch.zeros((*batch, C, 3), **z),
            rigid_contact_normal=torch.zeros((*batch, C, 3), **z),
            rigid_contact_depth=torch.zeros((*batch, C), **z),
            rigid_contact_force=torch.zeros((*batch, C, 3), **z),
            broad_phase_dropped=torch.zeros(batch, dtype=torch.int32,
                                            device=device),
            mesh_samples_dropped=torch.zeros(batch, dtype=torch.int32,
                                             device=device),
        )

    def to(self, device) -> "Contacts":
        return map_tensors(self, lambda t: t.to(device))
