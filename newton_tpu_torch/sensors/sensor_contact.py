"""Contact sensor: the net contact wrench on sets of shapes (port of
``newton_tpu/sensors/sensor_contact.py``).

It reads ``Contacts.rigid_contact_force`` (the force on shape1's side, as
``step_with_contacts`` fills it). A slot adds +f to each sensor whose
sensing set holds its shape1 and whose counterpart set (any shape when
none is given) holds its shape0, and -f to each sensor holding shape0
with shape1 as counterpart; the torque is p x f about the world origin.
The JAX package forms this with dense (sensors, shapes) and (sensors,
slots) membership matrices (ROADMAP C.37); here each sensor's terms are
listed and summed per sensor in a fixed order: for the static pipeline's
slots a (slot, sensor, sign) table built once from ``slot_shape0/1`` and
a ``FixedOrderSum``; for dynamic-pair Contacts, whose slots change
shapes every call, each slot's sensors looked up on the device in a
(shape, sensors) table and the terms summed by ``DynamicOrderSum``. No
host sync either way.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.segment_sum import (DynamicOrderSum, FixedOrderSum,
                                check_static_slots)
from ..math import cross
from ..sim.contacts import Contacts
from ..sim.model import Model
from ..sim.state import State
from .sensor_frame_transform import _resolve_shapes

__all__ = ["SensorContact"]


def _pairs(st, specs):
    """(sensor, shape) membership pairs, sorted by shape then sensor."""
    sensor, shape = [], []
    for i, spec in enumerate(specs):
        s = np.unique(np.asarray(_resolve_shapes(st, spec), dtype=np.int64))
        sensor.append(np.full(len(s), i, dtype=np.int64))
        shape.append(s)
    sensor = np.concatenate(sensor) if sensor else np.zeros(0, np.int64)
    shape = np.concatenate(shape) if shape else np.zeros(0, np.int64)
    order = np.lexsort((sensor, shape))
    return sensor[order], shape[order]


class SensorContact:
    """Net contact force and torque on shape sets.

    Args:
        model: finalized model.
        sensing_shapes: one shape-index list (or key pattern) per sensor.
        counterpart_shapes: optional matching list restricting which
            opposing shapes count (default: any).

    ``update(contacts, state=None)`` -> (force (n, 3), torque (n, 3)), the
    world-frame wrench on each sensing set, the torque about the world
    origin, from flat (C,) Contacts.
    """

    def __init__(self, model: Model, sensing_shapes: Sequence,
                 counterpart_shapes: Sequence = None):
        self.model = model
        st = model.structure
        S = st.shape_count
        self.n = len(sensing_shapes)
        self._S = S
        sensor, shape = _pairs(st, sensing_shapes)
        # each shape's sensors: CSR by shape
        counts = np.bincount(shape, minlength=S)
        self._csr = (np.concatenate([[0], np.cumsum(counts)]), sensor)
        self._counter = None
        if counterpart_shapes is not None:
            c_sensor, c_shape = _pairs(st, counterpart_shapes)
            self._counter = np.sort(c_sensor * S + c_shape)
        dev = model.device
        self._static = None
        self._dyn = None
        # the static pipeline's slots: (slot, sensor, sign) terms
        slot, dst, sign = self._terms(np.asarray(st.slot_shape0, np.int64),
                                      np.asarray(st.slot_shape1, np.int64))
        self._static = (torch.as_tensor(slot, device=dev),
                        torch.as_tensor(sign, dtype=torch.float32,
                                        device=dev),
                        FixedOrderSum(dst, self.n, dev))

    def _side(self, a, other):
        """Terms of the sensors holding shape ``a[k]`` of each slot k whose
        counterpart set holds ``other[k]``: (slot, sensor)."""
        starts, sensor = self._csr
        a = np.asarray(a, dtype=np.int64)
        ok = a >= 0
        deg = np.where(ok, starts[np.maximum(a, 0) + 1]
                       - starts[np.maximum(a, 0)], 0)
        slot = np.repeat(np.arange(len(a)), deg)
        k = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg)
        sens = sensor[starts[a[slot]] + k] if len(slot) else \
            np.zeros(0, np.int64)
        if self._counter is not None and len(slot):
            keep = np.isin(sens * self._S + np.maximum(other[slot], 0),
                           self._counter)
            slot, sens = slot[keep], sens[keep]
        return slot, sens

    def _terms(self, s0, s1):
        """Every (slot, sensor, sign) term: +1 where the sensor holds
        shape1, -1 where it holds shape0, in slot order per side."""
        slot1, sens1 = self._side(s1, s0)
        slot0, sens0 = self._side(s0, s1)
        return (np.concatenate([slot1, slot0]),
                np.concatenate([sens1, sens0]),
                np.concatenate([np.ones(len(slot1)), -np.ones(len(slot0))]))

    def _dynamic_tables(self, device):
        """(S, k) each shape's sensors (-1 padded) and the sorted
        counterpart keys, on the device (built at the first dynamic
        update)."""
        if self._dyn is None:
            starts, sensor = self._csr
            deg = np.diff(starts)
            k = max(int(deg.max(initial=0)), 1)
            tab = np.full((self._S, k), -1, dtype=np.int64)
            rows = np.repeat(np.arange(self._S), deg)
            cols = np.arange(len(sensor)) - np.repeat(starts[:-1], deg)
            tab[rows, cols] = sensor
            keys = None if self._counter is None else torch.as_tensor(
                self._counter, device=device)
            self._dyn = (torch.as_tensor(tab, device=device), keys)
        return self._dyn

    def _dynamic_dst(self, a, other):
        """(C, k) sensor of each (slot, entry) that takes the slot's
        force from this side, -1 where none."""
        tab, keys = self._dynamic_tables(a.device)
        sens = tab[a.clamp(min=0)]
        ok = (sens >= 0) & (a >= 0)[:, None]
        if keys is not None:
            key = sens.clamp(min=0) * self._S + other.clamp(min=0)[:, None]
            pos = torch.searchsorted(keys, key).clamp(max=keys.numel() - 1)
            ok &= keys[pos] == key
        return torch.where(ok, sens, -1)

    def update(self, contacts: Contacts, state: State = None):
        if contacts.rigid_contact_mask.dim() != 1:
            raise NotImplementedError(
                "SensorContact reads flat (C,) Contacts; batched (W, C) "
                "Contacts are not ported")
        f = contacts.rigid_contact_force
        wrench = torch.cat([f, cross(contacts.rigid_contact_position, f)],
                           -1)                                    # (C, 6)
        wrench = wrench * contacts.rigid_contact_mask[:, None].to(f.dtype)
        if contacts.dynamic:
            d1 = self._dynamic_dst(contacts.rigid_contact_shape1.long(),
                                   contacts.rigid_contact_shape0.long())
            d0 = self._dynamic_dst(contacts.rigid_contact_shape0.long(),
                                   contacts.rigid_contact_shape1.long())
            k = d1.shape[1]
            terms = torch.cat([wrench.repeat_interleave(k, 0),
                               -wrench.repeat_interleave(k, 0)])
            out = DynamicOrderSum(torch.cat([d1.reshape(-1),
                                             d0.reshape(-1)]),
                                  self.n)(terms)
        else:
            check_static_slots(contacts, self.model.structure, rigid=True)
            slot, sign, total = self._static
            out = total(wrench[slot] * sign[:, None])
        return out[:, 0:3], out[:, 3:6]
