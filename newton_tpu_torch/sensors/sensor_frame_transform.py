"""Frame-transform sensor: poses of target frames in reference frames
(port of ``newton_tpu/sensors/sensor_frame_transform.py``)."""

from __future__ import annotations

import fnmatch
from typing import List, Sequence

import numpy as np
import torch

from ..math import transform_inverse, transform_multiply
from ..sim.model import Model
from ..sim.state import State

__all__ = ["SensorFrameTransform", "_resolve_shapes"]


def _resolve_shapes(st, spec) -> List[int]:
    """Shape indices from an index, an index list or a key glob."""
    if isinstance(spec, str):
        return [i for i, k in enumerate(st.shape_key)
                if fnmatch.fnmatch(k, spec)]
    if isinstance(spec, (int, np.integer)):
        return [int(spec)]
    return [int(s) for s in spec]


class SensorFrameTransform:
    """``update(state)`` -> (n, 7): each target frame (a shape or site, by
    index or key) expressed in its reference frame; one reference serves
    every target."""

    def __init__(self, model: Model, reference_frames: Sequence,
                 target_frames: Sequence):
        self.model = model
        st = model.structure
        refs, tgts = [], []
        for specs, out, what in ((reference_frames, refs, "reference"),
                                 (target_frames, tgts, "target")):
            for spec in specs:
                r = _resolve_shapes(st, spec)
                if len(r) != 1:
                    raise ValueError(f"{what} {spec!r} matched {len(r)} "
                                     "shapes")
                out.append(r[0])
        if len(refs) == 1 and len(tgts) > 1:
            refs = refs * len(tgts)
        dev = model.device
        shape_body = np.asarray(st.shape_body, dtype=np.int64)
        self.ref_idx = np.asarray(refs, dtype=np.int64)
        self.tgt_idx = np.asarray(tgts, dtype=np.int64)
        self.ref_body = shape_body[self.ref_idx]
        self.tgt_body = shape_body[self.tgt_idx]
        self._frames = [
            (torch.as_tensor(s, device=dev),
             torch.as_tensor(np.maximum(b, 0), device=dev),
             torch.as_tensor(b >= 0, device=dev)[:, None])
            for s, b in ((self.ref_idx, self.ref_body),
                         (self.tgt_idx, self.tgt_body))]
        self._identity = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], device=dev)

    def _frame(self, state: State, shape, body, has_body):
        X_b = torch.where(has_body, state.body_q[body],
                          self._identity.to(state.body_q.dtype))
        return transform_multiply(X_b, self.model.shape_transform[shape])

    def update(self, state: State) -> torch.Tensor:
        X_ref = self._frame(state, *self._frames[0])
        X_tgt = self._frame(state, *self._frames[1])
        return transform_multiply(transform_inverse(X_ref), X_tgt)
