"""Viewer base class: the logging API every backend implements (port of
``newton_tpu/viewer/viewer.py``): set_model, begin_frame/end_frame,
log_state, log_contacts, log_shapes/log_points/log_lines/log_mesh,
log_gaussian, log_scalar, set_visible_worlds, and raycast picking. Tensors
are read back to the host at the log boundary, once a frame."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["ViewerBase", "to_numpy"]


def to_numpy(x) -> np.ndarray:
    """A host numpy array of a tensor (on any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ViewerBase:
    """Abstract viewer."""

    def __init__(self):
        self.model = None
        self.time = 0.0
        self._frame = -1
        self._visible_worlds: Optional[List[int]] = None
        self._world_offsets: Optional[np.ndarray] = None
        self.scalars: Dict[str, List[float]] = {}

    # -- lifecycle -----------------------------------------------------
    def set_model(self, model):
        self.model = model

    def begin_frame(self, time: float):
        self.time = float(time)
        self._frame += 1

    def end_frame(self):
        pass

    def is_running(self) -> bool:
        return True

    def close(self):
        pass

    # -- multi-world display --------------------------------------------
    def set_visible_worlds(self, worlds):
        self._visible_worlds = list(worlds)

    def set_world_offsets(self, offsets):
        self._world_offsets = to_numpy(offsets)

    # -- logging API -----------------------------------------------------
    def log_state(self, state):
        """Record body/particle state for the current frame."""

    def log_contacts(self, contacts, state=None):
        pass

    def log_shapes(self, name: str, shape_type, scale, xforms, colors=None):
        pass

    def log_points(self, name: str, points, radius=0.01, colors=None):
        pass

    def log_lines(self, name: str, starts, ends, colors=None):
        pass

    def log_mesh(self, name: str, vertices, indices, xform=None, colors=None):
        pass

    def log_gaussian(self, name: str, means, scales, quats=None,
                     colors=None, opacities=None):
        """Log a Gaussian-splat cloud; headless backends ignore it."""

    def log_scalar(self, name: str, value):
        self.scalars.setdefault(name, []).append(float(value))

    def log_image(self, name: str, image):
        pass

    def log_array(self, name: str, array):
        pass

    # -- interaction -----------------------------------------------------
    def apply_forces(self, state):
        """Interactive picking force hook; headless backends are identity."""
        return state

    def pick(self, state, origin, direction):
        """Raycast pick: (shape index, t) of the closest hit, or (-1, 1e10)
        on a miss (``geometry/raycast.raycast_model``)."""
        from ..geometry.raycast import raycast_model
        if self.model is None:
            return -1, float("inf")
        kw = dict(dtype=state.body_q.dtype, device=state.body_q.device)
        o = torch.as_tensor(np.asarray(origin), **kw).reshape(1, 3)
        d = torch.as_tensor(np.asarray(direction), **kw).reshape(1, 3)
        t, sidx, _ = raycast_model(self.model, state, o, d)
        return int(sidx[0]), float(t[0])
