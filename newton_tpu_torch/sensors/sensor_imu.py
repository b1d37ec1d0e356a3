"""IMU sensor: proper acceleration and angular velocity in site frames
(port of ``newton_tpu/sensors/sensor_imu.py``)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..math import cross, quat_rotate, quat_rotate_inv, transform_multiply
from ..sim.model import Model
from ..sim.state import State

__all__ = ["SensorIMU"]


class SensorIMU:
    """Accelerometer and gyroscope at site shapes (indices or keys).

    ``update(state, prev_state, dt)`` -> (lin_acc (n, 3), ang_vel (n, 3))
    in each site's frame. The acceleration is the finite difference of
    the body's COM twist from ``prev_state`` over ``dt`` (zero without
    it), carried to the site (tangential and centripetal terms), minus
    the world's gravity: the proper acceleration an accelerometer
    reads."""

    def __init__(self, model: Model, sites: Sequence):
        self.model = model
        st = model.structure
        idx = [st.shape_key.index(s) if isinstance(s, str) else int(s)
               for s in sites]
        self.site_idx = np.asarray(idx, dtype=np.int64)
        self.body_idx = np.asarray(st.shape_body, dtype=np.int64)[
            self.site_idx]
        if (self.body_idx < 0).any():
            raise ValueError("IMU sites must be attached to bodies")
        dev = model.device
        world = np.maximum(np.asarray(st.body_world)[self.body_idx], 0)
        self._site = torch.as_tensor(self.site_idx, device=dev)
        self._body = torch.as_tensor(self.body_idx, device=dev)
        self._gravity = model.gravity[torch.as_tensor(world, device=dev)]
        self._X_site = model.shape_transform[self._site]
        self._com = model.body_com[self._body]

    def update(self, state: State, prev_state: Optional[State] = None,
               dt: float = 1e-3):
        b = self._body
        X_b = state.body_q[b]
        X_s = transform_multiply(X_b, self._X_site)
        p_site, q_site = X_s[:, 0:3], X_s[:, 3:7]
        qd = state.body_qd[b]
        v_com, w = qd[:, 0:3], qd[:, 3:6]
        x_com = X_b[:, 0:3] + quat_rotate(X_b[:, 3:7], self._com)
        if prev_state is not None:
            qd_prev = prev_state.body_qd[b]
            a_com = (v_com - qd_prev[:, 0:3]) / dt
            alpha = (w - qd_prev[:, 3:6]) / dt
        else:
            a_com = torch.zeros_like(v_com)
            alpha = torch.zeros_like(w)
        r = p_site - x_com
        a_site = a_com + cross(alpha, r) + cross(w, cross(w, r))
        a_proper = a_site - self._gravity
        return quat_rotate_inv(q_site, a_proper), quat_rotate_inv(q_site, w)
