"""Common solver interface, rigid-body and particle integration (port of
``SolverBase``, ``integrate_bodies`` and ``integrate_particles`` in
``newton_tpu/solvers/solver.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..math import (
    cross,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inv,
)
from ..sim.contacts import Contacts
from ..sim.control import Control
from ..sim.model import Model
from ..sim.state import State

__all__ = ["SolverBase", "integrate_bodies", "integrate_particles",
           "body_gravity", "particle_gravity"]


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


def _world_gravity(model: Model, worlds) -> torch.Tensor:
    w = np.maximum(np.asarray(worlds, dtype=np.int64), 0)
    return model.gravity[torch.as_tensor(w, device=model.device)]


def body_gravity(model: Model) -> torch.Tensor:
    """Each body's world gravity (B, 3) (a global body takes world 0's)."""
    return _world_gravity(model, model.structure.body_world)


def particle_gravity(model: Model) -> torch.Tensor:
    """Each particle's world gravity (N, 3) (a global particle takes world
    0's). Solvers compute it once: it is a host-to-device copy."""
    return _world_gravity(model, model.structure.particle_world)


def integrate_particles(model: Model, state: State, dt: float,
                        gravity: Optional[torch.Tensor] = None):
    """Semi-implicit Euler for the particles (the JAX package's
    ``integrate_particles``): the velocity takes gravity and
    ``particle_f / m``, is clamped to ``particle_max_velocity`` in norm,
    then moves the position; pinned particles (inverse mass 0) keep both.
    ``gravity`` (N, 3) is ``particle_gravity(model)``, computed here when
    not given. Returns (particle_q, particle_qd)."""
    if model.particle_count == 0:
        return state.particle_q, state.particle_qd
    g = particle_gravity(model) if gravity is None else gravity
    inv_m = model.particle_inv_mass[:, None]
    active = inv_m > 0.0
    v_new = state.particle_qd + (g * active + state.particle_f * inv_m) * dt
    vmax = model.particle_max_velocity
    vn = torch.linalg.vector_norm(v_new, dim=-1, keepdim=True)
    v_new = torch.where(vn > vmax,
                        v_new * (vmax / torch.clamp(vn, min=1e-9)), v_new)
    x_new = state.particle_q + v_new * dt
    return (torch.where(active, x_new, state.particle_q),
            torch.where(active, v_new, state.particle_qd))


def integrate_bodies(model: Model, state: State, dt: float,
                     angular_damping: float = 0.05,
                     gravity: Optional[torch.Tensor] = None):
    """Semi-implicit Euler for the rigid bodies of a flat State (the JAX
    package's ``integrate_bodies``): the COM velocity takes gravity and the
    wrench's force, the angular velocity the torque and the gyroscopic term
    in the body frame, then the damping ``1 / (1 + dt angular_damping)``;
    bodies without mass keep their velocities. ``body_f`` is a world wrench
    [f, tau] at the COM. ``gravity`` (B, 3) is ``body_gravity(model)``,
    computed here when not given. Returns (body_q, body_qd)."""
    if model.body_count == 0:
        return state.body_q, state.body_qd
    g = body_gravity(model) if gravity is None else gravity
    q = state.body_q[:, 3:7]
    x_com = state.body_q[:, 0:3] + quat_rotate(q, model.body_com)
    v = state.body_qd[:, 0:3]
    w = state.body_qd[:, 3:6]
    f = state.body_f[:, 0:3]
    t = state.body_f[:, 3:6]

    inv_m = model.body_inv_mass[:, None]
    dynamic = inv_m > 0.0
    v_new = v + (g * dynamic + f * inv_m) * dt
    wb = quat_rotate_inv(q, w)
    tb = quat_rotate_inv(q, t)
    gyr = -cross(wb, (model.body_inertia * wb[:, None, :]).sum(-1))
    wb_new = wb + dt * (model.body_inv_inertia
                        * (tb + gyr)[:, None, :]).sum(-1)
    w_new = quat_rotate(q, wb_new) * (1.0 / (1.0 + dt * angular_damping))
    v_new = torch.where(dynamic, v_new, v)
    w_new = torch.where(dynamic, w_new, w)

    x_com_new = x_com + v_new * dt
    dq = quat_mul(torch.cat([w_new, torch.zeros_like(w_new[:, :1])], -1), q)
    q_new = quat_normalize(q + 0.5 * dt * dq)
    x_new = x_com_new - quat_rotate(q_new, model.body_com)
    return torch.cat([x_new, q_new], -1), torch.cat([v_new, w_new], -1)
