"""The MPM material family of tests/test_mpm.py on the port (split from
test_torch_mpm_physics.py, whose helpers it uses), at the JAX test's
sizes and bounds."""

import os
import sys

import numpy as np
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_mpm_physics import (  # noqa: E402
    _run,
)

torch.set_num_threads(1)


def test_mpm_material_family():
    """Snow compacts and holds its shape, sand spreads into a shallow pile,
    viscous creeps in between (200 steps of 2 ms at res 32, CG 8)."""
    def drop(material):
        rng = np.random.RandomState(0)
        p = rng.randn(600, 3)
        p /= np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1)
        p = p * 0.15 * rng.rand(600, 1) ** (1 / 3) + np.array([0, 0, 0.5])
        b = nt.ModelBuilder(gravity=-9.81)
        b.add_particles(p, vel=np.tile([0.0, 0.0, -1.0], (600, 1)),
                        mass=np.full(600, 0.01))
        m = b.finalize("cpu")
        sol = nt.SolverImplicitMPM(m, grid_lower=(-1, -1, 0),
                                   grid_upper=(1, 1, 1.5), resolution=32,
                                   material=material, implicit_iterations=8)
        s = _run(sol, sol.init_state(m.state()), 200, 2e-3)
        q = s.particle_q.numpy()
        assert np.isfinite(q).all(), material
        return float(q[:, 2].max()), float(np.abs(q[:, :2]).max())

    h_sand, r_sand = drop("sand")
    h_snow, r_snow = drop("snow")
    h_visc, r_visc = drop("viscous")
    assert h_snow > h_visc > h_sand - 0.02, (h_sand, h_visc, h_snow)
    assert r_snow < r_visc < r_sand + 0.02, (r_sand, r_visc, r_snow)
