"""Per-world cartpole control through a selection view (reference:
newton/examples/selection/example_selection_cartpole.py; port of
newton_tpu/examples/example_selection_cartpole.py): an ArticulationView
batch-reads pole angles across a cartpole farm and batch-writes per-world
cart forces.

The JAX example reads gymnasium's ``inverted_pendulum.xml`` from its
install; this package carries a byte-identical copy in ``ASSET_DIR``.
"""

import os

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of
from newton_tpu_torch.utils import ArticulationView

XML = os.path.join(nt.ASSET_DIR, "inverted_pendulum.xml")
N_WORLDS = 8


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        robot = nt.ModelBuilder()
        robot.add_mjcf(XML)
        builder = nt.ModelBuilder()
        builder.replicate(robot, N_WORLDS, spacing=(0.0, 1.0, 0.0))
        self.model = builder.finalize(device_of(args))
        self.view = ArticulationView(self.model, "*")
        self.solver = nt.SolverFeatherstone(self.model)
        state = self.model.state()
        q = self.view.get_dof_positions(state)
        tilt = 0.10 * np.where(np.arange(N_WORLDS) % 2 == 0, 1.0, -1.0)
        q = q.clone()
        q[:, 1] = torch.as_tensor(tilt, dtype=q.dtype, device=q.device)
        state = self.view.set_dof_positions(state, q)
        self.state = self.view.eval_fk(state)
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

    def step(self):
        # batched full-state feedback: push the cart under the pole
        q = self.view.get_dof_positions(self.state)
        qd = self.view.get_dof_velocities(self.state)
        f = (150.0 * q[:, 1] + 20.0 * qd[:, 1]   # pole angle feedback
             + 4.0 * q[:, 0] + 6.0 * qd[:, 0])   # cart recentering
        forces = torch.zeros_like(q)
        forces[:, 0] = f
        control = self.view.set_dof_forces(self.model.control(), forces)
        for _ in range(self.substeps):
            self.state = self.solver.step(self.state, None, control, None,
                                          self.sim_dt, kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        q = self.view.get_dof_positions(self.state).cpu().numpy()
        assert np.isfinite(q).all()
        # controller kept every pole near upright and carts bounded
        assert np.abs(q[:, 1]).max() < 0.15, q[:, 1]
        assert np.abs(q[:, 0]).max() < 0.9, q[:, 0]


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
