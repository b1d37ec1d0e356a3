"""Batched selection over a replicated robot farm: an ArticulationView
reads and writes dof state across 8 cartpole worlds at once, with the
pole tilts alternating across worlds (reference:
newton/examples/selection/example_selection_articulations.py; port of
newton_tpu/examples/example_selection_articulations.py)."""

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
        # alternate initial pole tilts across worlds through the view
        q = self.view.get_dof_positions(state).clone()
        tilt = 0.12 * np.where(np.arange(N_WORLDS) % 2 == 0, 1.0, -1.0)
        q[:, 1] = torch.as_tensor(tilt, dtype=q.dtype, device=q.device)
        state = self.view.set_dof_positions(state, q)
        self.state = self.view.eval_fk(state)
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            self.state = self.solver.step(self.state, None, self.control,
                                          None, self.sim_dt,
                                          kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        qn = self.view.get_dof_positions(self.state).cpu().numpy()
        assert qn.shape == (N_WORLDS, 2)
        assert np.isfinite(qn).all()
        # poles fall in the direction of their initial tilt
        signs = np.where(np.arange(N_WORLDS) % 2 == 0, 1.0, -1.0)
        assert (qn[:, 1] * signs > 0.05).all(), qn[:, 1]


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
