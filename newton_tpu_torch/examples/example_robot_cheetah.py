"""Half-cheetah rollout (reference: newton/examples robot family; port of
newton_tpu/examples/example_robot_cheetah.py): the gymnasium half_cheetah
MJCF (planar root, 6 actuated leg joints with per-joint gear ratios)
stepped by SolverMuJoCo under an open-loop bounding ctrl schedule."""

import math
import os

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

CHEETAH_XML = os.path.join(nt.ASSET_DIR, "half_cheetah.xml")


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder()
        self.info = b.add_mjcf(CHEETAH_XML)
        self.model = b.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverMuJoCo(self.model, iterations=8)
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.kernels = True
        viewer.set_model(self.model)
        n_act = self.model.structure.mjc_actuation.n
        # back legs lead the front by half a cycle: a bounding gait
        self.phase = torch.tensor(
            [0.0, 0.8, 1.6, math.pi, math.pi + 0.8, math.pi + 1.6][:n_act],
            dtype=torch.float32, device=self.model.device)

    def step(self):
        t = torch.full((), np.float32(self.time), device=self.phase.device)
        ctrl = 0.3 * torch.sin(10.0 * t + self.phase)
        control = self.control.replace(
            custom={**self.control.custom, "mjc:ctrl": ctrl})
        for _ in range(self.substeps):
            self.state = self.solver.step(
                self.state, None, control, self.pipeline.collide(self.state),
                self.sim_dt, kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        q = self.state.body_q.cpu().numpy()
        qd = self.state.body_qd.cpu().numpy()
        assert np.isfinite(q).all() and np.isfinite(qd).all()
        # torso stays near its running height, never tunnels or launches
        assert 0.1 < q[0, 2] < 2.0, q[0, 2]
        assert np.abs(qd).max() < 50.0, np.abs(qd).max()


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
