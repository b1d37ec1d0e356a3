"""Muscle-tendon actuation: a muscle spanning two free bodies contracts
under a sinusoidal activation signal (reference: examples muscle usage of
builder.py:6303 add_muscle + semi-implicit eval_muscles; port of
newton_tpu/examples/example_muscle.py). Each substep starts from
``State.clear_forces()``."""

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder(gravity=0.0)
        b1 = builder.add_body(xform=[0, 0, 1, 0, 0, 0, 1], key="left")
        builder.add_shape_box(b1, hx=0.1, hy=0.1, hz=0.1)
        builder.add_joint_free(b1)
        b2 = builder.add_body(xform=[1, 0, 1, 0, 0, 0, 1], key="right")
        builder.add_shape_box(b2, hx=0.1, hy=0.1, hz=0.1)
        builder.add_joint_free(b2)
        builder.add_muscle([b1, b2], [(0.1, 0, 0), (-0.1, 0, 0)],
                           f0=50.0, lm=0.5, lt=0.1, lmax=1.0, pen=0.1)
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverSemiImplicit(self.model)
        self.state = self.model.state()
        self.control = self.model.control()
        self.sim_dt = 1.0 / 1000.0
        self.substeps = 10
        self.time = 0.0
        viewer.set_model(self.model)

    def step(self):
        act = 0.5 + 0.5 * np.sin(2.0 * np.pi * 0.5 * self.time)
        control = self.control.replace(muscle_activations=torch.full(
            (1,), act, dtype=torch.float32, device=self.model.device))
        for _ in range(self.substeps):
            s = self.state.clear_forces()
            self.state = self.solver.step(s, None, control, None,
                                          self.sim_dt)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        q = self.state.body_q.cpu().numpy()
        assert np.isfinite(q).all()
        gap = float(np.linalg.norm(q[1, :3] - q[0, :3]))
        assert gap < 1.0, f"muscle never contracted: gap {gap}"


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
