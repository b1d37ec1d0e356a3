"""Cartpole balance: gymnasium's inverted-pendulum MJCF stabilized by a
hand-tuned state-feedback controller on the cart force (reference:
examples/robot/example_robot_cartpole.py; port of newton_tpu/examples/
example_robot_cartpole.py).
"""

import os

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

ASSET = os.path.join(nt.ASSET_DIR, "inverted_pendulum.xml")


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder()
        b.add_mjcf(ASSET)
        self.model = b.finalize(device_of(args))
        self.solver = nt.SolverMuJoCo(self.model, iterations=4,
                                      integrator="euler")
        # start slightly off-vertical so the controller has work to do
        q0 = self.model.joint_q0.clone()
        q0[1] = 0.12
        self.state = nt.eval_fk(self.model, q0, self.model.joint_qd0,
                                self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.kernels = True
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            s = self.state
            # state feedback: cart pos/vel + pole angle/rate -> force
            x, th = s.joint_q[0], s.joint_q[1]
            xd, thd = s.joint_qd[0], s.joint_qd[1]
            f = 30.0 * x + 40.0 * xd + 500.0 * th + 80.0 * thd
            joint_f = self.control.joint_f.clone()
            joint_f[0] = f
            c = self.control.replace(joint_f=joint_f)
            self.state = self.solver.step(s, None, c, None, self.sim_dt,
                                          kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        th = float(self.state.joint_q[1])
        x = float(self.state.joint_q[0])
        assert abs(th) < 0.12, f"pole fell: theta={th:.3f}"
        assert abs(x) < 0.9, f"cart ran away: x={x:.3f}"
        assert np.isfinite(self.state.joint_q.cpu().numpy()).all()


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
