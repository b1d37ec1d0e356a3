"""Walker2d rollout (reference: newton/examples robot family, e.g.
example_robot_anymal_c_walk.py; port of newton_tpu/examples/
example_robot_walker2d.py): the gymnasium walker2d MJCF (planar
slide+hinge root, 6 actuated joints) stepped by SolverMuJoCo under a
joint-space PD stance hold with a sinusoidal gait overlay."""

import os

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

WALKER_XML = os.path.join(nt.ASSET_DIR, "walker2d.xml")


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder()
        self.info = b.add_mjcf(WALKER_XML)
        self.model = b.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverMuJoCo(self.model, iterations=8,
                                      integrator="euler")
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.kernels = True
        viewer.set_model(self.model)
        # joint-space PD stance hold + a small gait overlay on the hips: the
        # walker has no policy here, so the hold keeps it standing while the
        # overlay shifts its weight (leg dofs follow the 3 planar root dofs)
        dev = self.model.device
        nd = self.model.structure.joint_dof_count
        self.leg = torch.arange(3, nd, device=dev)
        self.overlay = torch.tensor([1.0, 0, 0, -1.0, 0, 0],
                                    device=dev)[:nd - 3]
        self.kp, self.kd = 60.0, 4.0

    def step(self):
        t = torch.full((), np.float32(self.time), device=self.leg.device)
        q_t = 0.12 * torch.sin(6.0 * t) * self.overlay
        for _ in range(self.substeps):
            s = self.state
            tau = self.kp * (q_t - s.joint_q[self.leg]) \
                - self.kd * s.joint_qd[self.leg]
            joint_f = self.control.joint_f.clone()
            joint_f[self.leg] = tau
            control = self.control.replace(joint_f=joint_f)
            self.state = self.solver.step(s, None, control,
                                          self.pipeline.collide(s),
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
        # torso stays above the ground plane (not fallen through / exploded)
        assert q[0, 2] > 0.9, q[0, 2]   # still standing, not fallen
        assert np.abs(qd).max() < 50.0, np.abs(qd).max()


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
