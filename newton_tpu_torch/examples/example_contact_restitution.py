"""Restitution sweep: three balls with e = 0.1 / 0.5 / 0.9 dropped from the
same height — rebound heights must be ordered by restitution (reference:
contact restitution handling, xpbd velocity pass; port of
newton_tpu/examples/example_contact_restitution.py).
"""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    RESTITUTIONS = (0.1, 0.5, 0.9)

    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder()
        for i, e in enumerate(self.RESTITUTIONS):
            body = b.add_body(xform=[i * 1.0, 0, 1.0, 0, 0, 0, 1],
                              key=f"ball_{e}")
            b.add_shape_sphere(body, radius=0.2,
                               cfg=nt.ShapeConfig(restitution=e))
            b.add_joint_free(body)
        b.add_ground_plane()
        self.model = b.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverXPBD(self.model, iterations=2,
                                    enable_restitution=True)
        self.state = self.model.state()
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.max_height = np.zeros(3)
        self.bounced = np.zeros(3, dtype=bool)
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            c = self.pipeline.collide(self.state)
            self.state = self.solver.step(self.state, None, self.control, c,
                                          self.sim_dt)
        self.time += self.sim_dt * self.substeps
        z = self.state.body_q[:, 2].cpu().numpy()
        vz = self.state.body_qd[:, 2].cpu().numpy()
        # track rebound apex after first impact (upward motion above floor)
        going_up = vz > 0.05
        self.bounced |= going_up
        self.max_height = np.where(self.bounced & (z > self.max_height),
                                   z, self.max_height)

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        h = self.max_height
        assert self.bounced.all(), f"not all balls rebounded: {self.bounced}"
        assert h[0] < h[1] < h[2], f"rebound heights not ordered: {h}"
        assert np.isfinite(self.state.body_q.cpu().numpy()).all()


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
