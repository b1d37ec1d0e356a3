"""Balance bird: a rigid body whose center of mass hangs below its beak
support point self-rights on a pedestal tip (reference:
newton/examples/contacts/example_balance_bird.py; port of
newton_tpu/examples/example_balance_bird.py)."""

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.core.host_math import np_transform
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder(gravity=-9.81)
        # pedestal: static thin capsule, tip at z = 1.0
        b.add_shape_capsule(-1, radius=0.02, half_height=0.25,
                            xform=[0, 0, 0.73, 0, 0, 0, 1], key="pedestal")
        # the bird: beak ball resting on the tip, heavy wingtip spheres
        # hanging BELOW the support point -> stable equilibrium
        self.bird = b.add_body(xform=[0, 0, 1.04, 0, 0, 0, 1], key="bird")
        cfg = b.default_shape_cfg.copy()
        cfg.mu = 0.8
        b.add_shape_sphere(self.bird, radius=0.04, cfg=cfg, key="beak")
        wing = b.default_shape_cfg.copy()
        wing.mu = 0.8
        wing.density = 8000.0
        for sx in (-1.0, 1.0):
            b.add_shape_sphere(
                self.bird, radius=0.05, cfg=wing,
                xform=np_transform(np.array([sx * 0.3, 0.0, -0.18])),
                key=f"wing_{int(sx > 0)}")
        b.add_joint_free(self.bird)
        b.add_ground_plane()
        self.model = b.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverXPBD(self.model, iterations=8)
        state = self.model.state()
        # perturb: small tilt + spin; the bird should wobble and recover
        qd = np.zeros((1, 6), np.float32)
        qd[0, 3:6] = [0.6, 0.3, 0.0]
        self.state = state.replace(body_qd=torch.as_tensor(
            qd, device=self.model.device))
        self.sim_dt = 1.0 / 480.0
        self.substeps = 8
        self.time = 0.0
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            self.state = self.solver.step(self.state, None, None,
                                          self.pipeline.collide(self.state),
                                          self.sim_dt)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        q = self.state.body_q.cpu().numpy()
        assert np.isfinite(q).all()
        # still balanced near the pedestal tip, roughly upright
        assert abs(q[self.bird, 0]) < 0.15 and abs(q[self.bird, 1]) < 0.15
        assert q[self.bird, 2] > 0.9, q[self.bird, 2]
        x, y = q[self.bird, 3], q[self.bird, 4]
        assert 1.0 - 2.0 * (x * x + y * y) > 0.7  # up-axis mostly up


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
