"""Scalar logging: a bouncing ball's height and energy plotted through the
viewer's log_scalar channel (reference:
newton/examples/basic/example_basic_plotting.py; port of
newton_tpu/examples/example_basic_plotting.py)."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder(gravity=-9.81)
        cfg = builder.default_shape_cfg.copy()
        cfg.restitution = 0.8
        self.ball = builder.add_body(xform=[0, 0, 1.2, 0, 0, 0, 1],
                                     key="ball")
        builder.add_shape_sphere(self.ball, radius=0.15, cfg=cfg)
        builder.add_joint_free(self.ball)
        builder.add_ground_plane(cfg=cfg)
        self.model = builder.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverXPBD(self.model, iterations=4)
        self.state = self.model.state()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.mass = float(self.model.body_mass[self.ball])
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
        z = float(self.state.body_q[self.ball, 2])
        v = self.state.body_qd[self.ball, 0:3].cpu().numpy()
        e = self.mass * (9.81 * z + 0.5 * float(v @ v))
        self.viewer.log_scalar("ball/height", z)
        self.viewer.log_scalar("ball/energy", e)
        self.viewer.end_frame()

    def test_final(self):
        hs = self.viewer.scalars.get("ball/height", [])
        es = self.viewer.scalars.get("ball/energy", [])
        assert len(hs) > 0 and len(es) > 0
        assert np.isfinite(hs).all() and np.isfinite(es).all()
        # energy is non-increasing (restitution < 1) within tolerance
        assert es[-1] <= es[0] * 1.05


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
