"""Conveyor belt: a kinematic belt slab moving at constant speed drags
cargo boxes along through contact friction (reference:
newton/examples/basic/example_basic_conveyor.py — the reference builds a
ring belt with prescribed joint motion; same physics, linear belt here;
port of newton_tpu/examples/example_basic_conveyor.py)."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

BELT_SPEED = 0.75  # m/s


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder(gravity=-9.81)
        cfg = builder.default_shape_cfg.copy()
        cfg.mu = 0.9

        # kinematic belt slab translating +x at BELT_SPEED
        belt = builder.add_body(
            xform=[0.0, 0.0, 0.05, 0, 0, 0, 1],
            qd=np.array([BELT_SPEED, 0, 0, 0, 0, 0]),
            kinematic=True, key="belt")
        builder.add_shape_box(belt, hx=2.0, hy=0.5, hz=0.05, cfg=cfg,
                              key="belt_top")

        # cargo boxes resting on the belt
        self.boxes = []
        for i in range(3):
            bb = builder.add_body(
                xform=[-1.2 + 0.5 * i, 0.0, 0.2, 0, 0, 0, 1],
                key=f"bag_{i}")
            builder.add_shape_box(bb, hx=0.1, hy=0.1, hz=0.1, cfg=cfg,
                                  key=f"bag_shape_{i}")
            builder.add_joint_free(bb, key=f"bag_free_{i}")
            self.boxes.append(bb)
        builder.add_ground_plane()
        self.model = builder.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverXPBD(self.model, iterations=4)
        self.state = self.model.state()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
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
        qd = self.state.body_qd.cpu().numpy()
        assert np.isfinite(q).all()
        # friction dragged every box with the belt
        for bb in self.boxes:
            assert qd[bb, 0] > 0.2 * BELT_SPEED, qd[bb]
        assert all(q[bb, 2] > 0.1 for bb in self.boxes)  # still on the belt


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
