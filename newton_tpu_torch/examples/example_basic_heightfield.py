"""Spheres rolling down a procedural heightfield valley (reference:
newton/examples/basic/example_basic_heightfield.py; port of
newton_tpu/examples/example_basic_heightfield.py). A heightfield pair
takes the default contact slots (ROADMAP C.28, the JAX package's count,
reproduced)."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder(gravity=-9.81)

        # valley: parabolic cross-section in y, gentle slope in x
        n = 24
        xs = np.linspace(-1, 1, n)
        ys = np.linspace(-1, 1, n)
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        hts = (0.6 * Y ** 2 - 0.15 * X).astype(np.float64)
        hf = nt.Heightfield(hts, size_x=6.0, size_y=6.0)
        builder.add_shape_heightfield(body=-1, heightfield=hf,
                                      key="terrain")

        self.balls = []
        for i in range(3):
            bb = builder.add_body(
                xform=[-2.0, -1.5 + 1.5 * i, 1.6, 0, 0, 0, 1],
                key=f"ball_{i}")
            builder.add_shape_sphere(bb, radius=0.25, key=f"ball_shape_{i}")
            builder.add_joint_free(bb, key=f"ball_free_{i}")
            self.balls.append(bb)
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
        assert np.isfinite(q).all()
        for bb in self.balls:
            # still above the terrain floor, inside the field bounds
            assert -1.0 < q[bb, 2] < 2.0, q[bb]
            assert abs(q[bb, 0]) < 3.2 and abs(q[bb, 1]) < 3.2


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
