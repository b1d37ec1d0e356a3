"""Sphere dropping onto the ground plane under XPBD (reference:
newton/examples/basic/ example family; port of
newton_tpu/examples/example_basic_sphere.py)."""

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder()
        body = builder.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1], key="ball")
        builder.add_shape_sphere(body, radius=0.5)
        builder.add_joint_free(body)
        builder.add_ground_plane()
        self.model = builder.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverXPBD(self.model, iterations=2)
        self.state = self.model.state()
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            c = self.pipeline.collide(self.state)
            self.state = self.solver.step(self.state, None, self.control, c,
                                          self.sim_dt)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        z = float(self.state.body_q[0, 2])
        assert abs(z - 0.5) < 0.05, f"sphere rest height {z}"


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
