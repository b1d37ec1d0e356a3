"""Two worlds with the same robot but different obstacles — the padded
per-env contact plan keeps both colliding (reference: ragged multi-world
batching; port of newton_tpu/examples/example_hetero_worlds.py). B2 runs
on the padded, non-uniform plan."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder()
        for w in range(2):
            b.begin_world()
            b.add_articulation()
            body = b.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1])
            b.add_shape_sphere(body, radius=0.3)
            b.add_joint_free(body)
            if w == 1:      # world 1 only: a static box pedestal
                b.add_shape_box(-1, xform=[0, 0, 0.2, 0, 0, 0, 1],
                                hx=0.5, hy=0.5, hz=0.2)
            b.end_world()
        b.add_ground_plane()
        self.model = b.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverFeatherstone(self.model,
                                            contact_iterations=8)
        plan = self.solver.contact_plans[0]
        assert plan is not None and not plan.uniform   # padded plan active
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            c = self.pipeline.collide(self.state)
            self.state = self.solver.step(self.state, None, self.control, c,
                                          self.sim_dt, kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        z = self.state.body_q.cpu().numpy()[:, 2]
        assert abs(z[0] - 0.3) < 0.05, z    # world 0: ground
        assert abs(z[1] - 0.7) < 0.05, z    # world 1: box top + radius


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
