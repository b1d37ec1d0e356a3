"""Sleeping: boxes settle on the ground and are put to sleep by the
solver's quiescence counters; their state freezes exactly (reference:
examples/mujoco/example_mujoco_sleeping.py; mujoco SleepPolicy; port of
newton_tpu/examples/example_mujoco_sleeping.py).

The solver wakes an articulation only on ``joint_f`` (ROADMAP C.19, the
JAX package's rule, reproduced)."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder()
        for i in range(3):
            body = b.add_body(xform=[i * 1.0, 0, 0.205 + 0.02 * i,
                                     0, 0, 0, 1], key=f"box{i}")
            b.add_shape_box(body, hx=0.2, hy=0.2, hz=0.2)
            b.add_joint_free(body)
        b.add_ground_plane()
        self.model = b.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverFeatherstone(self.model, sleep_threshold=0.12,
                                            sleep_steps=8)
        state = nt.eval_fk(self.model, self.model.joint_q0,
                           self.model.joint_qd0, self.model.state())
        self.state = self.solver.init_state(state)
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

    def asleep_count(self):
        n = 0
        for k, v in self.state.custom.items():
            if k.startswith("sleep:count:"):
                n += int((v >= self.solver.sleep_steps).sum())
        return n

    def test_final(self):
        assert self.asleep_count() >= 1, "no articulation fell asleep"
        # frozen boxes sit at rest height with zero velocity
        qd = self.state.body_qd.cpu().numpy()
        assert np.abs(qd).max() < self.solver.sleep_threshold + 0.3
        z = self.state.body_q[:, 2].cpu().numpy()
        assert np.all(np.abs(z - 0.2) < 0.03), z
        assert np.isfinite(self.state.body_q.cpu().numpy()).all()


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
