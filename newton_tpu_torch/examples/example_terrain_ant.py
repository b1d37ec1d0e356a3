"""Ant dropped onto procedural fractal terrain (direct heightfield SDF
collision; reference: examples terrain/rough-terrain locomotion family;
port of newton_tpu/examples/example_terrain_ant.py), stepped by
SolverFeatherstone."""

import os

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of
from newton_tpu_torch.geometry.terrain import generate_fractal_terrain

ANT_XML = os.path.join(nt.ASSET_DIR, "ant.xml")


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder()
        builder.add_mjcf(ANT_XML)
        hf = generate_fractal_terrain(nx=32, ny=32, size_x=12.0,
                                      size_y=12.0, amplitude=0.25, seed=3)
        builder.add_shape_heightfield(-1, heightfield=hf)
        self.model = builder.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverFeatherstone(self.model,
                                            contact_iterations=8)
        q0 = self.model.joint_q0.clone()
        q0[2] += 0.6          # drop from above the bumps
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
            self.state = self.solver.step(
                self.state, None, self.control,
                self.pipeline.collide(self.state), self.sim_dt,
                kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        q = self.state.joint_q.cpu().numpy()
        assert np.isfinite(self.state.body_q.cpu().numpy()).all()
        # torso settled on (not through) the terrain
        assert -0.3 < q[2] < 1.5, f"ant torso z {q[2]}"


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
