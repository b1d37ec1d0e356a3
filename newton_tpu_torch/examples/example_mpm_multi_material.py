"""Three MPM columns (sand, snow, viscous honey) collapse side by side in
one solve with per-particle materials (reference:
newton/examples/mpm/example_mpm_multi_material.py; port of
newton_tpu/examples/example_mpm_multi_material.py)."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder()
        self.ranges = []
        mat_ids = []
        for mat, x0 in ((0, -0.55), (1, -0.12), (2, 0.31)):
            start = builder.particle_count
            builder.add_particle_grid(pos=(x0, -0.12, 0.05), dim_x=6,
                                      dim_y=6, dim_z=10, cell_x=0.035,
                                      cell_y=0.035, cell_z=0.035,
                                      mass=0.02, radius=0.014)
            n = builder.particle_count - start
            mat_ids += [mat] * n
            self.ranges.append((start, builder.particle_count))
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverImplicitMPM(
            self.model, grid_lower=(-1, -1, 0), grid_upper=(1, 1, 1.5),
            resolution=48, material_id=np.asarray(mat_ids),
            friction_angle=0.6, viscous_relax=0.25,
            implicit_iterations=8)
        self.state = self.solver.init_state(self.model.state())
        self.sim_dt = 1.5e-3
        self.substeps = 10
        self.time = 0.0
        # False steps through the transfers' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            self.state = self.solver.step(self.state, None, None, None,
                                          self.sim_dt, kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        pq = self.state.particle_q.cpu().numpy()
        assert np.isfinite(pq).all()
        assert pq[:, 2].min() > -0.05
        heights = []
        for s, e in self.ranges:
            heights.append(float(pq[s:e, 2].max()))
        # snow column holds the most height, sand collapses flattest
        assert heights[1] > heights[0] - 0.02, heights


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
