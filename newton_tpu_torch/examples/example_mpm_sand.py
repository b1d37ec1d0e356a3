"""Sand column collapse under MLS-MPM (reference: newton/examples/mpm_*;
port of newton_tpu/examples/example_mpm_sand.py)."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder()
        builder.add_particle_grid(pos=(-0.15, -0.15, 0.4), dim_x=8, dim_y=8,
                                  dim_z=10, cell_x=0.04, cell_y=0.04,
                                  cell_z=0.04, mass=0.02, radius=0.015)
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverImplicitMPM(
            self.model, grid_lower=(-1, -1, 0), grid_upper=(1, 1, 2),
            resolution=48, friction_angle=0.6)
        self.state = self.solver.init_state(self.model.state())
        self.sim_dt = 4e-4
        self.substeps = 25
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
        assert pq[:, 2].min() > -0.1


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
