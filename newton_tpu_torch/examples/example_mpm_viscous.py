"""Viscous honey column: deviatoric plastic relaxation makes the material
creep outward slowly instead of collapsing like sand (reference:
newton/examples/mpm/example_mpm_viscous.py; port of newton_tpu/examples/
example_mpm_viscous.py)."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder()
        builder.add_particle_grid(pos=(-0.12, -0.12, 0.05), dim_x=8, dim_y=8,
                                  dim_z=12, cell_x=0.03, cell_y=0.03,
                                  cell_z=0.03, mass=0.02, radius=0.012)
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverImplicitMPM(
            self.model, grid_lower=(-1, -1, 0), grid_upper=(1, 1, 2),
            resolution=48, material="viscous", viscous_relax=0.25,
            young=5.0e4, implicit_iterations=8)
        self.state = self.solver.init_state(self.model.state())
        self.sim_dt = 1.5e-3
        self.substeps = 10
        self.time = 0.0
        # False steps through the transfers' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)
        self.r0 = float(self.model.particle_q[:, :2].abs().max())

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
        # the column slumped and spread beyond its initial footprint
        assert np.abs(pq[:, :2]).max() > self.r0 + 0.02


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
