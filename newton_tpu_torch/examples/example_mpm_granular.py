"""Granular pile angle of repose (reference:
newton/examples/mpm/example_mpm_granular.py; port of newton_tpu/examples/
example_mpm_granular.py): a tall thin sand column collapses and spreads
into a pile whose slope is set by the friction angle, the canonical
granular-media validation for MLS-MPM."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder()
        # tall 1:4 aspect column: collapses hard
        builder.add_particle_grid(pos=(-0.08, -0.08, 0.02), dim_x=5,
                                  dim_y=5, dim_z=20, cell_x=0.032,
                                  cell_y=0.032, cell_z=0.032, mass=0.02,
                                  radius=0.013)
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverImplicitMPM(
            self.model, grid_lower=(-1, -1, 0), grid_upper=(1, 1, 2),
            resolution=48, friction_angle=0.7)
        self.state = self.solver.init_state(self.model.state())
        self.h0 = float(self.state.particle_q[:, 2].max())
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
        assert pq[:, 2].min() > -0.05, "sand fell through the grid floor"
        # the column collapsed (height dropped) and spread (radius grew)
        h = pq[:, 2].max()
        r = np.sqrt(pq[:, 0] ** 2 + pq[:, 1] ** 2).max()
        assert h < 0.85 * self.h0, (h, self.h0)
        assert r > 0.14, r
        # friction keeps it a pile, not a puddle: finite repose height
        assert h > 0.05, h


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
