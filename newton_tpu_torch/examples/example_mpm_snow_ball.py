"""Snow ball drop: Stomakhin snow plasticity (singular-value clamp +
compression hardening) compacts on impact instead of flowing like sand
(reference: newton/examples/mpm/example_mpm_snow_ball.py; port of
newton_tpu/examples/example_mpm_snow_ball.py)."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder()
        rng = np.random.RandomState(1)
        p = rng.randn(1200, 3)
        p /= np.maximum(np.linalg.norm(p, axis=1, keepdims=True), 1e-9)
        p = p * 0.18 * rng.rand(1200, 1) ** (1 / 3) + np.array([0, 0, 0.6])
        for pt in p:
            builder.add_particle(pt, (0, 0, -2.0), mass=0.01)
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverImplicitMPM(
            self.model, grid_lower=(-1, -1, 0), grid_upper=(1, 1, 2),
            resolution=48, material="snow", young=2.0e5,
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
        # snow compacted on the floor but kept a mound (did not sheet out)
        assert pq[:, 2].min() > -0.05
        assert np.abs(pq[:, :2]).max() < 0.6
        # plastic compression happened somewhere
        jp = self.state.custom["mpm:Jp"].cpu().numpy()
        assert np.isfinite(jp).all() and jp.min() < 0.999


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
