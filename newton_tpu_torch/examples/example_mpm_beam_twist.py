"""Elastic MPM beam under an impulsive twist (reference:
newton/examples/mpm/example_mpm_beam_twist.py; port of newton_tpu/
examples/example_mpm_beam_twist.py): a jelly beam gets a twist velocity
field that ramps along its axis; the elastic stress (no plastic yield:
friction_angle=None) winds the cross-sections, pulls them back and
rings, while the beam holds together. Gates shape integrity under large
rotational deformation in the MLS-MPM transfer."""

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

OMEGA = 12.0        # peak twist rate (rad/s) at the free end


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder(gravity=0.0)
        builder.add_particle_grid(pos=(-0.3, -0.06, 0.94), dim_x=24,
                                  dim_y=5, dim_z=5, cell_x=0.025,
                                  cell_y=0.025, cell_z=0.025, mass=0.01,
                                  radius=0.011)
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverImplicitMPM(
            self.model, grid_lower=(-1, -1, 0), grid_upper=(1, 1, 2),
            resolution=48, young=2.0e4, poisson=0.3, friction_angle=None)
        state = self.solver.init_state(self.model.state())
        # twist velocity field: omega(x) ramps 0 -> OMEGA along the beam,
        # v = omega x r about the beam's x-axis through its centroid
        pq = state.particle_q.cpu().numpy()
        ctr = pq.mean(axis=0)
        xn = (pq[:, 0] - pq[:, 0].min()) / (np.ptp(pq[:, 0]) + 1e-9)
        w = OMEGA * xn
        vy = -w * (pq[:, 2] - ctr[2])
        vz = w * (pq[:, 1] - ctr[1])
        qd0 = np.stack([np.zeros_like(vy), vy, vz], axis=-1)
        self.state = state.replace(particle_qd=torch.as_tensor(
            qd0, dtype=state.particle_qd.dtype,
            device=state.particle_qd.device))
        self.r0 = float(np.abs(pq[:, 1:3] - ctr[1:3]).max())
        self.sim_dt = 4e-4
        self.substeps = 20
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
        qd = self.state.particle_qd.cpu().numpy()
        assert np.isfinite(pq).all() and np.isfinite(qd).all()
        # the beam wound up but held together: cross-section radius bounded
        ctr = pq.mean(axis=0)
        r = np.abs(pq[:, 1:3] - ctr[1:3]).max()
        assert r < 2.5 * self.r0, (r, self.r0)
        # no particle escaped the grid or exploded
        assert np.abs(qd).max() < 20.0, np.abs(qd).max()
        assert pq[:, 2].min() > 0.0 and pq[:, 2].max() < 2.0


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
