"""Dzhanibekov effect (intermediate-axis theorem): a free rigid body spun
about its middle principal axis periodically flips, while angular momentum
stays conserved (reference: examples/basic/example_basic_dzhanibekov.py;
port of newton_tpu/examples/example_basic_dzhanibekov.py).

The gyroscopic bias forces of the generalized solver drive the instability;
no gravity, no contacts — pure free-body dynamics (B1 at d = 6).
"""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder(gravity=0.0)
        # T-handle: principal inertias I_x < I_y < I_z; spin about y
        body = builder.add_body(
            xform=[0, 0, 1.0, 0, 0, 0, 1], mass=1.0,
            I_m=np.diag([0.02, 0.10, 0.12]), key="handle",
            qd=[0, 0, 0, 0.05, 12.0, 0.0])
        builder.add_shape_box(body, hx=0.3, hy=0.05, hz=0.05,
                              cfg=nt.ShapeConfig(density=0.0))
        builder.add_joint_free(body)
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverFeatherstone(self.model)
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 480.0
        self.substeps = 8
        self.time = 0.0
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)
        self.L0 = self._angular_momentum()

    def _angular_momentum(self):
        q = self.state.body_q[0, 3:7].cpu().numpy()
        w = self.state.body_qd[0, 3:6].cpu().numpy()
        R = _quat_to_mat(q)
        I_w = R @ np.diag([0.02, 0.10, 0.12]) @ R.T
        return I_w @ w

    def step(self):
        for _ in range(self.substeps):
            self.state = self.solver.step(self.state, None, self.control,
                                          None, self.sim_dt,
                                          kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        L = self._angular_momentum()
        # world-frame angular momentum conserved through the instability
        drift = np.linalg.norm(L - self.L0) / np.linalg.norm(self.L0)
        assert drift < 0.05, f"angular momentum drift {drift:.3f}"
        # the spin axis precesses: body angular velocity has left pure-y
        w = self.state.body_qd[0, 3:6].cpu().numpy()
        assert abs(w[0]) + abs(w[2]) > 0.05, f"no precession: {w}"
        assert np.isfinite(self.state.body_q.cpu().numpy()).all()


def _quat_to_mat(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
