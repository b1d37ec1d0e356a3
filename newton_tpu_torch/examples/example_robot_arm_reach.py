"""6-dof arm joint-space reach (reference:
newton/examples/robot/example_robot_ur10.py; port of newton_tpu/examples/
example_robot_arm_reach.py). A UR-like 6-revolute chain is driven by the
generalized solver's implicit joint PD to a target configuration; the
implicit gains stay stable at stiffness where explicit PD would blow up."""

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

TARGET = np.array([0.6, -0.9, 1.2, -0.4, 0.8, 0.3])


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder(gravity=-9.81)
        # alternating-axis serial chain, shoulder to wrist
        lengths = [0.18, 0.45, 0.40, 0.12, 0.10, 0.08]
        axes = ["Z", "Y", "Y", "Y", "Z", "Y"]
        parent = -1
        z = 0.0
        for i, (L, ax) in enumerate(zip(lengths, axes)):
            link = b.add_body(xform=[0, 0, z + L / 2, 0, 0, 0, 1],
                              key=f"link_{i}")
            b.add_shape_capsule(link, radius=0.05 - 0.004 * i,
                                half_height=L / 2, key=f"geom_{i}")
            b.add_joint_revolute(
                parent, link, axis=ax,
                xform_p=([0, 0, z, 0, 0, 0, 1] if parent == -1
                         else [0, 0, lengths[i - 1] / 2, 0, 0, 0, 1]),
                xform_c=[0, 0, -L / 2, 0, 0, 0, 1],
                target_ke=400.0, target_kd=40.0, key=f"joint_{i}")
            parent = link
            z += L
        self.model = b.finalize(device_of(args))
        self.solver = nt.SolverMuJoCo(self.model, integrator="implicitfast")
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.control = self.model.control().replace(
            joint_target_q=torch.as_tensor(TARGET, dtype=torch.float32,
                                           device=self.model.device))
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.kernels = True
        viewer.set_model(self.model)

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
        q = self.state.joint_q.cpu().numpy()
        qd = self.state.joint_qd.cpu().numpy()
        assert np.isfinite(q).all()
        err = np.abs(q - TARGET).max()
        assert err < 0.08, f"joint error {err:.4f}: {q} vs {TARGET}"
        assert np.abs(qd).max() < 0.5, qd


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
