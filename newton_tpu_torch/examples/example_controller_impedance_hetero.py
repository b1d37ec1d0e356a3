"""Heterogeneous joint-impedance gains across replicated worlds (reference:
newton/examples/controller/example_controller_joint_impedance_heterogeneous
.py; port of newton_tpu/examples/example_controller_impedance_hetero.py):
four copies of a gravity-loaded two-link arm track the same target pose
with per-world stiffness. The model-based impedance law shapes each
closed loop so the stiff worlds snap to the target while the soft ones
sag under gravity by exactly their compliance."""

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.controllers import JointImpedanceModelBased
from newton_tpu_torch.examples import device_of

WORLDS = 4
KP = [4.0, 16.0, 64.0, 256.0]      # per-world impedance stiffness
TARGET = [0.6, -0.4]               # shoulder / elbow target angles


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        arm = nt.ModelBuilder(gravity=-9.81)
        parent = -1
        for i in range(2):
            link = arm.add_body(xform=[0.25 + 0.5 * i, 0, 1.0,
                                       0, 0, 0, 1], key=f"link{i}")
            arm.add_shape_capsule(link, radius=0.04, half_height=0.2)
            arm.add_joint_revolute(
                parent, link, axis="Y",
                xform_p=([0, 0, 1.0, 0, 0, 0, 1] if i == 0
                         else [0.25, 0, 0, 0, 0, 0, 1]),
                xform_c=[-0.25, 0, 0, 0, 0, 0, 1], key=f"j{i}")
            parent = link
        builder = nt.ModelBuilder(gravity=-9.81)
        builder.replicate(arm, WORLDS, spacing=(0.0, 1.5, 0.0))
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverMuJoCo(self.model, iterations=4)
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.kernels = True
        viewer.set_model(self.model)

        # one model-based impedance controller per world: same law, gains
        # swept over the worlds (gravity/Coriolis compensated through CRBA,
        # so tracking error depends only on kp against the load)
        dev = self.model.device
        self.dof_idx = torch.arange(2 * WORLDS, device=dev)
        kp = torch.as_tensor(np.repeat(KP, 2), dtype=torch.float32,
                             device=dev)
        kd = 2.0 * torch.sqrt(kp)           # critical-ish damping
        self.ctrl_law = JointImpedanceModelBased(self.model, kp, kd)
        self.target = torch.as_tensor(np.tile(TARGET, WORLDS),
                                      dtype=torch.float32, device=dev)

    def step(self):
        for _ in range(self.substeps):
            s = self.state
            tau = self.ctrl_law(self.model, s, self.target, self.dof_idx)
            joint_f = self.control.joint_f.clone()
            joint_f[self.dof_idx] = tau
            c = self.control.replace(joint_f=joint_f)
            self.state = self.solver.step(s, None, c, None, self.sim_dt,
                                          kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        q = self.state.joint_q.cpu().numpy().reshape(WORLDS, 2)
        assert np.isfinite(q).all()
        target = np.asarray(TARGET)
        err = np.abs(q - target).sum(axis=1)
        # stiffer worlds track strictly better...
        assert (np.diff(err) < 1e-3).all(), err
        # ...and the stiffest world is essentially on target
        assert err[-1] < 0.08, err


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
