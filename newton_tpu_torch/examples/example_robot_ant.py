"""Ant robot with random actuation under the generalized solver
(reference: newton/examples/robot/ examples + asv bench_mujoco workload;
port of newton_tpu/examples/example_robot_ant.py). The random torques
come from a ``torch.Generator`` seeded 0 on the model's device."""

import os

import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

ANT_XML = os.path.join(nt.ASSET_DIR, "ant.xml")


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder()
        self.info = builder.add_mjcf(ANT_XML)
        self.model = builder.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverMuJoCo(self.model, iterations=8,
                                      integrator="euler")
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.kernels = True
        dev = self.model.device
        self.generator = torch.Generator(device=dev).manual_seed(0)
        D = self.model.structure.joint_dof_count
        self.gear = self.model.custom.get(
            "mjc:actuator_gear", torch.zeros(D, device=dev))
        viewer.set_model(self.model)

    def draw(self):
        """This frame's torque inputs in [-0.3, 0.3), one per dof."""
        u = torch.rand(self.gear.shape[0], generator=self.generator,
                       device=self.gear.device)
        return u * 0.6 - 0.3

    def step(self, ctrl=None):
        """One frame; ``ctrl`` (D,) replaces the frame's random draw."""
        ctrl = self.draw() if ctrl is None else ctrl
        control = self.control.replace(joint_f=ctrl * self.gear)
        for _ in range(self.substeps):
            contacts = self.pipeline.collide(self.state)
            self.state = self.solver.step(self.state, None, control,
                                          contacts, self.sim_dt,
                                          kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.log_scalar("torso_height", float(self.state.joint_q[2]))
        self.viewer.end_frame()

    def test_final(self):
        h = float(self.state.joint_q[2])
        assert 0.1 < h < 1.5, f"ant torso height {h}"
        qn = float(torch.linalg.vector_norm(self.state.joint_q[3:7]))
        assert abs(qn - 1.0) < 1e-2, f"quaternion norm {qn}"


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
