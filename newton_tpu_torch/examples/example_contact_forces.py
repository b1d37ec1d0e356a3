"""Contact-force sensing via step_with_contacts — forces come from the
solve that already ran, no second solve (reference: SensorContact +
solver.update_contacts flow; port of
newton_tpu/examples/example_contact_forces.py). The summed contact force
is logged each frame as the scalar ``contact/total_force``."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder()
        body = b.add_body(xform=[0, 0, 0.3, 0, 0, 0, 1], key="crate")
        b.add_shape_box(body, hx=0.3, hy=0.3, hz=0.3,
                        cfg=nt.ShapeConfig(density=1000.0))
        b.add_joint_free(body)
        b.add_ground_plane()
        self.model = b.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverFeatherstone(self.model,
                                            contact_iterations=8)
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 1
        self.time = 0.0
        self.normal_force = 0.0
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

    def step(self):
        c = self.pipeline.collide(self.state)
        self.state, c2 = self.solver.step_with_contacts(
            self.state, None, self.control, c, self.sim_dt,
            kernels=self.kernels)
        f = c2.rigid_contact_force.cpu().numpy()
        m = c2.rigid_contact_mask.cpu().numpy()
        self.normal_force = float(np.abs(f[m]).sum()) if m.any() else 0.0
        self.viewer.log_scalar("contact/total_force", self.normal_force)
        self.time += self.sim_dt

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        # at rest the reported normal force supports the crate's weight
        weight = float(self.model.body_mass[0]) * 9.81
        assert self.normal_force > 0.2 * weight, \
            (self.normal_force, weight)


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
