"""Conveyor belt with per-contact force reporting (reference:
newton/examples/basic/example_basic_conveyor_forces.py — belt drags cargo
while the contact-force report is logged; port of
newton_tpu/examples/example_basic_conveyor_forces.py).

Exercises the generalized solver's moving-support contact rows: the belt
is a KINEMATIC body (no joint, constant velocity); cargo contacts carry
the belt's velocity as the relative-velocity target, so friction drags
the boxes at belt speed, and ``step_with_contacts`` reports the forces,
logged each frame as the scalars ``conveyor/normal_force`` and
``conveyor/drag_force``."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

BELT_SPEED = 0.6  # m/s


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder(gravity=-9.81)
        cfg = builder.default_shape_cfg.copy()
        cfg.mu = 0.9

        belt = builder.add_body(
            xform=[0.0, 0.0, 0.05, 0, 0, 0, 1],
            qd=np.array([BELT_SPEED, 0, 0, 0, 0, 0]),
            kinematic=True, key="belt")
        builder.add_shape_box(belt, hx=2.0, hy=0.5, hz=0.05, cfg=cfg,
                              key="belt_top")

        self.boxes = []
        for i in range(2):
            bb = builder.add_body(
                xform=[-1.0 + 0.5 * i, 0.0, 0.2, 0, 0, 0, 1],
                key=f"crate_{i}")
            builder.add_shape_box(bb, hx=0.1, hy=0.1, hz=0.1, cfg=cfg,
                                  key=f"crate_shape_{i}")
            builder.add_joint_free(bb, key=f"crate_free_{i}")
            self.boxes.append(bb)
        self.model = builder.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverMuJoCo(self.model, iterations=16,
                                      warm_start=False)
        self.state = self.model.state()
        self.x0 = self.state.body_q.cpu().numpy()[self.boxes, 0].copy()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 1
        self.time = 0.0
        self.normal_force = 0.0
        self.drag_force = 0.0
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

    def step(self):
        c = self.pipeline.collide(self.state)
        self.state, c2 = self.solver.step_with_contacts(
            self.state, None, None, c, self.sim_dt, kernels=self.kernels)
        f = c2.rigid_contact_force.cpu().numpy()
        m = c2.rigid_contact_mask.cpu().numpy()
        if m.any():
            self.normal_force = float(np.abs(f[m][:, 2]).sum())
            self.drag_force = float(f[m][:, 0].sum())
        self.viewer.log_scalar("conveyor/normal_force", self.normal_force)
        self.viewer.log_scalar("conveyor/drag_force", self.drag_force)
        self.time += self.sim_dt

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        q = self.state.body_q.cpu().numpy()
        qd = self.state.body_qd.cpu().numpy()
        assert np.isfinite(q).all()
        # crates dragged along +x by belt friction
        dx = q[self.boxes, 0] - self.x0
        assert (dx > 0.01).all(), dx
        assert (qd[self.boxes, 0] > 0.05).all(), qd[self.boxes, 0]
        # reported normal force supports the crates' weight
        w = float(self.model.body_mass.cpu().numpy()[self.boxes].sum()) \
            * 9.81
        assert self.normal_force > 0.3 * w, (self.normal_force, w)


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
