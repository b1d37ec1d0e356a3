"""Joint-type showcase: revolute, prismatic, ball, fixed, free and d6
joints side by side in one scene (reference:
examples/basic/example_basic_joints.py; port of
newton_tpu/examples/example_basic_joints.py).

Each articulation hangs from the world and swings/slides under gravity;
test_final checks every joint respects its own motion subspace.
"""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.core.host_math import np_transform_point
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder()
        cfg = nt.ShapeConfig(density=1000.0)

        def link(x, key):
            body = b.add_body(xform=[x, 0, 1.0, 0, 0, 0, 1], key=key)
            b.add_shape_capsule(body, radius=0.05, half_height=0.2, cfg=cfg)
            return body

        # revolute about Y: swings in the x-z plane
        self.rev = link(0.0, "revolute")
        self.j_rev = b.add_joint_revolute(
            parent=-1, child=self.rev, axis="Y",
            xform_p=[0, 0, 1.3, 0, 0, 0, 1],
            xform_c=[0, 0, 0.3, 0, 0, 0, 1])
        # prismatic along X: slides horizontally, z frozen
        self.pris = link(1.0, "prismatic")
        b.add_joint_prismatic(parent=-1, child=self.pris, axis="X",
                              xform_p=[1.0, 0, 1.0, 0, 0, 0, 1])
        # ball: 3-dof swing
        self.ball = link(2.0, "ball")
        self.j_ball = b.add_joint_ball(
            parent=-1, child=self.ball,
            xform_p=[2.0, 0, 1.3, 0, 0, 0, 1],
            xform_c=[0, 0, 0.3, 0, 0, 0, 1])
        # fixed: welded to the world, must not move at all
        self.fix = link(3.0, "fixed")
        b.add_joint_fixed(parent=-1, child=self.fix,
                          xform_p=[3.0, 0, 1.0, 0, 0, 0, 1])
        # free: falls under gravity
        self.free = link(4.0, "free")
        b.add_joint_free(self.free)
        # d6 with one angular dof (acts like a revolute about X)
        self.d6 = link(5.0, "d6")
        b.add_joint_d6(parent=-1, child=self.d6,
                       angular_axes=[nt.JointDofConfig(axis="X")],
                       xform_p=[5.0, 0, 1.3, 0, 0, 0, 1],
                       xform_c=[0, 0, 0.3, 0, 0, 0, 1])

        self.model = b.finalize(device_of(args))
        self.solver = nt.SolverFeatherstone(self.model)
        # kick the hinged links so every subspace is exercised (hanging
        # straight down is a stable equilibrium)
        qd_start = np.asarray(self.model.structure.joint_qd_start)
        qd0 = self.model.joint_qd0.clone()
        qd0[int(qd_start[self.j_rev])] = 2.0
        qd0[int(qd_start[self.j_ball])] = 1.5        # wx
        qd0[int(qd_start[self.j_ball]) + 1] = 1.0    # wy
        self.state = nt.eval_fk(self.model, self.model.joint_q0, qd0,
                                self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)
        self.p0 = self.state.body_q[:, :3].cpu().numpy().copy()

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
        p = self.state.body_q[:, :3].cpu().numpy()
        p0 = self.p0
        assert np.isfinite(p).all()
        # revolute: moved, but stays in its x-z plane (y fixed)
        assert abs(p[self.rev, 1] - p0[self.rev, 1]) < 1e-3
        assert abs(p[self.rev, 2] - p0[self.rev, 2]) > 1e-3
        # prismatic: z and y locked, x free
        assert abs(p[self.pris, 2] - p0[self.pris, 2]) < 1e-3
        assert abs(p[self.pris, 1] - p0[self.pris, 1]) < 1e-3
        # fixed: did not move
        assert np.linalg.norm(p[self.fix] - p0[self.fix]) < 1e-4
        # free: fell
        assert p[self.free, 2] < p0[self.free, 2] - 0.05
        # ball pivot preserved: distance from anchor constant
        anchor = np.array([2.0, 0, 1.3])
        d0 = np.linalg.norm(p0[self.ball] + np.array([0, 0, 0.3]) - anchor)
        # recompute current offset in world frame via body rotation
        bq = self.state.body_q[self.ball].cpu().numpy()
        d1 = np.linalg.norm(np_transform_point(bq, np.array([0, 0, 0.3]))
                            - anchor)
        assert abs(d1 - d0) < 2e-3, (d0, d1)


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
