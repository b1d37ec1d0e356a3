"""Every primitive shape type dropped onto the ground and coming to rest at
its analytic support height (reference:
newton/examples/basic/example_basic_shapes.py; port of
newton_tpu/examples/example_basic_shapes.py). The cone and ellipsoid
pairs run the support-map MPR."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder(gravity=-9.81)
        drop = 0.6
        self.expect = []  # (body, rest height, tol)

        def body_at(x, key):
            return builder.add_body(xform=[x, 0, drop, 0, 0, 0, 1], key=key)

        b = body_at(-2.0, "sphere")
        builder.add_shape_sphere(b, radius=0.2)
        builder.add_joint_free(b)
        self.expect.append((b, 0.2, 0.03))

        b = body_at(-1.2, "box")
        builder.add_shape_box(b, hx=0.15, hy=0.15, hz=0.15)
        builder.add_joint_free(b)
        self.expect.append((b, 0.15, 0.03))

        b = body_at(-0.4, "capsule")  # axis +Z -> lies or stands; starts
        builder.add_shape_capsule(b, radius=0.12, half_height=0.15)
        builder.add_joint_free(b)
        # capsule standing on its cap: z = half_height + radius; or on its
        # side: z = radius. Accept either stable pose.
        self.expect.append((b, None, (0.1, 0.3)))

        b = body_at(0.4, "cylinder")
        builder.add_shape_cylinder(b, radius=0.15, half_height=0.12)
        builder.add_joint_free(b)
        self.expect.append((b, None, (0.1, 0.3)))

        b = body_at(1.2, "cone")
        builder.add_shape_cone(b, radius=0.15, half_height=0.15)
        builder.add_joint_free(b)
        self.expect.append((b, None, (0.08, 0.35)))

        b = body_at(2.0, "ellipsoid")
        builder.add_shape_ellipsoid(b, rx=0.2, ry=0.14, rz=0.1)
        builder.add_joint_free(b)
        self.expect.append((b, None, (0.08, 0.25)))

        builder.add_ground_plane()
        self.model = builder.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverXPBD(self.model, iterations=4)
        self.state = self.model.state()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            self.state = self.solver.step(self.state, None, None,
                                          self.pipeline.collide(self.state),
                                          self.sim_dt)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        q = self.state.body_q.cpu().numpy()
        assert np.isfinite(q).all()
        for body, z_rest, tol in self.expect:
            z = float(q[body, 2])
            if z_rest is not None:
                assert abs(z - z_rest) < tol, (body, z, z_rest)
            else:
                lo, hi = tol
                assert lo < z < hi, (body, z)


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
