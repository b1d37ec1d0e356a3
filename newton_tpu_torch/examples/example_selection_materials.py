"""Per-world contact materials through the selection API: six replicated
worlds get increasing friction via ArticulationView.set_attribute, and the
same initial shove slides each box a decreasing distance (reference:
newton/examples/selection/example_selection_materials.py; port of
newton_tpu/examples/example_selection_materials.py).

``replicate(..., spacing=)`` offsets a free root's body and its joint
coordinates, so each world's box starts at twice its spacing (ROADMAP
C.45, the JAX package's behaviour, reproduced)."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of
from newton_tpu_torch.utils import ArticulationView

N_WORLDS = 6


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        world = nt.ModelBuilder(gravity=-9.81)
        body = world.add_body(xform=[0, 0, 0.1, 0, 0, 0, 1], key="box")
        world.add_shape_box(body, hx=0.1, hy=0.1, hz=0.1, key="box_shape")
        world.add_joint_free(body, key="box_free")
        world.add_ground_plane()

        builder = nt.ModelBuilder(gravity=-9.81)
        builder.replicate(world, N_WORLDS, spacing=(0.0, 1.0, 0.0))
        model = builder.finalize(device_of(args))

        # per-world friction 0.1 .. 0.6 on the box shape, via the selection
        # API's shape-frequency attribute access
        self.view = ArticulationView(model, "*")
        self.mus = np.linspace(0.1, 0.6, N_WORLDS)
        mu = self.view.get_attribute("shape_material_mu", model)
        self.model = self.view.set_attribute(
            "shape_material_mu", model, np.array(np.broadcast_to(
                self.mus[:, None], tuple(mu.shape))))

        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverXPBD(self.model, iterations=4)
        state = self.model.state()
        # identical +x shove in every world
        qd = self.view.get_root_velocities(state).clone()
        qd[:, 0] = 2.0
        state = self.view.set_root_velocities(state, qd)
        # propagate the joint-space shove into body velocities
        self.state = self.view.eval_fk(state)
        self.x0 = self.view.get_root_transforms(
            self.state).cpu().numpy()[:, 0].copy()
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
        xf = self.view.get_root_transforms(self.state).cpu().numpy()
        assert np.isfinite(xf).all()
        slid = xf[:, 0] - self.x0
        # every box slid forward, and higher friction slid strictly less
        assert (slid > 0.02).all(), slid
        assert (np.diff(slid) < 0).all(), slid


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
