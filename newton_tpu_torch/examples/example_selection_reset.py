"""ArticulationView get/set + per-world selective reset (reference:
newton/examples/selection/ family; selection.py:1587-1673; port of
newton_tpu/examples/example_selection_reset.py). ``--num-worlds`` sets
the number of worlds.

Every 30 frames the even worlds' roots are lifted back to z = 1 through
``view.set_root_transforms(..., mask=)`` and ``view.eval_fk``; the mask
is made on the model's device, so the reset reads nothing back to the
host.
"""

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of
from newton_tpu_torch.utils import ArticulationView


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        worlds = getattr(args, "num_worlds", 4) if args else 4
        robot = nt.ModelBuilder()
        body = robot.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1], key="ball")
        robot.add_shape_sphere(body, radius=0.3)
        robot.add_joint_free(body)
        builder = nt.ModelBuilder()
        builder.add_ground_plane()
        builder.replicate(robot, worlds)
        self.model = builder.finalize(device_of(args))
        self.view = ArticulationView(self.model, "*")
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solver = nt.SolverXPBD(self.model, iterations=2)
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 120.0
        self.substeps = 2
        self.time = 0.0
        self.frame_i = 0
        self.worlds = worlds
        # the worlds the reset lifts, on the model's device
        self.reset_mask = torch.arange(worlds, device=self.model.device) \
            % 2 == 0
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            c = self.pipeline.collide(self.state)
            self.state = self.solver.step(self.state, None, self.control, c,
                                          self.sim_dt)
        self.frame_i += 1
        # every 30 frames, teleport half the worlds back up via the view
        if self.frame_i % 30 == 0:
            roots = self.view.get_root_transforms(self.state)
            lifted = roots.clone()
            lifted[:, 2] = 1.0
            self.state = self.view.set_root_transforms(
                self.state, lifted, mask=self.reset_mask)
            self.state = self.view.eval_fk(self.state)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        roots = self.view.get_root_transforms(self.state).cpu().numpy()
        assert np.isfinite(roots).all()
        assert (roots[:, 2] > 0.1).all()


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
