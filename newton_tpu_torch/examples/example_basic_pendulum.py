"""Single pendulum under XPBD (reference:
newton/examples/basic/example_basic_pendulum.py:20-137; port of
newton_tpu/examples/example_basic_pendulum.py). The canonical end-to-end
slice: build -> finalize -> substep loop -> envelope test.
"""

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder()
        link = builder.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1], key="link")
        builder.add_shape_box(link, hx=0.5, hy=0.05, hz=0.05)
        builder.add_joint_revolute(parent=-1, child=link, axis="Y",
                                   xform_c=[-0.5, 0, 0, 0, 0, 0, 1],
                                   key="pivot")
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverXPBD(self.model, iterations=4)
        zero = torch.zeros(1, device=self.model.device)
        self.state = nt.eval_fk(self.model, zero, zero, self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            self.state = self.solver.step(self.state, None, self.control,
                                          None, self.sim_dt)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        # envelope assertions (reference example :115-137)
        bq = self.state.body_q.cpu().numpy()
        assert bq[0, 2] <= 0.02, f"pendulum above pivot plane: {bq[0, 2]}"
        assert bq[0, 2] >= -0.51
        d = np.linalg.norm(bq[0, :3])
        assert abs(d - 0.5) < 1e-2, f"anchor drift {d}"


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
