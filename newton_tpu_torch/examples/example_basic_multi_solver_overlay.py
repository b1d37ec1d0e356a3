"""The same box-drop scene stepped by three solvers side by side (XPBD,
generalized PGS, VBD rigid AVBD), rendered with per-world offsets — a
live solver-comparison overlay (reference:
newton/examples/basic/example_basic_multi_solver_overlay.py; port of
newton_tpu/examples/example_basic_multi_solver_overlay.py). The
generalized solver runs B1 and B2; AVBD solves its 6x6 systems with
B1's ``chol_solve``."""

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of


def _scene(device):
    b = nt.ModelBuilder(gravity=-9.81)
    body = b.add_body(xform=[0, 0, 0.6, 0, 0, 0, 1], key="box")
    b.add_shape_box(body, hx=0.12, hy=0.12, hz=0.12)
    b.add_joint_free(body)
    b.add_ground_plane()
    return b.finalize(device)


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        self.model = _scene(device_of(args))
        self.pipeline = nt.CollisionPipeline(self.model)
        self.solvers = [
            ("xpbd", nt.SolverXPBD(self.model, iterations=4)),
            ("pgs", nt.SolverMuJoCo(self.model, iterations=8,
                                    integrator="euler")),
            ("vbd", nt.SolverVBD(self.model, iterations=6)),
        ]
        self.states = [self.model.state() for _ in self.solvers]
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        # False steps the generalized solver through the kernels' plain
        # PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

    @property
    def state(self):
        """The generalized solver's state, the one the registry's NaN
        sweep reads."""
        return self.states[1]

    def _step_one(self, name, solver, s):
        for _ in range(self.substeps):
            kw = dict(kernels=self.kernels) if name == "pgs" else {}
            s = solver.step(s, None, None, self.pipeline.collide(s),
                            self.sim_dt, **kw)
        return s

    def step(self):
        self.states = [self._step_one(name, solver, s) for (name, solver), s
                       in zip(self.solvers, self.states)]
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        # overlay: offset each solver's world along +y
        for k, s in enumerate(self.states):
            off = torch.zeros_like(s.body_q)
            off[:, 1] = 0.5 * k
            self.viewer.log_state(s.replace(body_q=s.body_q + off))
        self.viewer.end_frame()

    def test_final(self):
        # all three solvers agree on the resting pose
        for (name, _), s in zip(self.solvers, self.states):
            q = s.body_q.cpu().numpy()
            assert np.isfinite(q).all(), name
            assert abs(q[0, 2] - 0.12) < 0.03, (name, q[0, 2])


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
