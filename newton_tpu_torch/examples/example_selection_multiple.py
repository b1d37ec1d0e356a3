"""Multiple ArticulationViews over one mixed scene (reference:
newton/examples/selection/example_selection_multiple.py; port of
newton_tpu/examples/example_selection_multiple.py): cartpoles and double
pendulums share a flat model; two views by explicit indices address each
family independently — per-family batched reads, writes, and FK."""

import os

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of
from newton_tpu_torch.utils import ArticulationView

XML = os.path.join(nt.ASSET_DIR, "inverted_pendulum.xml")
N_EACH = 4


def _pendulum_builder():
    b = nt.ModelBuilder()
    link1 = b.add_body(xform=[2.0, 0, 1.0, 0, 0, 0, 1], key="pend_link1")
    b.add_shape_capsule(link1, radius=0.03, half_height=0.15,
                        key="pend_shape1")
    b.add_joint_revolute(-1, link1, axis=[0, 1, 0],
                         xform_p=[2.0, 0, 1.3, 0, 0, 0, 1],
                         xform_c=[0, 0, 0.15, 0, 0, 0, 1],
                         key="pend_hinge1")
    link2 = b.add_body(xform=[2.0, 0, 0.7, 0, 0, 0, 1], key="pend_link2")
    b.add_shape_capsule(link2, radius=0.03, half_height=0.15,
                        key="pend_shape2")
    b.add_joint_revolute(link1, link2, axis=[0, 1, 0],
                         xform_p=[0, 0, -0.15, 0, 0, 0, 1],
                         xform_c=[0, 0, 0.15, 0, 0, 0, 1],
                         key="pend_hinge2")
    return b


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        cart = nt.ModelBuilder()
        cart.add_mjcf(XML)
        pend = _pendulum_builder()
        builder = nt.ModelBuilder()
        builder.replicate(cart, N_EACH, spacing=(0.0, 1.0, 0.0))
        builder.replicate(pend, N_EACH, spacing=(0.0, 1.0, 0.0))
        self.model = builder.finalize(device_of(args))
        # two independent views over the same flat model, by explicit
        # articulation indices (families were added in order)
        n_art = len(self.model.structure.articulation_key)
        self.carts = ArticulationView(self.model, list(range(N_EACH)))
        self.pends = ArticulationView(self.model,
                                      list(range(n_art - N_EACH, n_art)))
        self.solver = nt.SolverFeatherstone(self.model)
        state = self.model.state()
        qp = self.pends.get_dof_positions(state).clone()
        qp[:, 0] = 0.6                     # swing every pendulum out
        state = self.pends.set_dof_positions(state, qp)
        state = self.pends.eval_fk(state)
        qc = self.carts.get_dof_positions(state).clone()
        qc[:, 1] = 0.1                     # tilt every pole
        state = self.carts.set_dof_positions(state, qc)
        self.state = self.carts.eval_fk(state)
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            self.state = self.solver.step(self.state, None, None, None,
                                          self.sim_dt, kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        assert self.carts.count == N_EACH, self.carts.count
        assert self.pends.count == N_EACH, self.pends.count
        q = self.state.body_q.cpu().numpy()
        assert np.isfinite(q).all()
        # the two families evolve independently: pendulums swing
        qp = self.pends.get_dof_positions(self.state).cpu().numpy()
        assert np.abs(qp).max() > 0.05
        # batched view read matches state slicing
        qd = self.pends.get_dof_velocities(self.state).cpu().numpy()
        assert qd.shape[0] == N_EACH


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
