"""Batched humanoids: replicate() + generalized solver over N worlds
(the reference KPI benchmark shape, asv/benchmarks/simulation/
bench_mujoco.py; port of newton_tpu/examples/
example_robot_humanoid_batch.py). ``--num-worlds`` sets N."""

import os

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

HUMANOID_XML = os.path.join(nt.ASSET_DIR, "humanoid.xml")


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        self.worlds = getattr(args, "num_worlds", 4) if args else 4
        robot = nt.ModelBuilder()
        robot.add_mjcf(HUMANOID_XML)
        builder = nt.ModelBuilder()
        builder.replicate(robot, self.worlds)
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
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

    def step(self):
        for _ in range(self.substeps):
            contacts = self.pipeline.collide(self.state)
            self.state = self.solver.step(self.state, None, self.control,
                                          contacts, self.sim_dt,
                                          kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        jq = self.state.joint_q.cpu().numpy()
        assert np.isfinite(jq).all()
        # every world's root height within physical bounds
        nq_per = self.model.structure.joint_coord_count // self.worlds
        heights = jq.reshape(self.worlds, nq_per)[:, 2]
        assert (heights > 0.2).all() and (heights < 2.0).all(), heights


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
