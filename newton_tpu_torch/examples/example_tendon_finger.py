"""Two-segment finger flexed by a spatial tendon routed over cylinder wrap
geoms at each knuckle, the biomechanical tendon-routing workload
(reference: MJCF <spatial> tendons with wrap geoms, imported via the wrap
arrays at newton/_src/utils/import_mjcf.py:2865-2868; port of
newton_tpu/examples/example_tendon_finger.py). The tendon length, wrap
routing and moment arms are evaluated in every substep
(newton_tpu_torch/sim/tendon.py); a single muscle-style pull force curls
both joints with knuckle-radius moment arms, and the passive tendon
spring re-extends the finger when the pull releases.
"""

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

FINGER_MJCF = """
<mujoco model="finger">
  <option gravity="0 0 -9.81" timestep="0.004"/>
  <worldbody>
    <site name="origin" pos="-0.02 0 -0.02"/>
    <body name="proximal" pos="0 0 0">
      <joint name="mcp" type="hinge" axis="0 1 0" range="-5 95"
             damping="0.05"/>
      <geom name="pseg" type="capsule" fromto="0 0 0 0.05 0 0" size="0.009"/>
      <geom name="pwrap" type="cylinder" pos="0.0 0 -0.012" zaxis="0 1 0"
            size="0.008 0.012" contype="0" conaffinity="0"/>
      <site name="pal" pos="0.025 0 -0.011"/>
      <body name="distal" pos="0.05 0 0">
        <joint name="pip" type="hinge" axis="0 1 0" range="-5 110"
               damping="0.05"/>
        <geom name="dseg" type="capsule" fromto="0 0 0 0.04 0 0"
              size="0.008"/>
        <geom name="dwrap" type="cylinder" pos="0.0 0 -0.011" zaxis="0 1 0"
              size="0.007 0.011" contype="0" conaffinity="0"/>
        <site name="tip" pos="0.035 0 -0.009"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="flexor" stiffness="45" damping="0.3">
      <site site="origin"/>
      <geom geom="pwrap"/>
      <site site="pal"/>
      <geom geom="dwrap"/>
      <site site="tip"/>
    </spatial>
  </tendon>
  <actuator>
    <motor name="pull" tendon="flexor" gear="1" ctrlrange="-8 0"
           ctrllimited="true"/>
  </actuator>
</mujoco>
"""


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder()
        b.gravity = (0.0, 0.0, -9.81)
        b.add_mjcf(FINGER_MJCF)
        self.model = b.finalize(device_of(args))
        self.solver = nt.SolverMuJoCo(self.model, iterations=8)
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.kernels = True
        viewer.set_model(self.model)
        # pull for the first 1.5 s, release after (the passive spring
        # re-extends the finger): the two controls, made once
        self.pulls = {
            p: self.control.replace(custom={
                **self.control.custom,
                "mjc:ctrl": torch.full((1,), p, device=self.model.device)})
            for p in (-6.0, 0.0)}

    def step(self):
        control = self.pulls[-6.0 if np.float32(self.time) < 1.5 else 0.0]
        for _ in range(self.substeps):
            self.state = self.solver.step(self.state, None, control, None,
                                          self.sim_dt, kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        q = self.state.joint_q.cpu().numpy()
        assert np.isfinite(q).all(), "non-finite finger coordinates"
        # after release the passive spring should have re-extended the
        # finger most of the way back toward the build pose
        if self.time > 2.5:
            assert np.abs(q).max() < 1.0, f"finger failed to re-extend: {q}"


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
