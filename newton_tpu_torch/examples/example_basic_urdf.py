"""URDF import: a double pendulum authored as an inline URDF string swings
under gravity with the generalized solver (reference:
newton/examples/basic/example_basic_urdf.py; port of
newton_tpu/examples/example_basic_urdf.py). The importer reads the
cylinders as the JAX importer does (ROADMAP C.20)."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of

URDF = """<?xml version="1.0"?>
<robot name="double_pendulum">
  <link name="base">
    <inertial><mass value="0"/><inertia ixx="0" iyy="0" izz="0"
      ixy="0" ixz="0" iyz="0"/></inertial>
  </link>
  <link name="upper">
    <inertial>
      <origin xyz="0 0 -0.25"/>
      <mass value="1.0"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <origin xyz="0 0 -0.25"/>
      <geometry><cylinder radius="0.03" length="0.5"/></geometry>
    </collision>
  </link>
  <link name="lower">
    <inertial>
      <origin xyz="0 0 -0.25"/>
      <mass value="1.0"/>
      <inertia ixx="0.02" iyy="0.02" izz="0.001" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision>
      <origin xyz="0 0 -0.25"/>
      <geometry><cylinder radius="0.03" length="0.5"/></geometry>
    </collision>
  </link>
  <joint name="shoulder" type="revolute">
    <parent link="base"/>
    <child link="upper"/>
    <origin xyz="0 0 1.2"/>
    <axis xyz="0 1 0"/>
    <limit lower="-3.14" upper="3.14" effort="50" velocity="10"/>
  </joint>
  <joint name="elbow" type="revolute">
    <parent link="upper"/>
    <child link="lower"/>
    <origin xyz="0 0 -0.5"/>
    <axis xyz="0 1 0"/>
    <limit lower="-3.14" upper="3.14" effort="50" velocity="10"/>
  </joint>
</robot>
"""


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder(gravity=-9.81)
        builder.add_urdf(URDF)
        self.model = builder.finalize(device_of(args))
        self.solver = nt.SolverFeatherstone(self.model)
        # start horizontal so it swings
        q0 = self.model.joint_q0.clone()
        q0[0] = np.pi / 2
        self.state = nt.eval_fk(self.model, q0, self.model.joint_qd0,
                                self.model.state())
        self.control = self.model.control()
        self.sim_dt = 1.0 / 480.0
        self.substeps = 8
        self.time = 0.0
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

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
        q = self.state.body_q.cpu().numpy()
        jq = self.state.joint_q.cpu().numpy()
        assert np.isfinite(q).all() and np.isfinite(jq).all()
        # swinging: the shoulder has left its initial angle, and the
        # assembly stays below/near its anchor at 1.2 m
        assert abs(jq[0] - np.pi / 2) > 0.01
        assert q[:, 2].max() < 1.3


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
