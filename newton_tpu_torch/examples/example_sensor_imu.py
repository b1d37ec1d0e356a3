"""IMU + frame-transform sensors on a swinging pendulum (reference:
newton/examples sensor family; port of
newton_tpu/examples/example_sensor_imu.py). The IMU's vertical
acceleration is logged each frame as the scalar ``imu/acc_z``."""

import numpy as np

import newton_tpu_torch as nt
from newton_tpu_torch.examples import device_of
from newton_tpu_torch.sensors import SensorFrameTransform, SensorIMU


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        b = nt.ModelBuilder()
        rod = b.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1], key="rod")
        b.add_shape_capsule(rod, radius=0.05, half_height=0.25)
        b.add_joint_revolute(parent=-1, child=rod, axis="Y",
                             xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
        self.model = b.finalize(device_of(args))
        self.solver = nt.SolverFeatherstone(self.model)
        self.imu = SensorIMU(self.model, sites=[0])
        self.frame_sensor = SensorFrameTransform(
            self.model, reference_frames=[0], target_frames=[0])
        self.state = nt.eval_fk(self.model, self.model.joint_q0,
                                self.model.joint_qd0, self.model.state())
        self.prev_state = self.state
        self.control = self.model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.last_accel = np.zeros(3)
        # False steps through the kernels' plain PyTorch versions
        self.kernels = True
        viewer.set_model(self.model)

    def step(self):
        self.prev_state = self.state
        for _ in range(self.substeps):
            self.state = self.solver.step(self.state, None, self.control,
                                          None, self.sim_dt,
                                          kernels=self.kernels)
        self.time += self.sim_dt * self.substeps
        lin_acc, _ang_vel = self.imu.update(
            self.state, self.prev_state, self.sim_dt * self.substeps)
        self.last_accel = lin_acc.cpu().numpy()[0]
        self.viewer.log_scalar("imu/acc_z", float(self.last_accel[2]))

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        assert np.isfinite(self.last_accel).all()
        X = self.frame_sensor.update(self.state)
        assert np.isfinite(X.cpu().numpy()).all()
        # pendulum swung under gravity
        assert abs(float(self.state.joint_q[0])) > 0.05


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
