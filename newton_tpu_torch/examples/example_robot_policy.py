"""ONNX-policy-in-the-loop ant: obs -> ONNX graph -> torques -> step
(reference: examples/robot/example_robot_anymal_c_walk.py:188-301 and asv
bench_anymal.py:22-52; port of newton_tpu/examples/
example_robot_policy.py). The policy is a real ONNX binary run by the
port's interpreter (``controllers.OnnxModule``) on the model's device,
between the substeps, with no separate inference runtime.

The policy itself is a synthesized trot gait (phase features -> linear ->
tanh) serialized through ``encode_mlp``: no pretrained checkpoint ships
with the package, so the example exercises the ONNX execution path and
gates on forward progress as the reference benchmark does.
"""

import math
import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.controllers import OnnxModule, encode_mlp
from newton_tpu_torch.examples import device_of

ANT_XML = os.path.join(nt.ASSET_DIR, "ant.xml")


def actuator_names(path):
    """The MJCF's actuator names in document order (an unnamed actuator
    takes its tendon's or joint's name, as the importers name it)."""
    act = ET.parse(path).getroot().find("actuator")
    return [a.get("name") or a.get("tendon") or a.get("joint")
            for a in act]


def _gait_policy_onnx(names):
    """Serialize a trot-gait policy as ONNX bytes: obs = [sin, cos] phase
    features; diagonal leg pairs in antiphase; hips swing on sin, ankles
    push on cos."""
    W = np.zeros((2, 8), np.float32)
    b = np.zeros(8, np.float32)
    for col, name in enumerate(names):
        leg = int(name.split("_")[-1])
        sign = 1.0 if leg in (1, 3) else -1.0
        if name.startswith("hip"):
            W[0, col] = 0.5 * sign
        else:
            W[1, col] = 0.9 * sign
    return encode_mlp([(W, b)], output_activation="Tanh")


class Example:
    def __init__(self, viewer, args=None):
        self.viewer = viewer
        builder = nt.ModelBuilder()
        builder.add_mjcf(ANT_XML)
        self.model = model = builder.finalize(device_of(args))
        self.pipeline = nt.CollisionPipeline(model)
        self.solver = nt.SolverMuJoCo(model, iterations=8,
                                      integrator="euler")
        self.state = nt.eval_fk(model, model.joint_q0, model.joint_qd0,
                                model.state())
        self.control = model.control()
        self.sim_dt = 1.0 / 240.0
        self.substeps = 4
        self.time = 0.0
        self.kernels = True
        dev = model.device
        # the ONNX policy bytes -> executable module (decoder+interpreter)
        self.policy = OnnxModule(_gait_policy_onnx(actuator_names(ANT_XML)),
                                 device=dev)
        self.act_dofs = torch.as_tensor(
            np.asarray(model.structure.mjc_actuation.dof, np.int64),
            device=dev)
        self.act_gear = model.custom["mjc:actuator_gear"][self.act_dofs]
        self.x0 = float(self.state.joint_q[0])
        self.y0 = float(self.state.joint_q[1])
        self.freq = 2.2  # gait frequency (Hz)
        viewer.set_model(model)

    def step(self):
        t = torch.full((), np.float32(self.time), device=self.act_dofs.device)
        phase = 2.0 * math.pi * self.freq * t
        obs = torch.stack([torch.sin(phase), torch.cos(phase)])[None]
        action = self.policy(obs)[0]                     # (8,) in [-1, 1]
        tau = torch.zeros_like(self.control.joint_f)
        tau[self.act_dofs] = action * self.act_gear
        ctl = self.control.replace(joint_f=tau)
        for _ in range(self.substeps):
            self.state = self.solver.step(
                self.state, None, ctl, self.pipeline.collide(self.state),
                self.sim_dt, kernels=self.kernels)
        self.time += self.sim_dt * self.substeps

    def render(self):
        self.viewer.begin_frame(self.time)
        self.viewer.log_state(self.state)
        self.viewer.end_frame()

    def test_final(self):
        jq = self.state.joint_q.cpu().numpy()
        assert np.isfinite(jq).all()
        # validity gates in the spirit of the reference's bench_anymal:
        # body stays upright and the gait makes real progress
        assert 0.2 < jq[2] < 1.2, f"ant torso height {jq[2]}"
        progress = float(np.hypot(jq[0] - self.x0, jq[1] - self.y0))
        assert progress > 0.08, f"gait made no progress: {progress:.3f} m"


if __name__ == "__main__":
    from newton_tpu_torch.examples import init, run
    viewer, args = init()
    run(Example(viewer, args), args)
