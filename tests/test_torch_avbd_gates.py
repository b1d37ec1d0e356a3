"""The JAX package's AVBD gates on the port, on the CPU:
tests/test_solvers.py:319 (``test_avbd_rigid_stack_and_pendulum``: two
unit boxes settle stacked, the ball pendulum keeps its length) and
tests/test_cable.py:121 (``test_vbd_cable_bend_stiffness``: the stiffer
cable bend holds its tip higher), with the JAX tests' thresholds. The
parity cases of ``SolverVBD``'s rigid bodies are in
tests/test_torch_avbd.py.
"""

import os
import sys

import numpy as np
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phase 52)
from test_torch_avbd import _roll  # noqa: E402

torch.set_num_threads(1)


def test_avbd_rigid_stack_and_pendulum():
    """tests/test_solvers.py:319 on the port: two unit boxes (the upper 0.1
    off-centre) settle stacked within 0.05 / 0.08; the ball pendulum
    keeps its 0.5 m length within 2e-3 and swings below its pivot."""
    b = nt.ModelBuilder()
    base = b.add_body(xform=[0, 0, 0.5, 0, 0, 0, 1])
    top = b.add_body(xform=[0.1, 0, 1.51, 0, 0, 0, 1])
    for body in (base, top):
        b.add_shape_box(body, hx=0.5, hy=0.5, hz=0.5)
        b.add_joint_free(body)
    b.add_ground_plane()
    m = b.finalize("cpu")
    q = _roll(m, nt.SolverVBD(m, iterations=8), nt.CollisionPipeline(m),
              120).body_q.numpy()
    assert np.isfinite(q).all()
    assert abs(q[0, 2] - 0.5) < 0.05 and abs(q[1, 2] - 1.5) < 0.08, q[:, 2]

    m = cs.vbd_pendulum_scene(nt).finalize("cpu")
    solver = nt.SolverVBD(m, iterations=6)
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    traj = []
    for _ in range(60):
        s = _roll(m, solver, None, 1, state=s)
        traj.append(s.body_q[0, :3].numpy())
    traj = np.stack(traj)
    np.testing.assert_allclose(np.linalg.norm(traj, axis=1), 0.5, atol=2e-3)
    assert traj[:, 2].min() > -0.501 and traj[:, 2].max() < 0.05


def test_vbd_cable_bend_stiffness():
    """tests/test_cable.py:121 on the port: a six-segment cable rod under
    SolverVBD(iterations=6), 600 substeps at 1/960; the stiffer bend
    (500) holds the tip higher than the floppy one (0.5), above 0.9."""
    tips = []
    for ke in (0.5, 500.0):
        m = cs.vbd_rod_scene(nt, 1, ke).finalize("cpu")
        s = _roll(m, nt.SolverVBD(m, iterations=6), None, 600, 1,
                  cs.ROD_VBD_DT)
        q = s.body_q.numpy()
        assert np.isfinite(q).all()
        tips.append(float(q[-1, 2]))
    assert tips[0] < tips[1] <= 1.01, tips
    assert tips[1] > 0.9
