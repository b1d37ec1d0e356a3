"""The JAX package's cable gates on the port (split from
test_torch_cable.py, whose scenes they use): the cantilever sag and the
twist of tests/test_cable.py, and the Dahl friction hysteresis of
tests/test_dahl_friction.py, each at the JAX test's size and bound."""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.math import quat_mul

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 43-44)
from test_torch_cable import _dahl_box, _push  # noqa: E402

torch.set_num_threads(1)


def test_cable_sag_and_twist_gates():
    """tests/test_cable.py:67 and :83 on the port: the stiffer cantilever
    sags less after 1500 substeps of 1/960 (the stiffest tip above 0.85,
    the softest below 0.7, none above 1.01), and a tip twisted 90 degrees
    relaxes through the fixed root within 400 substeps (every quaternion's
    z below 0.15)."""
    b, tip = cs.sag_scene(nt, 1)            # the three side by side
    m = b.finalize("cpu")
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    solver = nt.SolverXPBD(m, iterations=8)
    for _ in range(1500):
        s = solver.step(s, None, None, None, 1.0 / 960.0)
    assert bool(torch.isfinite(s.body_q).all())
    tips = s.body_q[tip, 2].tolist()
    assert tips[0] < tips[1] < tips[2] <= 1.01, tips
    assert tips[2] > 0.85 and tips[0] < 0.7, tips
    b = nt.ModelBuilder(gravity=0.0)
    bodies = b.add_rod([0, 0, 0], [0, 0, 0.8], segments=8, radius=0.01,
                       joint="cable", bend_ke=50.0, bend_kd=0.5,
                       twist_ke=20.0, twist_kd=0.5, stretch_ke=2.0e4,
                       stretch_kd=1.0, root_joint="fixed")
    m = b.finalize("cpu")
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    qz = torch.tensor([0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)],
                      dtype=torch.float32)
    s.body_q[bodies[-1], 3:7] = quat_mul(qz, s.body_q[bodies[-1], 3:7])
    solver = nt.SolverXPBD(m, iterations=8)
    for _ in range(400):
        s = solver.step(s, None, None, None, 1.0 / 960.0)
    assert bool(torch.isfinite(s.body_q).all())
    assert float(s.body_q[:, 5].abs().max()) < 0.15


def test_dahl_gates():
    """tests/test_dahl_friction.py:45-77 on the port: a box launched at
    2 m/s stops within 0.1-0.45 m and keeps a bristle state; a push of
    15 N (below mu m g = 39 N) creeps less than 0.1 m in 1 s; without
    init_state the solver raises, naming it."""
    m = _dahl_box(nt).finalize("cpu")
    pipe = nt.CollisionPipeline(m)
    sol = nt.SolverXPBD(m, iterations=4, friction_model="dahl",
                        dahl_sigma=5.0e4)
    s = sol.init_state(m.state())
    s.body_qd[0, 0] = 2.0
    s, xs = _push(sol, pipe, s, 90)
    assert bool(torch.isfinite(s.body_q).all())
    assert abs(float(s.body_qd[0, 0])) < 0.05
    assert 0.1 < xs[-1] < 0.45
    assert (s.custom["xpbd:dahl_f"].abs().sum(1) > 1e-6).any()
    sol = nt.SolverXPBD(m, iterations=4, friction_model="dahl",
                        dahl_sigma=1.0e5)
    s, xs = _push(sol, pipe, sol.init_state(m.state()), 60, force=15.0)
    assert xs[-1] < 0.1, xs[-1]
    with pytest.raises(ValueError, match="init_state"):
        nt.SolverXPBD(m, friction_model="dahl").step(
            m.state(), None, None, pipe.collide(m.state()), 1.0 / 240.0)
