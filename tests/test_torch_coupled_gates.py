"""The JAX package's ``SolverCoupled`` gates of tests/test_equality.py on
the port, on the CPU, with the JAX tests' thresholds:
``test_coupled_rigid_particle_stable`` (:89, a cloth on a ball, SolverXPBD
with SolverVBD: the ball rests at z = 0.2 within 0.05),
``test_coupled_consensus_momentum_transfer`` (:209, the particle blob on
a free box: total momentum follows the weight within 5%, the residual
does not grow) and ``test_coupled_body_partition_collision`` (:260, the
head-on pair split between SolverXPBD and SolverMuJoCo: the velocities
swap, momentum kept within 0.1). The parity cases are in
tests/test_torch_coupled.py.
"""

import os
import sys
from dataclasses import replace

import numpy as np
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phase 53)

torch.set_num_threads(1)

DT = 1.0 / 240.0


def test_coupled_rigid_particle_stable():
    b = nt.ModelBuilder()
    body = b.add_body(xform=[0.25, 0.25, 0.5, 0, 0, 0, 1])
    b.add_shape_sphere(body, radius=0.2)
    b.add_joint_free(body)
    b.add_ground_plane()
    b.add_cloth_grid(pos=(0, 0, 1.0), dim_x=6, dim_y=6, cell_x=0.1,
                     cell_y=0.1, mass=1.0, fix_top=False, tri_ke=500.0)
    m = b.finalize("cpu")
    pipe = nt.CollisionPipeline(m)
    solver = nt.SolverCoupled(m, rigid_solver=nt.SolverXPBD(m, iterations=2),
                              particle_solver=nt.SolverVBD(m, iterations=2))
    s, ctrl = m.state(), m.control()
    for _ in range(60 * 4):
        s = solver.step(s, None, ctrl, pipe.collide(s), DT)
    assert np.isfinite(s.particle_q.numpy()).all()
    assert np.isfinite(s.body_q.numpy()).all()
    assert abs(float(s.body_q[0, 2]) - 0.2) < 0.05


def test_coupled_consensus_momentum_transfer():
    m = cs.particle_blob_scene(nt).finalize("cpu")
    pipe = nt.CollisionPipeline(m)
    solver = nt.SolverCoupled(m, nt.SolverXPBD(m, iterations=2),
                              nt.SolverXPBD(m, iterations=2),
                              consensus_iters=4)
    s = solver.init_state(nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state()))
    mb = float(m.body_mass[0])
    mp = m.particle_mass.numpy()

    def total_pz(s):
        return (mb * float(s.body_qd[0, 2])
                + float(np.sum(mp * s.particle_qd.numpy()[:, 2])))
    M_tot = mb + float(mp.sum())
    p0 = total_pz(s)
    steps = 120
    ctrl = m.control()
    for _ in range(steps):
        s = solver.step(s, None, ctrl, pipe.collide(s), DT)
    expected = p0 - 10.0 * M_tot * steps * DT
    err = abs(total_pz(s) - expected) / abs(expected)
    assert err < 0.05, f"momentum transfer error {err:.3f}"
    res = s.custom["coupled:residuals"].numpy()
    assert res.shape[0] == 4
    assert res[-1] <= res[0] + 1e-6, res


def test_coupled_body_partition_collision():
    m = cs.head_on_pair_scene(nt, 1).finalize("cpu")
    pipe = nt.CollisionPipeline(m)
    solver = nt.SolverCoupled(
        m, rigid_solver=nt.SolverXPBD(m, iterations=4),
        second_rigid_solver=nt.SolverMuJoCo(m, iterations=8),
        body_partition=np.array([True, False]), consensus_iters=1)
    s = m.state()
    qd = torch.zeros(2, 6)
    qd[0, 0], qd[1, 0] = 1.0, -1.0
    jqd = torch.zeros(m.structure.joint_dof_count)
    jqd[0], jqd[6] = 1.0, -1.0
    s = replace(s, body_qd=qd, joint_qd=jqd)
    for _ in range(120 * 4):
        s = solver.step(s, None, None, pipe.collide(s), DT)
    v = s.body_qd.numpy()
    assert np.isfinite(s.body_q.numpy()).all()
    assert v[0, 0] < -0.7 and v[1, 0] > 0.7, v[:, 0]
    assert abs(v[0, 0] + v[1, 0]) < 0.1
