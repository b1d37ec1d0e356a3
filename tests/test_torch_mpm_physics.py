"""The MPM physics gates of tests/test_mpm.py on the port, at the same
sizes, steps and gates, on the CPU (the port's ``SolverImplicitMPM`` with
its plain transfers): the angle of repose (test_mpm.py:68), the elastic
bounce (:111) and the implicit CG extending the stable dt (:131); the
material family (:173) is in test_torch_mpm_materials.py. They need no
JAX.
"""

import numpy as np
import torch

import newton_tpu_torch as nt

torch.set_num_threads(1)


def _sand_model(n=768, seed=0):
    """The JAX test's sand column: n particles of 2 g, uniform in
    [-0.15, 0.15]^2 x [0.05, 0.5]."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.15, 0.15, (n, 3))
    pts[:, 2] = rng.uniform(0.0, 0.45, n) + 0.05
    b = nt.ModelBuilder()
    b.add_particles(pts, vel=np.zeros((n, 3)), mass=np.full(n, 0.002))
    return b.finalize("cpu")


def _run(solver, s, steps, dt):
    for _ in range(steps):
        s = solver.step(s, None, None, None, dt)
    return s


def test_sand_angle_of_repose():
    """A sand column collapses into a pile whose slope does not exceed the
    Drucker-Prager friction angle: 2000 steps of 4e-4 s at res 24."""
    m = _sand_model()
    phi = 0.6     # ~34 degrees
    solver = nt.SolverImplicitMPM(m, grid_lower=(-1, -1, 0),
                                  grid_upper=(1, 1, 2), resolution=24,
                                  friction_angle=phi, young=5e4)
    s = _run(solver, solver.init_state(m.state()), 2000, 4e-4)
    q = s.particle_q.numpy()
    assert np.isfinite(q).all()
    speed = np.abs(s.particle_qd.numpy()).max()
    assert speed < 1.0, f"sand still moving at {speed}"
    r = np.sqrt(q[:, 0] ** 2 + q[:, 1] ** 2)
    h = q[:, 2]
    assert h.max() < 0.55, f"pile did not collapse: h={h.max()}"
    assert np.percentile(r, 95) > 0.2, "pile did not spread"
    surf = []
    for r0 in np.linspace(0.05, np.percentile(r, 98), 8):
        mask = np.abs(r - r0) < 0.04
        if mask.sum() > 10:
            surf.append((r0, np.percentile(h[mask], 95)))
    surf = np.array(surf)
    slopes = -np.diff(surf[:, 1]) / np.diff(surf[:, 0])
    assert slopes.max() < np.tan(phi) + 0.7, \
        f"slope {slopes.max()} vs tan(phi)={np.tan(phi):.2f}"


def test_elastic_blob_bounces_and_conserves():
    """An elastic blob (no friction angle) stays finite and nothing
    tunnels through the floor over 250 steps."""
    m = _sand_model(512)
    solver = nt.SolverImplicitMPM(m, grid_lower=(-1, -1, 0),
                                  grid_upper=(1, 1, 2), resolution=24,
                                  friction_angle=None, young=2e4)
    s = _run(solver, solver.init_state(m.state()), 250, 4e-4)
    q = s.particle_q.numpy()
    assert np.isfinite(q).all()
    assert (q[:, 2] > -0.01).all()


def test_implicit_grid_solve_extends_stable_dt():
    """The semi-implicit CG grid solve: sand at 8x the explicit-stable dt
    settles under the implicit solver while the explicit update blows up;
    an elastic blob at 4x dt goes from non-finite to stable (150 steps)."""
    def run(cg_iters, dt, phi):
        m = _sand_model(512)
        solver = nt.SolverImplicitMPM(
            m, grid_lower=(-1, -1, 0), grid_upper=(1, 1, 2), resolution=24,
            friction_angle=phi, young=2e5, implicit_iterations=cg_iters)
        s = _run(solver, solver.init_state(m.state()), 150, dt)
        q, v = s.particle_q.numpy(), s.particle_qd.numpy()
        ok = np.isfinite(q).all() and np.isfinite(v).all()
        return (np.abs(v).max() if ok else np.inf), ok

    v_im, ok_im = run(15, 3.2e-3, 0.6)
    assert ok_im and v_im < 0.5, f"implicit sand not settled: {v_im}"
    v_ex, ok_ex = run(0, 3.2e-3, 0.6)
    assert (not ok_ex) or v_ex > 5.0, \
        f"explicit sand unexpectedly stable at 8x dt (vmax={v_ex})"
    v_im, ok_im = run(15, 1.6e-3, None)
    assert ok_im and v_im < 0.5, f"implicit elastic not stable: {v_im}"
    v_ex, ok_ex = run(0, 1.6e-3, None)
    assert not ok_ex, "explicit elastic unexpectedly finite at 4x dt"
