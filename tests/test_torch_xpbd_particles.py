"""``SolverXPBD``'s particle path in the port against the JAX package on
the CPU: the bench cloth's grid at 20 x 20 (springs of the triangle
edges), the two overlapping layers with particle-particle contacts
through the hash grid, the granular grid on the ground, particle-shape
contacts at rest and on a moving kinematic belt, and a soft grid
(tetrahedra) with springs and a pinned face; the JAX package's gates of
tests/test_cloth_solvers.py:109, 229, 287 and 316 on the port; the hash
grid's dropped candidates counted. On a CUDA card: the self-collision
substep on the card against the CPU, and two card runs of it bit for bit.

Tolerances: particle_q atol = rtol = 1e-4 after a few substeps,
particle_qd 5e-3 (tests/test_batched_step.py:69-75); the gates are the
JAX tests'.

JAX is imported inside the tests, so the GPU cases collect where JAX is
absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_xpbd_particles.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.geometry.hashgrid import HashGrid

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 40-42)
from test_torch_free_bodies import _pair, _port_state  # noqa: E402

torch.set_num_threads(1)

DT = 1.0 / 240.0
QTOL, QDTOL = 1e-4, 5e-3
gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _compare(make, substeps, pipe=False, dt=DT, **kw):
    """``substeps`` XPBD substeps of ``make(lib)`` on both packages from
    the model's state (collide each substep with ``pipe``), particle_q and
    particle_qd held at every substep; returns the port's model, solver
    and state."""
    import jax
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverXPBD as JXPBD
    jm, tm = _pair(make)
    jsol, tsol = JXPBD(jm, **kw), nt.SolverXPBD(tm, **kw)
    jp = JPipe(jm) if pipe else None
    tp = nt.CollisionPipeline(tm) if pipe else None
    step = jax.jit(lambda s: jsol.step(s, None, None,
                                       jp.collide(s) if pipe else None, dt))
    jst = jm.state()
    tst = _port_state(jst)
    for k in range(substeps):
        jst = step(jst)
        tst = tsol.step(tst, None, None, tp.collide(tst) if pipe else None,
                        dt)
        for name, tol in (("particle_q", QTOL), ("particle_qd", QDTOL),
                          ("body_q", QTOL)):
            np.testing.assert_allclose(
                getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
                atol=tol, rtol=tol, err_msg=f"{name}, substep {k}")
    return tm, tsol, tst


def _run(model, solver, state, substeps, pipe=None, dt=DT):
    for _ in range(substeps):
        state = solver.step(state, None, None,
                            None if pipe is None else pipe.collide(state),
                            dt)
    return state


def test_xpbd_cloth_matches_jax():
    """The bench cloth's grid (pinned top row, tri_ke 500) at 20 x 20
    under SolverXPBD(iterations=4, enable_particle_particle=False): 8
    substeps against the JAX package; the pinned row stays in place."""
    tm, _, s = _compare(lambda lib: cs.cloth_bench_scene(lib, 20), 8,
                        iterations=4, enable_particle_particle=False)
    fixed = tm.particle_inv_mass == 0
    assert torch.equal(s.particle_q[fixed], tm.particle_q[fixed])


def test_self_collision_matches_jax_and_separates_layers():
    """tests/test_cloth_solvers.py:109: the two overlapping layers (radius
    0.03, gap 0.004) under SolverXPBD(iterations=4) with particle-particle
    contacts: 8 substeps against the JAX package, then the JAX test's gate
    on the port after its 40 substeps (separation above 0.025), with no
    candidate beyond the grid's budget."""
    tm, solver, s = _compare(lambda lib: cs.layers_scene(lib, 4), 8,
                             iterations=4)
    s = _run(tm, solver, s, 32)
    assert bool(torch.isfinite(s.particle_q).all())
    n = s.particle_q.shape[0] // 2
    d = torch.cdist(s.particle_q[:n], s.particle_q[n:],
                    compute_mode="donot_use_mm_for_euclid_dist")
    assert float(d.min()) > 0.025
    assert int(s.custom["xpbd:grid_overflow"].sum()) == 0


def test_granular_matches_jax_and_holds():
    """tests/test_cloth_solvers.py:229: a 3 x 3 x 3 particle grid (radius
    0.05) on the ground under SolverXPBD(iterations=3) with soft contacts:
    8 substeps against the JAX package; after the JAX test's 360 substeps
    on the port, every particle above z = 0.03 and no two closer than
    0.085."""
    tm, solver, s = _compare(lambda lib: cs.granular_scene(lib, (3, 3, 3)),
                             8, pipe=True, iterations=3)
    s = _run(tm, solver, s, 352, nt.CollisionPipeline(tm))
    q = s.particle_q
    assert bool(torch.isfinite(q).all())
    assert float(q[:, 2].min()) > 0.03
    d = torch.cdist(q, q, compute_mode="donot_use_mm_for_euclid_dist")
    d.fill_diagonal_(1.0)
    assert float(d.min()) > 0.085


def _two_particles(lib):
    b = lib.ModelBuilder(gravity=-9.81)
    b.add_particle([0, 0, 0.3], mass=0.02, radius=0.05)
    b.add_particle([1, 0, 0.3], mass=2.0, radius=0.05)
    b.add_ground_plane()
    return b


def test_particle_shape_rest_is_mass_independent():
    """tests/test_cloth_solvers.py:287: a light and a heavy particle
    dropped on the ground: 16 substeps against the JAX package; after the
    JAX test's 360 substeps both rest at z = 0.05 (5e-3)."""
    tm, solver, s = _compare(_two_particles, 16, pipe=True, iterations=4)
    s = _run(tm, solver, s, 344, nt.CollisionPipeline(tm))
    np.testing.assert_allclose(s.particle_q[:, 2].numpy(), 0.05, atol=5e-3)


def _belt_particles(lib):
    b = lib.ModelBuilder(gravity=-9.81)
    cfg = b.default_shape_cfg.copy()
    cfg.mu = 0.8
    belt = b.add_body(xform=[0, 0, 0.05, 0, 0, 0, 1],
                      qd=np.array([0.5, 0, 0, 0, 0, 0]), kinematic=True)
    b.add_shape_box(belt, hx=2.0, hy=0.5, hz=0.05, cfg=cfg)
    b.add_particle([0, 0, 0.18], mass=0.05, radius=0.05)
    return b


def test_particle_shape_friction_follows_surface():
    """tests/test_cloth_solvers.py:316: a particle dropped on a kinematic
    belt moving at 0.5 m/s: 16 substeps against the JAX package (the belt
    moves too); after the JAX test's 480 substeps the particle moves with
    the belt (|vx - 0.5| < 0.05) and has travelled past x = 0.7."""
    tm, solver, s = _compare(_belt_particles, 16, pipe=True, iterations=4)
    s = _run(tm, solver, s, 464, nt.CollisionPipeline(tm))
    assert abs(float(s.particle_qd[0, 0]) - 0.5) < 0.05
    assert float(s.particle_q[0, 0]) > 0.7


def _soft_scene(lib):
    b = lib.ModelBuilder()
    b.add_soft_grid(pos=(0, 0, 0.3), rot=(0, 0, 0, 1), vel=(0, 0, 0),
                    dim_x=3, dim_y=2, dim_z=2, cell_x=0.1, cell_y=0.1,
                    cell_z=0.1, density=100.0, k_mu=1e3, k_lambda=1e3,
                    fix_left=True)
    b.add_spring(0, 11, ke=200.0)
    b.add_ground_plane()
    return b


def test_soft_grid_and_springs_match_jax():
    """A soft grid of 3 x 2 x 2 cells (tetrahedra: a volume row and six
    edge rows each, the builder's default 1e3 material) pinned on its left
    face, with one spring, under SolverXPBD(iterations=4): 16 substeps
    against the JAX package; the pinned particles stay in place. (At 1e4
    the JAX package's block is itself sensitive: a 1e-7 nudge of one
    particle moves its velocities by 2e-3 within 8 substeps.)"""
    tm, _, s = _compare(_soft_scene, 16, pipe=True, iterations=4)
    fixed = tm.particle_inv_mass == 0
    assert bool(fixed.any())
    assert torch.equal(s.particle_q[fixed], tm.particle_q[fixed])


def test_hash_grid_counts_dropped_candidates():
    """Particles packed four to a cell with a budget of two: the query
    keeps two candidates from each of a particle's 27 cells and counts
    every other particle whose hash matches there; with a budget above the
    packing nothing is dropped and the neighbours within the radius are
    exactly the brute-force ones."""
    rng = np.random.RandomState(0)
    cells = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
    x = (np.repeat(cells, 4, 0) + 0.25 + 0.5 * rng.rand(108, 3)) * 0.1
    x = torch.as_tensor(x, dtype=torch.float32)
    grid = HashGrid(cell_size=0.1, max_per_cell=2)
    h_sorted, _ = grid.build(x)
    _, _, over = grid.query(x, 0.1, count_overflow=True)
    nbr = grid._hash(grid._cell(x)[:, None, :] + torch.as_tensor(
        [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
         for k in (-1, 0, 1)]))                                # (N, 27)
    held = (h_sorted[None, None, :] == nbr[..., None]).sum(-1)
    np.testing.assert_array_equal(over.numpy(),
                                  (held - 2).clamp(min=0).sum(1).numpy())
    assert int(over.sum()) > 0
    wide = HashGrid(cell_size=0.1, max_per_cell=8)
    idx, mask, over = wide.query(x, 0.1, count_overflow=True)
    assert int(over.sum()) == 0
    d = torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist")
    brute = (d < 0.1) & ~torch.eye(108, dtype=torch.bool)
    got = torch.zeros_like(brute)
    got[torch.arange(108)[:, None].expand_as(idx)[mask], idx[mask]] = True
    assert torch.equal(got, brute)


def test_jax_hash_grid_drops_candidates_without_a_count():
    """ROADMAP C.25: the JAX package's hash grid keeps at most
    ``max_per_cell`` candidates (4 by default) of each of a particle's 27
    hashed cells and drops the rest without a word, real contacts among
    them where hash collisions crowd a bucket (32,768 particles in the
    default 65,536-entry table). The port returns the same candidates and
    masks, bit for bit, and counts what it drops; with a budget of 16
    nothing is dropped and every pair within the radius is found."""
    import jax.numpy as jnp
    from newton_tpu.geometry.hashgrid import HashGrid as JGrid
    rng = np.random.RandomState(0)
    x = torch.as_tensor(rng.uniform(0.0, 1.6, (16384, 3)), dtype=torch.float32)
    r = 0.05
    jidx, jmask = JGrid(cell_size=r, max_per_cell=4).query(
        jnp.asarray(x.numpy()), r)
    idx, mask, over = HashGrid(cell_size=r, max_per_cell=4).query(
        x, r, count_overflow=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    def pairs(idx, mask):
        """The distinct (particle, neighbour) pairs of a query (a bucket
        that two of the 27 cells hash to is gathered twice)."""
        rows = torch.arange(idx.shape[0])[:, None].expand_as(idx)
        return int(torch.unique(rows[mask] * idx.shape[0] + idx[mask])
                   .numel())
    found = pairs(idx, mask)
    brute = 0
    for i in range(0, 16384, 1024):
        d = torch.cdist(x[i:i + 1024], x,
                        compute_mode="donot_use_mm_for_euclid_dist")
        brute += int((d < r).sum()) - min(1024, 16384 - i)
    assert found < brute and int(over.sum()) > 0
    idx16, mask16, over16 = HashGrid(cell_size=r, max_per_cell=16).query(
        x, r, count_overflow=True)
    assert int(over16.sum()) == 0 and pairs(idx16, mask16) == brute


def test_soft_contacts_take_the_static_slots():
    """The particle sums read the static pipeline's soft slots: Contacts
    whose soft particles differ raise, naming the field."""
    model = cs.granular_scene(nt, (2, 2, 1)).finalize("cpu")
    solver = nt.SolverXPBD(model)
    s = model.state()
    c = nt.CollisionPipeline(model).collide(s)
    c.slots = None
    c.soft_contact_particle = c.soft_contact_particle.flip(0)
    with pytest.raises(ValueError, match="soft_contact_particle"):
        solver.step(s, None, None, c, DT)


@gpu
def test_self_collision_on_card_matches_cpu(cuda):
    """The two layers at 20 x 20 cells: 4 substeps on the card against the
    CPU (1e-4 / 5e-3) and two card runs of a substep bit for bit."""
    out = {}
    for dev in (cuda, "cpu"):
        m = cs.layers_scene(nt, 20).finalize(dev)
        solver = nt.SolverXPBD(m, iterations=4)
        s = _run(m, solver, m.state(), 4)
        out[str(dev)] = s
        if dev != "cpu":
            a = solver.step(s, None, None, None, DT)
            b = solver.step(s, None, None, None, DT)
            assert torch.equal(a.particle_q, b.particle_q)
            assert torch.equal(a.particle_qd, b.particle_qd)
    for name, tol in (("particle_q", QTOL), ("particle_qd", QDTOL)):
        np.testing.assert_allclose(getattr(out[str(cuda)], name).cpu(),
                                   getattr(out["cpu"], name), atol=tol,
                                   rtol=tol)
