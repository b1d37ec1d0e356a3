"""The MPM slice of the port against the JAX package, on the CPU.

Same inputs, made with numpy from a seed, go through the JAX function and
the port's:
- the transfers: ``p2g_apply_plain``/``g2p_apply_plain`` against the JAX
  Pallas kernels in interpret mode (as tests/test_mpm.py runs them), bases
  past both grid borders included, atol 1e-5;
- ``_svd3``, ``_svd3_jacobi`` and ``_drucker_prager_project``;
- particles through both builders, and the bridge;
- 5 steps of ``SolverImplicitMPM`` at 512 particles and res 16 for every
  material, with and without the CG grid solve, and with the implicit
  rheology, against the JAX default CPU path and (sand, CG) the JAX Pallas
  transfer path. Tolerances, from the spread between the JAX package's own
  two transfer paths on this model (q 3e-8, qd 5.6e-6, F 1.5e-6, C 1.1e-4):
  particle_q 1e-6, particle_qd 1e-4, mpm:F 1e-5, mpm:C 1e-3 absolute.

The ``gpu`` cases hold the CUDA kernels against their plain versions on
the card; JAX is imported lazily, so they also run where JAX is absent::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_mpm.py
"""

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, MODEL_INT_FIELDS
from newton_tpu_torch.solvers import mpm_transfer, solver_mpm
from newton_tpu_torch.utils import bridge

torch.set_num_threads(1)

N, RES, DT, STEPS = 512, 16, 4e-4, 5
SOLVER_KW = dict(grid_lower=(-1, -1, 0), grid_upper=(1, 1, 2),
                 resolution=RES, friction_angle=0.6, young=5e4)
TOL = {"particle_q": 1e-6, "particle_qd": 1e-4, "mpm:F": 1e-5,
       "mpm:C": 1e-3}


def _transfer_inputs(seed, n, res, C):
    """Bases over -2..res (both borders clipped), positive weights."""
    rng = np.random.RandomState(seed)
    base = rng.randint(-2, res + 1, (n, 3)).astype(np.int32)
    base[:4] = [[-2, -1, res - 1], [res, res - 1, -2], [-1, res, 0],
                [res - 1, -2, res]]
    w_ax = np.abs(rng.rand(n, 3, 3)).astype(np.float32)
    vals = rng.randn(n, C).astype(np.float32)
    grid = rng.randn(res, res, res, C).astype(np.float32)
    return base, w_ax, vals, grid


@pytest.mark.parametrize("C", [4, 13])
def test_p2g_plain_matches_pallas(C):
    import jax.numpy as jnp
    from newton_tpu.solvers.mpm_pallas import p2g_apply
    base, w_ax, vals, _ = _transfer_inputs(C, N, RES, C)
    ref = p2g_apply(jnp.asarray(base), jnp.asarray(w_ax), jnp.asarray(vals),
                    RES, chunk=256, interpret=True)
    got = mpm_transfer.p2g_apply(torch.as_tensor(base),
                                 torch.as_tensor(w_ax),
                                 torch.as_tensor(vals), RES)
    assert got.shape == (RES, RES, RES, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("C", [4, 12])
def test_g2p_plain_matches_pallas(C):
    import jax.numpy as jnp
    from newton_tpu.solvers.mpm_pallas import g2p_apply
    base, w_ax, _, grid = _transfer_inputs(100 + C, N, RES, C)
    ref = g2p_apply(jnp.asarray(base), jnp.asarray(w_ax), jnp.asarray(grid),
                    chunk=256, interpret=True)
    got = mpm_transfer.g2p_apply(torch.as_tensor(base),
                                 torch.as_tensor(w_ax),
                                 torch.as_tensor(grid))
    assert got.shape == (N, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_transfers_are_adjoint():
    """<P2G(vals), grid> == <vals, G2P(grid)> in float64: the two
    transfers apply one stencil, border clipping included."""
    base, w_ax, vals, grid = _transfer_inputs(7, 256, 8, 5)
    b, w = torch.as_tensor(base), torch.as_tensor(w_ax).double()
    v, g = torch.as_tensor(vals).double(), torch.as_tensor(grid).double()
    lhs = (mpm_transfer.p2g_apply_plain(b, w, v, 8) * g).sum()
    rhs = (v * mpm_transfer.g2p_apply_plain(b, w, g)).sum()
    assert abs(float(lhs - rhs)) < 1e-9 * float(abs(lhs))


def test_transfer_wrappers_check_inputs():
    base, w_ax, vals, grid = (torch.as_tensor(a)
                              for a in _transfer_inputs(0, 8, 4, 3))
    with pytest.raises(TypeError):
        mpm_transfer.p2g_apply(base.long(), w_ax, vals, 4)
    with pytest.raises(TypeError):
        mpm_transfer.g2p_apply(base, w_ax, grid.double())
    with pytest.raises(ValueError):
        mpm_transfer.p2g_apply(base, w_ax, vals[:5], 4)
    with pytest.raises(ValueError):
        mpm_transfer.g2p_apply(base, w_ax[:, :2], grid)
    with pytest.raises(ValueError):
        mpm_transfer.g2p_apply(base, w_ax, grid[:, :3])


def _deformations(seed, n=256):
    rng = np.random.RandomState(seed)
    F = np.eye(3)[None] + 0.4 * rng.randn(n, 3, 3)
    F[:8] = np.eye(3)                               # the initial state
    F[8] = np.diag([1.2, 0.9, -0.7])                # an inversion
    return F.astype(np.float32)


def test_svd3_matches_jax():
    """torch.linalg.svd with the JAX CPU branch's sign correction: the
    same singular values (sign of det F in the last), proper rotations,
    and the same polar rotation U V^T (the vectors themselves are unique
    only up to paired signs)."""
    import jax.numpy as jnp
    from newton_tpu.solvers.solver_mpm import _svd3
    F = _deformations(0)
    Uj, sj, Vtj = (np.asarray(a) for a in _svd3(jnp.asarray(F)))
    U, s, Vt = (a.numpy() for a in solver_mpm._svd3(torch.as_tensor(F)))
    np.testing.assert_allclose(s, sj, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(U), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Vt), 1.0, atol=1e-5)
    np.testing.assert_allclose(U @ Vt, Uj @ Vtj, atol=1e-4)
    np.testing.assert_allclose((U * s[:, None, :]) @ Vt, F, atol=1e-5)


def test_svd3_jacobi_matches_jax():
    import jax.numpy as jnp
    from newton_tpu.solvers.solver_mpm import _svd3_jacobi
    F = _deformations(1)
    ref = _svd3_jacobi(jnp.asarray(F))
    got = solver_mpm._svd3_jacobi(torch.as_tensor(F))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("cohesion", [0.0, 0.05])
def test_drucker_prager_project_matches_jax(cohesion):
    import jax.numpy as jnp
    from newton_tpu.solvers.solver_mpm import _drucker_prager_project
    rng = np.random.RandomState(2)
    sig = np.exp(0.2 * rng.randn(512, 3)).astype(np.float32)
    sig[:4] = [1.0, 1.0, 1.0]
    ref = _drucker_prager_project(jnp.asarray(sig), 0.6, cohesion)
    got = solver_mpm._drucker_prager_project(torch.as_tensor(sig), 0.6,
                                             cohesion)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=1e-6)


def _particles(b, speed=0.0, seed=0):
    """The sand column of tests/test_mpm.py (at rest unless ``speed``)
    through every particle entry point; particles 0 and 1 are pinned
    (mass 0)."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-0.15, 0.15, (N - 20, 3))
    pts[:, 2] = rng.uniform(0.0, 0.45, N - 20) + 0.05
    b.add_particle((0.0, 0.0, 0.3), (0.0, 0.0, 0.0), 0.0, radius=0.02)
    b.add_particles(pts[:3], mass=[0.0, 0.002, 0.002])
    b.add_particles(pts[3:], vel=speed * rng.randn(N - 23, 3), mass=0.002)
    b.add_particle_grid((0.05, -0.05, 0.5), rot=(0, 0, 0.38268343,
                                                 0.92387953),
                        dim_x=2, dim_y=2, dim_z=2, cell_x=0.02, cell_y=0.02,
                        cell_z=0.02, mass=0.002, jitter=0.005, seed=3)
    for p in pts[:11]:
        b.add_particle(p + 0.01, (0.0, 0.0, -2.0 * speed), 0.002)
    return b


@pytest.fixture(scope="module")
def models():
    """The slice's model, at rest: the C tolerance holds for it. Started
    at ~0.05-0.1 m/s, the JAX package's own two transfer paths already
    differ by ~2e-3 in mpm:C after 5 steps (the APIC recombination's
    cancellation grows with the affine term)."""
    import newton_tpu as jt
    jm = _particles(jt.ModelBuilder()).finalize()
    tm = _particles(nt.ModelBuilder()).finalize("cpu")
    assert tm.particle_count == N
    return jm, tm


def test_particle_leaves_match_jax():
    """Every finalized leaf and structure field of a particle-only model
    with initial velocities: ints and structure equal, floats to 1e-6
    (float64 authoring, one float32 rounding), shapes equal (bodiless
    (0, 3, 3) inertia included)."""
    import newton_tpu as jt
    jm = _particles(jt.ModelBuilder(), speed=0.05).finalize()
    tm = _particles(nt.ModelBuilder(), speed=0.05).finalize("cpu")
    for name in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS:
        a, b = np.asarray(getattr(jm, name)), getattr(tm, name).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0, err_msg=name)
    for name in bridge.STRUCTURE_FIELDS:
        a, b = getattr(jm.structure, name), getattr(tm.structure, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            assert a == b, name
    assert (tm.structure.particle_world == -1).all()
    assert int(tm.particle_flags[0]) == int(nt.ParticleFlags.ACTIVE)
    s = tm.state()
    assert s.particle_f.shape == (N, 3) and not s.particle_f.any()


def test_particle_bridge_round_trip(models):
    """Port Model -> numpy -> Model, and a JAX MPM state (mpm:* custom
    arrays included) -> numpy -> port State -> numpy: exact."""
    jm, tm = models
    back = bridge.model_from_numpy(*bridge.model_to_numpy(tm), "cpu")
    for name in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS:
        assert torch.equal(getattr(back, name), getattr(tm, name)), name
    assert back.particle_count == N
    assert np.array_equal(back.structure.particle_world,
                          tm.structure.particle_world)
    s = _run_jax(jm, dict(SOLVER_KW, material="snow"), "auto", steps=1)
    d = {n: np.asarray(getattr(s, n)) for n in bridge.STATE_FIELDS}
    d["custom"] = {k: np.asarray(v) for k, v in s.custom.items()}
    assert set(d["custom"]) == {"mpm:F", "mpm:C", "mpm:Jp"}
    out = bridge.state_to_numpy(bridge.state_from_numpy(d, "cpu"))
    for n in bridge.STATE_FIELDS:
        np.testing.assert_array_equal(out[n], d[n], err_msg=n)
    for k, v in d["custom"].items():
        np.testing.assert_array_equal(out["custom"][k], v, err_msg=k)


def test_ant_model_has_empty_particles():
    """The robot path keeps working: a model with no particles holds
    (0, 3) particle tensors, and MPM steps on it are the identity."""
    b = nt.ModelBuilder()
    b.add_mjcf(nt.ASSET_DIR + "/ant.xml")
    m = b.finalize("cpu")
    s = m.state()
    assert s.particle_q.shape == (0, 3) and m.particle_mass.shape == (0,)
    assert nt.SolverMPM(m).step(s, None, None, None, DT) is s


MATERIALS = {"sand": {}, "elastic": dict(friction_angle=None),
             "snow": dict(material="snow"),
             "viscous": dict(material="viscous"),
             "mixed": dict(material_id=np.arange(N) % 3)}
CASES = ([(mat, it, "explicit") for mat in MATERIALS for it in (0, 4)]
         + [("sand", 0, "implicit")])


def _run_jax(jm, kw, backend, steps=STEPS):
    import jax
    from newton_tpu.solvers.solver_mpm import SolverImplicitMPM as JSolver
    js = JSolver(jm, **kw)
    if backend == "pallas":
        js.transfer_backend = "pallas"
    step = jax.jit(lambda s: js.step(s, None, None, None, DT))
    s = js.init_state(jm.state())
    for _ in range(steps):
        s = step(s)
    return s


@pytest.mark.parametrize("material, iters, rheology", CASES)
def test_mpm_steps_match_jax(models, material, iters, rheology):
    jm, tm = models
    kw = dict(SOLVER_KW, implicit_iterations=iters, rheology=rheology,
              **MATERIALS[material])
    solver = nt.SolverImplicitMPM(tm, **kw)
    s = solver.init_state(tm.state())
    x0 = s.particle_q.clone()
    for _ in range(STEPS):
        s = solver.step(s, None, None, None, DT)
    backends = ["auto"]
    if material == "sand" and rheology == "explicit" or iters:
        backends.append("pallas")
    for backend in backends:
        ref = _run_jax(jm, kw, backend)
        got = {"particle_q": s.particle_q, "particle_qd": s.particle_qd,
               **s.custom}
        want = {"particle_q": ref.particle_q, "particle_qd": ref.particle_qd,
                **ref.custom}
        assert set(got) == set(want)
        for k, tol in TOL.items():
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=tol, rtol=0,
                                       err_msg=f"{k} vs {backend}")
        for k in set(got) - set(TOL):               # mpm:Jp, mpm:sigma
            w = np.asarray(want[k])
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-3 * max(np.abs(w).max(), 1.0),
                                       err_msg=f"{k} vs {backend}")
    # pinned particles keep their state; the rest moved
    assert torch.equal(s.particle_q[:2], x0[:2])
    assert bool((s.particle_q[2:] != x0[2:]).any(dim=1).all())


gpu = pytest.mark.gpu
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


def _kernel_case(case, C):
    """Transfer operands of one kernel case: random bases over -2..res at
    res 1, 3, 16, 64 and 160 (more tiles than the binning counts in shared
    memory: its global workspace); all particles in one cell; 64 particles
    in each of 64 cells, one cell per tile at its upper edge (the stencils
    reach into the next tiles); no particles; the sand column's bases
    (chip_smoke.py's phase 8 cell: 32768 particles, res 64)."""
    if case.startswith("random res "):
        res = int(case.split()[-1])
        return _transfer_inputs(C, 4096, res, C) + (res,)
    res = 64 if case == "sand" else 16
    n = {"one cell": 4096, "64 per cell": 4096, "empty": 0,
         "sand": 32768}[case]
    base, w_ax, vals, grid = _transfer_inputs(C, max(n, 4), res, C)
    if case == "empty":
        base, w_ax, vals = base[:0], w_ax[:0], vals[:0]
    elif case == "one cell":
        base[:] = (5, 6, 7)
    elif case == "64 per cell":
        cells = np.stack(np.meshgrid(*[np.arange(3, 16, 4)] * 3,
                                     indexing="ij"), -1).reshape(-1, 3)
        base = np.repeat(cells, 64, axis=0).astype(np.int32)
    elif case == "sand":
        rng = np.random.RandomState(0)
        pts = rng.uniform(-0.3, 0.3, (n, 3))
        pts[:, 2] = rng.uniform(0.05, 0.8, n)
        xp = (pts - np.array([-1.0, -1.0, 0.0])) * (res / 2.0)
        base = np.floor(xp - 0.5).astype(np.int32)
    return base, w_ax, vals, grid, res


KERNEL_CASES = ["random res 1", "random res 3", "random res 16",
                "random res 64", "random res 160", "one cell", "64 per cell",
                "empty", "sand"]


@gpu
@needs_cuda
@pytest.mark.parametrize("case", KERNEL_CASES)
@pytest.mark.parametrize("C", [4, 12, 13])
def test_transfer_kernels_match_plain(C, case):
    """Kernels vs their plain versions against a float64 plain result:
    |err| <= 1e-5 * S + 1e-7, S the float64 sum of magnitudes (P2G's
    shared-memory atomics reorder each node's sum), with the bins computed
    once and passed, and without; no particles give an all-zero grid.
    G2P sums in a fixed order: two calls agree bit for bit."""
    *arrays, res = _kernel_case(case, C)
    base, w_ax, vals, grid = (torch.as_tensor(a, device="cuda")
                              for a in arrays)
    w64 = w_ax.double()
    before = (mpm_transfer.p2g_apply.launches,
              mpm_transfer.g2p_apply.launches,
              mpm_transfer.bin_particles.launches)
    bins = mpm_transfer.bin_particles(base, res)
    G = mpm_transfer.p2g_apply(base, w_ax, vals, res, bins=bins)
    P = mpm_transfer.g2p_apply(base, w_ax, grid, bins=bins)
    G_self = mpm_transfer.p2g_apply(base, w_ax, vals, res)
    P_self = mpm_transfer.g2p_apply(base, w_ax, grid)
    torch.cuda.synchronize()
    assert (mpm_transfer.p2g_apply.launches,
            mpm_transfer.g2p_apply.launches,
            mpm_transfer.bin_particles.launches) == (before[0] + 2,
                                                     before[1] + 2,
                                                     before[2] + 3)
    assert G.shape == (res, res, res, C) and P.shape == (base.shape[0], C)
    assert torch.equal(P, P_self)
    if case == "empty":
        assert not G.any() and not G_self.any()
    ref_G = mpm_transfer.p2g_apply_plain(base, w64, vals.double(), res)
    S_G = mpm_transfer.p2g_apply_plain(base, w64, vals.double().abs(), res)
    ref_P = mpm_transfer.g2p_apply_plain(base, w64, grid.double())
    S_P = mpm_transfer.g2p_apply_plain(base, w64, grid.double().abs())
    for got, ref, S in ((G, ref_G, S_G), (G_self, ref_G, S_G),
                        (P, ref_P, S_P),
                        (mpm_transfer.p2g_apply_plain(base, w_ax, vals, res),
                         ref_G, S_G),
                        (mpm_transfer.g2p_apply_plain(base, w_ax, grid),
                         ref_P, S_P)):
        assert bool(((got.double() - ref).abs() <= 1e-5 * S + 1e-7).all())
    if res > 1:                         # a strided grid is refused
        with pytest.raises(ValueError):
            mpm_transfer.g2p_apply(base, w_ax, grid.transpose(0, 1))


@gpu
@needs_cuda
@pytest.mark.parametrize("case", KERNEL_CASES)
def test_bin_kernel_matches_plain(case):
    """The counting-sort kernels give the plain binning's offsets, tile
    list and slots exactly, and the same particles in each tile (their
    order inside a tile follows the atomics)."""
    base, *_, res = _kernel_case(case, 4)
    base = torch.as_tensor(base, device="cuda")
    got = mpm_transfer.bin_particles(base, res)
    ref = mpm_transfer.bin_particles_plain(base, res)
    assert got.meta.shape == ref.meta.shape     # one layout in both
    for name in ("offsets", "slot_of", "records"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    off = ref.offsets.tolist()
    for t in ref.active.tolist():
        a, b = off[t], off[t + 1]
        ga = got.sorted[a:b][torch.argsort(got.perm[a:b])]
        assert torch.equal(ga, ref.sorted[a:b])
