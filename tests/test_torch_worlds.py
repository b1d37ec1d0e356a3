"""Replicated worlds and the per-step ``SolverMuJoCo.step`` entry of the
port, against the JAX package on the CPU, and the kernel instances that
every shape takes.

Tolerances: the builder's leaves and candidate pairs are equal; FK and
contacts 1e-5 (float32 transform chains); ``step`` joint_q/body_q
atol = rtol = 2e-4 and joint_qd 5e-3 (tests/test_batched_step.py:69-75),
per substep and over the short rollouts here; the port's ``step`` against
its own ``step_batched`` 1e-6 (the same operations on gathered operands).

The JAX package's ``replicate`` does not carry the sub-builder's MJCF
actuation tables (``mjc_actuation``) into the replicated model, so a JAX
step ignores ``mjc:ctrl`` there; these tests give the JAX builder the
tables of its N worlds (each world's actuators on that world's dofs)
before it finalizes, which is what the port's ``replicate`` builds.

JAX is imported inside the fixtures and tests, so the GPU cases collect
where JAX is absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_worlds.py
"""

import os

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.solvers.generalized import linalg, pgs

torch.set_num_threads(1)

DT = 1.0 / 240.0
ANT = os.path.join(nt.ASSET_DIR, "ant.xml")
HUMANOID = os.path.join(nt.ASSET_DIR, "humanoid.xml")
CARTPOLE = os.path.join(nt.ASSET_DIR, "inverted_pendulum.xml")

gpu = pytest.mark.gpu
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


# ----------------------------------------------------------------------
# kernel instances: the Python mirrors on the CPU, the kernels on the card
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d, inst", [
    (1, "reg8"), (2, "reg8"), (14, "reg14"), (15, "reg16"), (23, "reg23"),
    (25, "reg32"), (32, "reg32"), (33, "generic_smem"),
    (45, "generic_smem"), (169, "generic_smem"), (170, "generic_global"),
    (200, "generic_global")])
def test_chol_kernel_instance(d, inst):
    """The cartpole's d = 2 runs in the 8-row register instance, the
    humanoid's 23 in its own; every d > 32 has the generic instance, in
    shared memory up to d = 169 and in global scratch beyond."""
    assert linalg.kernel_instance(d) == inst


@pytest.mark.parametrize("shape, inst", [
    ((25, 8, 14), "reg16"), ((32, 17, 23), "reg24"),
    ((192, 17, 23), "smem256"), ((32, 39, 45), "smem256"),
    ((1, 0, 3), "smem128"), ((192, 40, 48), "global256"),
    ((0, 5, 241), "global128")])
def test_pgs_kernel_instance(shape, inst):
    """The ant and humanoid shapes take the register path, the chain of
    phase C.1 (c, nl, d) = (32, 39, 45) the shared-memory path, and a
    block state above 227 KB the global-scratch instance."""
    assert pgs.kernel_instance(*shape) == inst
    assert (pgs.smem_bytes(*shape) > 227 * 1024) == inst.startswith("global")
    assert (pgs.scratch_floats(*shape) > 0) == inst.startswith("global")


def _spd(rng, W, d):
    A = rng.randn(W, d, d).astype(np.float32)
    return (A @ np.transpose(A, (0, 2, 1))
            + 2.0 * np.eye(d, dtype=np.float32)).astype(np.float32)


def _pgs_inputs(seed, c, nl, d, W, dev):
    rng = np.random.RandomState(seed)
    r = 3 * c + 2 * nl
    Minv = rng.randn(d, d)
    Minv = (Minv @ Minv.T + np.eye(d)).astype(np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float32),
                               device=dev)
    return [t(rng.randn(W, 3 * c, d)), t(np.broadcast_to(Minv, (W, d, d))),
            t(rng.randn(W, d)), t(np.abs(rng.randn(W, r))),
            t(rng.rand(W, r) > 0.3), t(np.abs(rng.rand(W, c))),
            t(np.zeros((W, r)))]


@gpu
@needs_cuda
@pytest.mark.parametrize("d, W", [(33, 4097), (45, 1024), (170, 64)])
def test_chol_generic_kernel_matches_plain(d, W):
    """The generic instance in shared memory (d = 33, 45) and in global
    scratch (d = 170) is bit for bit the plain version: the same
    correctly rounded divisions and square roots, products rounded before
    each subtraction, in the same order."""
    rng = np.random.RandomState(d)
    Mi = torch.as_tensor(_spd(rng, W, d), device="cuda")
    rhs = torch.as_tensor(rng.randn(W, d).astype(np.float32), device="cuda")
    before = linalg.chol_inv_solve.launches
    minv_k, x_k = linalg.chol_inv_solve(Mi, rhs)
    torch.cuda.synchronize()
    assert linalg.chol_inv_solve.launches == before + 1
    minv_p, x_p = linalg.chol_inv_solve_plain(Mi, rhs)
    assert torch.equal(minv_k, minv_p) and torch.equal(x_k, x_p)


@gpu
@needs_cuda
@pytest.mark.parametrize("c, nl, d, use_cone, W", [
    (192, 40, 48, False, 512), (192, 40, 48, True, 512),
    (0, 5, 241, False, 64)])
def test_pgs_global_kernel_matches_plain(c, nl, d, use_cone, W):
    """Block states above 227 KB (264 KB and 252 KB) in global scratch,
    within the tolerances of tests/test_torch_kernels.py; envs whose
    divergence-guard halvings differ are counted and left out."""
    args = _pgs_inputs(nl + d, c, nl, d, W, "cuda")
    kw = dict(c=c, ld=torch.arange(d - nl, d, dtype=torch.int32,
                                   device="cuda"),
              iters=8, omega=0.8, use_cone=use_cone, diag_scale=1.0,
              reg=1e-3, return_halvings=True)
    before = pgs.pgs_solve_fused.launches
    lam_k, dqd_k, h_k = pgs.pgs_solve_fused(*args, **kw)
    torch.cuda.synchronize()
    assert pgs.pgs_solve_fused.launches == before + 1
    lam_p, dqd_p, h_p = pgs.pgs_solve_fused_plain(*args, **kw)
    same = h_k == h_p
    assert int((~same).sum()) <= max(W // 1000, 1)
    torch.testing.assert_close(lam_k[same], lam_p[same], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(dqd_k[same], dqd_p[same], atol=1e-3,
                               rtol=1e-3)


@gpu
@needs_cuda
def test_kernel_instance_mirrors_match_library():
    """linalg.kernel_instance and pgs.kernel_instance (and the byte and
    scratch counts behind them) give what the kernels choose, and every
    instance reports its registers and occupancy."""
    import ctypes
    from newton_tpu_torch import _kernels
    lib = _kernels.lib()
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    for d in (1, 2, 8, 9, 14, 15, 23, 24, 25, 32, 33, 45, 169, 170, 200):
        assert lib.chol_kernel_instance(d) == \
            linalg.INSTANCE_CODES[linalg.kernel_instance(d)], d
        want = (linalg.generic_floats(d)
                if linalg.kernel_instance(d) == "generic_global" else 0)
        assert lib.chol_scratch_floats(d) == want, d
        _kernels.check(lib.chol_kernel_info(d, ctypes.addressof(regs),
                                            ctypes.addressof(blocks)), "B1")
        assert blocks.value >= 1, d
    for shape in ((25, 8, 14), (32, 17, 23), (192, 17, 23), (32, 39, 45),
                  (1, 0, 3), (0, 1, 1), (192, 40, 48), (0, 5, 241),
                  (16, 32, 24), (33, 0, 24), (8, 8, 12)):
        assert lib.pgs_kernel_instance(*shape) == \
            pgs.INSTANCE_CODES[pgs.kernel_instance(*shape)], shape
        assert lib.pgs_smem_bytes(*shape) == pgs.smem_bytes(*shape), shape
        assert lib.pgs_scratch_floats(*shape) == \
            pgs.scratch_floats(*shape), shape
        _kernels.check(lib.pgs_kernel_info(*shape, ctypes.addressof(regs),
                                           ctypes.addressof(blocks)), "B2")
        assert blocks.value >= 1, shape


# ----------------------------------------------------------------------
# the JAX side, imported inside fixtures
# ----------------------------------------------------------------------
def _jax_model_to_numpy(jm):
    """The JAX Model's leaves and structure as the bridge takes them."""
    from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, \
        MODEL_INT_FIELDS
    from newton_tpu_torch.utils import bridge
    leaves = {n: np.asarray(getattr(jm, n))
              for n in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS}
    leaves["custom"] = {k: np.asarray(v) for k, v in jm.custom.items()}
    st = jm.structure
    structure = {n: getattr(st, n) for n in bridge.STRUCTURE_FIELDS}
    au = st.mjc_actuation
    structure["mjc_actuation"] = None if au is None else {
        n: getattr(au, n) for n in bridge.ACTUATION_FIELDS}
    structure["custom_specs"] = {
        k: dict(frequency=s.frequency.value, assignment=s.assignment.value,
                shape=s.shape, default=s.default)
        for k, s in st.custom_specs.items()}
    return leaves, structure


def _tiled_actuation(robot, n):
    """The JAX robot builder's actuator tables for n replicated worlds,
    world i's actuators on world i's dofs and coordinates: what the JAX
    ``replicate`` leaves out and the port's carries."""
    from newton_tpu.solvers.generalized.actuation import MJCActuation
    au = robot.mjc_actuation
    out = MJCActuation(au.n * n)
    for name in ("gear", "dyntype", "dynprm", "gaintype", "gainprm",
                 "biastype", "biasprm", "ctrlrange", "forcerange",
                 "actrange", "ctrllimited", "forcelimited", "actlimited",
                 "lengthrange", "acc0"):
        a = np.asarray(getattr(au, name))
        setattr(out, name, np.tile(a, (n,) + (1,) * (a.ndim - 1)))
    for name, stride in (("dof", robot.joint_dof_count),
                         ("coord", robot.joint_coord_count)):
        a = np.asarray(getattr(au, name))
        setattr(out, name, (a[None] + stride * np.arange(n)[:, None])
                .reshape(-1).astype(np.int32))
    out.tendon = -np.ones(au.n * n, np.int32)
    out.sten = -np.ones(au.n * n, np.int32)
    return out.finish()


class _Pair:
    """A replicated scene on both sides: the JAX model (with its worlds'
    actuator tables), its solver and jitted step/collide, and the port's
    model built by the port's own builder, with its solver and pipeline."""

    def __init__(self, xml, n, iterations=8, **kw):
        import jax
        import newton_tpu as jt
        from newton_tpu.sim.collide import CollisionPipeline as JPipe
        from newton_tpu.solvers import SolverMuJoCo as JSolver
        jr = jt.ModelBuilder()
        jr.add_mjcf(xml)
        jb = jt.ModelBuilder()
        jb.replicate(jr, n)
        jb.mjc_actuation = _tiled_actuation(jr, n)
        self.jm = jb.finalize()
        self.js = JSolver(self.jm, iterations=iterations, integrator="euler",
                          **kw)
        self.jpipe = JPipe(self.jm)
        self.j_step = jax.jit(
            lambda s, c, ct: self.js.step(s, None, c, ct, DT))
        self.j_collide = jax.jit(self.jpipe.collide)
        tr = nt.ModelBuilder()
        tr.add_mjcf(xml)
        tb = nt.ModelBuilder()
        tb.replicate(tr, n)
        self.tm = tb.finalize("cpu")
        self.ts = nt.SolverMuJoCo(self.tm, iterations=iterations,
                                  integrator="euler", **kw)
        self.tpipe = nt.CollisionPipeline(self.tm)
        self.n = n

    def states(self, q, qd):
        """The same flat state on both sides (FK of each package)."""
        import jax.numpy as jnp
        from newton_tpu.sim.articulation import eval_fk as j_eval_fk
        js = j_eval_fk(self.jm, jnp.asarray(q), jnp.asarray(qd),
                       self.jm.state())
        ts = nt.eval_fk(self.tm, torch.as_tensor(q), torch.as_tensor(qd),
                        self.tm.state())
        return js, ts

    def controls(self, ctrl):
        import jax.numpy as jnp
        jc = self.jm.control()
        jc = jc.replace(custom={**jc.custom, "mjc:ctrl": jnp.asarray(ctrl)})
        tc = self.tm.control()
        tc.custom["mjc:ctrl"] = torch.as_tensor(ctrl)
        return jc, tc


def _assert_states(got, ref, q_atol=2e-4, qd_atol=5e-3):
    """joint_q/body_q atol = rtol = 2e-4, joint_qd 5e-3
    (tests/test_batched_step.py:69-75)."""
    np.testing.assert_allclose(got.joint_q.numpy(), np.asarray(ref.joint_q),
                               atol=q_atol, rtol=q_atol)
    np.testing.assert_allclose(got.joint_qd.numpy(),
                               np.asarray(ref.joint_qd), atol=qd_atol,
                               rtol=qd_atol)
    np.testing.assert_allclose(got.body_q.numpy(), np.asarray(ref.body_q),
                               atol=q_atol, rtol=q_atol)


# ----------------------------------------------------------------------
# builder: world leaves, candidate pairs and slots
# ----------------------------------------------------------------------
WORLD_LEAVES = ("world_count", "body_world", "shape_world", "joint_world",
                "articulation_world", "candidate_pairs",
                "candidate_pair_slots", "rigid_contact_max",
                "joint_parent_joint", "articulation_start", "joint_q_start",
                "joint_qd_start", "slot_body0", "slot_body1")


def _scene(lib, how):
    """One scene built the same way with either package's builder."""
    robot = lib.ModelBuilder()
    robot.add_mjcf(HUMANOID if how == "replicate humanoid" else ANT)
    b = lib.ModelBuilder()
    if how.startswith("replicate"):
        b.replicate(robot, 3)
    elif how == "begin_world":
        b.begin_world()
        b.add_builder(robot)
        b.end_world()
        b.begin_world(gravity=(0.0, 0.0, -3.0))
        b.add_builder(robot)
        b.end_world()
    else:                       # add_world beside a world -1 ground plane
        b.add_ground_plane()
        b.add_world(robot)
        b.add_world(robot)
    return b


@pytest.mark.parametrize("how", ["replicate", "replicate humanoid",
                                 "begin_world", "add_world"])
def test_world_leaves_match_jax(how):
    """``replicate``, ``begin_world`` + ``add_builder`` (one world with its
    own gravity) and ``add_world`` beside a global ground plane: the world
    leaves, the candidate pairs (never across worlds; world -1 meets every
    world) and their slots equal the JAX builder's, and the float leaves
    too."""
    import newton_tpu as jt
    from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS
    jm = _scene(jt, how).finalize()
    tm = _scene(nt, how).finalize("cpu")
    for name in WORLD_LEAVES:
        np.testing.assert_array_equal(
            np.asarray(getattr(tm.structure, name)),
            np.asarray(getattr(jm.structure, name)), err_msg=name)
    for name in MODEL_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    pairs = tm.structure.candidate_pairs
    w = tm.structure.shape_world[pairs]
    assert ((w[:, 0] == w[:, 1]) | (w.min(1) == -1)).all()


def test_replicate_carries_actuation_and_controls():
    """Each world's actuators drive that world's dofs, the flat ``mjc:ctrl``
    has one entry per actuator of the model, and ``mjc_options`` come
    along."""
    r = nt.ModelBuilder()
    r.add_mjcf(ANT)
    b = nt.ModelBuilder()
    b.replicate(r, 3)
    m = b.finalize("cpu")
    au, ra = m.structure.mjc_actuation, r.mjc_actuation
    assert au.n == 3 * ra.n
    for name, stride in (("dof", 14), ("coord", 15)):
        off = getattr(au, name).reshape(3, -1) - getattr(ra, name)
        assert (off == stride * np.arange(3)[:, None]).all(), name
    assert m.control().custom["mjc:ctrl"].shape == (3 * ra.n,)
    assert m.structure.mjc_options == r.mjc_options
    gear = m.custom["mjc:actuator_gear"].reshape(3, -1)
    assert (gear == gear[0]).all() and gear.abs().sum() > 0


def test_replicate_is_vectorized_at_scale():
    """Host setup of 2048 humanoid worlds stays within seconds: replicate,
    finalize, the collision plan and the solver's row tables (the flat
    model has 26,624 bodies and 393,216 contact slots)."""
    import time
    r = nt.ModelBuilder()
    r.add_mjcf(HUMANOID)
    t0 = time.perf_counter()
    b = nt.ModelBuilder()
    b.replicate(r, 2048)
    m = b.finalize("cpu")
    nt.CollisionPipeline(m)
    s = nt.SolverMuJoCo(m, iterations=8, integrator="euler")
    assert time.perf_counter() - t0 < 30.0
    assert s.group.n == 2048 and s.contact_plans[0].slots.shape == (2048,
                                                                     192)
    assert s.tables.base_acc.shape == (2048, 13, 6)


# ----------------------------------------------------------------------
# the cartpole: prismatic joints from one MJCF slide
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def cartpole():
    return _Pair(CARTPOLE, 4, iterations=4)


@pytest.mark.parametrize("ref", [None, 0.2])
def test_cartpole_import_matches_jax(tmp_path, ref):
    """gymnasium's inverted pendulum: the slider imports as a prismatic
    joint, its leaves equal the JAX package's (with a slide ``ref`` the
    limits shift by it and ``mjc:qpos_ref`` keeps it), and FK at random
    coordinates agrees to 1e-5."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, \
        MODEL_INT_FIELDS
    path = CARTPOLE
    if ref is not None:
        path = str(tmp_path / "cartpole.xml")
        with open(CARTPOLE) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(text.replace('name="slider" pos="0 0 0"',
                                 f'name="slider" pos="0 0 0" ref="{ref}"'))
    jb = jt.ModelBuilder()
    jb.add_mjcf(path)
    tb = nt.ModelBuilder()
    tb.add_mjcf(path)
    jm, tm = jb.finalize(), tb.finalize("cpu")
    assert tm.structure.joint_type.tolist() == [int(nt.JointType.PRISMATIC),
                                                int(nt.JointType.REVOLUTE)]
    assert tm.structure.joint_dof_dim.tolist() == [[1, 0], [0, 1]]
    for name in MODEL_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)
    for name in MODEL_INT_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)
    for k, v in jm.custom.items():
        np.testing.assert_allclose(tm.custom[k].numpy(), np.asarray(v),
                                   err_msg=k)
    assert set(tm.custom) == set(jm.custom)
    rng = np.random.RandomState(3)
    q = rng.uniform(-0.8, 0.8, (5, 2)).astype(np.float32)
    qd = rng.randn(5, 2).astype(np.float32)
    for qi, qdi in zip(q, qd):
        js = j_eval_fk(jm, jnp.asarray(qi), jnp.asarray(qdi), jm.state())
        ts = nt.eval_fk(tm, torch.as_tensor(qi), torch.as_tensor(qdi),
                        tm.state())
        np.testing.assert_allclose(ts.body_q.numpy(), np.asarray(js.body_q),
                                   atol=1e-5)
        np.testing.assert_allclose(ts.body_qd.numpy(),
                                   np.asarray(js.body_qd), atol=1e-5)
    # the cart moves along its slide axis by q
    ts = nt.eval_fk(tm, torch.tensor([0.3, 0.0]), torch.zeros(2),
                    tm.state())
    np.testing.assert_allclose(ts.body_q[0, :3].numpy(), [0.3, 0.0, 0.0],
                               atol=1e-7)


def test_replicated_cartpole_step_matches_jax(cartpole):
    """``step`` on replicate(cartpole, 4) with random mjc:ctrl in
    [-3, 3], 8 substeps against the JAX package's ``step``; world 0 starts
    past its slider limit, so the limits-only solve acts."""
    rng = np.random.RandomState(7)
    n = cartpole.n
    q = np.zeros((n, 2), np.float32)
    q[:, 0] = rng.uniform(-0.5, 0.5, n)
    q[:, 1] = rng.uniform(-0.3, 0.3, n)
    q[0, 0] = 1.002
    qd = 0.1 * rng.randn(n, 2).astype(np.float32)
    qd[0, 0] = 0.5
    js, ts = cartpole.states(q.reshape(-1), qd.reshape(-1))
    ctrl = rng.uniform(-3, 3, n).astype(np.float32)
    jc, tc = cartpole.controls(ctrl)
    rec = {}
    for k in range(8):
        js = cartpole.j_step(js, jc, None)
        ts = cartpole.ts.step(ts, None, tc, None, DT,
                              record=rec if k == 0 else None)
        _assert_states(ts, js)
    assert "limits" in rec and "pgs" not in rec
    assert tuple(rec["chol"][0].shape) == (n, 2, 2)
    assert float(ts.joint_q.view(n, 2)[0, 0]) < 1.002


# ----------------------------------------------------------------------
# the humanoid: replicated worlds with contacts
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def humanoid2():
    return _Pair(HUMANOID, 2)


def _humanoid_start(pair, seed, drop=0.15):
    """Both worlds at joint_q0 with noise, the roots pushed ``drop`` down
    so that feet and hands are in contact."""
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(pair.jm.joint_q0).reshape(pair.n, -1)[0],
                (pair.n, 1)) + 0.02 * rng.randn(pair.n, 24)
    q[:, 2] -= drop
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    qd = 0.1 * rng.randn(pair.n, 23)
    ctrl = rng.uniform(-0.4, 0.4, pair.n * 17).astype(np.float32)
    return (q.reshape(-1).astype(np.float32),
            qd.reshape(-1).astype(np.float32), ctrl)


def test_flat_contacts_match_jax():
    """``collide`` on a flat 3-world humanoid state equals the JAX
    ``collide`` slot by slot (positions, normals and depths 1e-5)."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jm = _scene(jt, "replicate humanoid").finalize()
    tm = _scene(nt, "replicate humanoid").finalize("cpu")
    rng = np.random.RandomState(5)
    q = np.asarray(jm.joint_q0).reshape(3, -1) + 0.02 * rng.randn(3, 24)
    q[:, 2] -= 0.15
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q = q.reshape(-1).astype(np.float32)
    qd = np.zeros(jm.joint_dof_count, np.float32)
    jc = JPipe(jm).collide(j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd),
                                     jm.state()))
    tc = nt.CollisionPipeline(tm).collide(nt.eval_fk(
        tm, torch.as_tensor(q), torch.as_tensor(qd), tm.state()))
    mask = np.asarray(jc.rigid_contact_mask)
    assert mask.reshape(3, -1).any(1).all()
    assert tc.rigid_contact_mask.shape == mask.shape
    np.testing.assert_array_equal(tc.rigid_contact_mask.numpy(), mask)
    for name in ("rigid_contact_shape0", "rigid_contact_shape1"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    for name in ("rigid_contact_position", "rigid_contact_normal",
                 "rigid_contact_depth"):
        np.testing.assert_allclose(getattr(tc, name).numpy()[mask],
                                   np.asarray(getattr(jc, name))[mask],
                                   atol=1e-5, err_msg=name)


def test_replicated_humanoid_step_matches_jax(humanoid2):
    """``step`` on replicate(humanoid, 2), roots pushed into the floor
    (contacts active, top-K compaction of each world's 192 slots): one
    substep on the JAX model's leaves carried through the bridge, with
    the JAX package's contacts."""
    from newton_tpu_torch.utils import bridge
    pair = humanoid2
    q, qd, ctrl = _humanoid_start(pair, 11)
    js, _ = pair.states(q, qd)
    jc, _ = pair.controls(ctrl)
    contacts = pair.j_collide(js)
    assert np.asarray(contacts.rigid_contact_mask).reshape(2, -1) \
        .any(1).all()
    tm = bridge.model_from_numpy(*_jax_model_to_numpy(pair.jm), "cpu")
    ts = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    fields = ("body_q", "body_qd", "body_f", "joint_q", "joint_qd",
              "particle_q", "particle_qd", "particle_f")

    def np_of(obj, names):
        out = {k: np.asarray(getattr(obj, k)) for k in names}
        out["custom"] = {k: np.asarray(v) for k, v in obj.custom.items()}
        return out
    state = bridge.state_from_numpy(np_of(js, fields), "cpu")
    control = bridge.control_from_numpy(np_of(jc, bridge.CONTROL_FIELDS),
                                        "cpu")
    got = ts.step(state, None, control, bridge.contacts_from_numpy(
        {k: np.asarray(getattr(contacts, k)) for k in bridge.CONTACT_FIELDS},
        "cpu"), DT)
    _assert_states(got, pair.j_step(js, jc, contacts))


def test_replicated_humanoid_rollout_matches_jax(humanoid2):
    """The whole slice for 4 substeps on replicate(humanoid, 2): each
    package's own builder, FK, flat collide and ``step``, from the same
    coordinates and ctrl; ``init_state`` adds the compaction-overflow
    count, which stays 0 below 32 active contacts per world."""
    pair = humanoid2
    q, qd, ctrl = _humanoid_start(pair, 12)
    js, ts = pair.states(q, qd)
    jc, tc = pair.controls(ctrl)
    ts = pair.ts.init_state(ts)
    assert ts.custom["contact:overflow:0"].shape == (2,)
    for _ in range(4):
        js = pair.j_step(js, jc, pair.j_collide(js))
        ts = pair.ts.step(ts, None, tc, pair.tpipe.collide(ts), DT)
        _assert_states(ts, js)
    assert ts.custom["contact:overflow:0"].tolist() == [0, 0]


def test_step_matches_step_batched():
    """On the port: ``step`` on replicate(humanoid, 3) equals
    ``step_batched`` of the one-world humanoid on ``batch_state`` of the
    same three worlds, with the same ctrl and contacts, to 1e-6 over two
    substeps (the same operations on gathered operands)."""
    r = nt.ModelBuilder()
    r.add_mjcf(HUMANOID)
    one = r.finalize("cpu")
    b = nt.ModelBuilder()
    b.replicate(r, 3)
    m = b.finalize("cpu")
    solver = nt.SolverMuJoCo(m, iterations=8, integrator="euler")
    solver1 = nt.SolverMuJoCo(one, iterations=8, integrator="euler")
    pipe, pipe1 = nt.CollisionPipeline(m), nt.CollisionPipeline(one)
    rng = np.random.RandomState(13)
    q = one.joint_q0.numpy()[None] + 0.02 * rng.randn(3, 24)
    q[:, 2] -= 0.15
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q = torch.as_tensor(q, dtype=torch.float32)
    qd = torch.as_tensor(0.1 * rng.randn(3, 23), dtype=torch.float32)
    flat = nt.eval_fk(m, q.reshape(-1), qd.reshape(-1), m.state())
    sb = nt.eval_fk(one, q, qd, nt.batch_state(one.state(), 3))
    ctrl = torch.as_tensor(rng.uniform(-0.4, 0.4, (3, 17)),
                           dtype=torch.float32)
    ctl = m.control()
    ctl.custom["mjc:ctrl"] = ctrl.reshape(-1)
    c1 = one.control()
    ctl_b = nt.Control(joint_target_q=c1.joint_target_q.expand(3, -1),
                       joint_target_qd=torch.zeros(3, 23),
                       joint_f=torch.zeros(3, 23), custom={"mjc:ctrl": ctrl})
    for _ in range(2):
        flat = solver.step(flat, None, ctl, pipe.collide(flat), DT)
        sb = solver1.step_batched(sb, None, ctl_b, pipe1.collide(sb), DT)
        for name in ("joint_q", "joint_qd", "body_q", "body_qd"):
            torch.testing.assert_close(getattr(flat, name).reshape(3, -1),
                                       getattr(sb, name).reshape(3, -1),
                                       atol=1e-6, rtol=0)


# ----------------------------------------------------------------------
# one world through step: the example_robot_ant path
# ----------------------------------------------------------------------
def test_one_world_ant_step_matches_jax():
    """``step`` on the one-world ant (one row) against the JAX package's
    ``step``, feet pushed into the floor: 4 substeps of the whole slice
    with mjc:ctrl."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    jb = jt.ModelBuilder()
    jb.add_mjcf(ANT)
    jm = jb.finalize()
    js_ = JSolver(jm, iterations=8, integrator="euler")
    jpipe = JPipe(jm)
    tb = nt.ModelBuilder()
    tb.add_mjcf(ANT)
    tm = tb.finalize("cpu")
    ts_ = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    assert ts_.group.n == 1
    tpipe = nt.CollisionPipeline(tm)
    rng = np.random.RandomState(9)
    q = (np.asarray(jm.joint_q0) + 0.02 * rng.randn(15)).astype(np.float32)
    q[2] -= 0.06
    q[3:7] /= np.linalg.norm(q[3:7])
    qd = (0.1 * rng.randn(14)).astype(np.float32)
    ctrl = rng.uniform(-1, 1, 8).astype(np.float32)
    js = j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state())
    ts = nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd), tm.state())
    jc = jm.control()
    jc = jc.replace(custom={**jc.custom, "mjc:ctrl": jnp.asarray(ctrl)})
    tc = tm.control()
    tc.custom["mjc:ctrl"] = torch.as_tensor(ctrl)
    j_step = jax.jit(lambda s, ct: js_.step(s, None, jc, ct, DT))
    for _ in range(4):
        contacts = jpipe.collide(js)
        assert np.asarray(contacts.rigid_contact_mask).any()
        js = j_step(js, contacts)
        ts = ts_.step(ts, None, tc, tpipe.collide(ts), DT)
        _assert_states(ts, js)


# ----------------------------------------------------------------------
# what the port does not have yet raises
# ----------------------------------------------------------------------
def _two_link(kind):
    b = nt.ModelBuilder()
    b.add_ground_plane()
    b0 = b.add_body()
    b.add_shape_sphere(b0, radius=0.1)
    b.add_joint_free(b0)
    b1 = b.add_body()
    b.add_shape_sphere(b1, radius=0.1)
    if kind == "d6 linear":
        b.add_joint(nt.JointType.D6, b0, b1,
                    linear_axes=[nt.JointDofConfig(axis="X")],
                    angular_axes=[nt.JointDofConfig(axis="Y")])
    elif kind == "ball":
        b.add_joint(nt.JointType.BALL, b0, b1,
                    angular_axes=[nt.JointDofConfig()])
    elif kind == "two articulations":
        b.add_articulation()
        b.add_joint_revolute(-1, b1, axis="Y")
    return b


@pytest.mark.parametrize("kind", ["d6 linear", "ball", "two articulations",
                                  "heterogeneous contacts"])
def test_unported_cases_raise(kind):
    """A ball joint, two articulations in one world and a heterogeneous
    contact plan (two worlds whose robots differ) raise
    NotImplementedError. A D6 joint with a linear axis is ported: it
    builds and steps (tests/test_torch_planar.py holds it against the JAX
    package and MuJoCo-C)."""
    if kind == "d6 linear":
        m = _two_link(kind).finalize("cpu")
        assert tuple(m.structure.joint_dof_dim[1]) == (1, 1)
        solver = nt.SolverMuJoCo(m, integrator="euler")
        s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
        out = solver.step(s, None, None,
                          nt.CollisionPipeline(m).collide(s), DT)
        assert bool(torch.isfinite(out.joint_q).all())
        return
    with pytest.raises(NotImplementedError):
        if kind == "heterogeneous contacts":
            a = nt.ModelBuilder()
            a.add_ground_plane()
            body = a.add_body()
            a.add_shape_sphere(body, radius=0.1)
            a.add_joint_free(body)
            bb = nt.ModelBuilder()
            bb.add_ground_plane()
            bb.add_ground_plane()
            body = bb.add_body()
            bb.add_shape_sphere(body, radius=0.1)
            bb.add_joint_free(body)
            m = nt.ModelBuilder()
            m.add_world(a)
            m.add_world(bb)
            nt.SolverMuJoCo(m.finalize("cpu"), integrator="euler")
        else:
            b = _two_link(kind)
            nt.SolverMuJoCo(b.finalize("cpu"), integrator="euler")
