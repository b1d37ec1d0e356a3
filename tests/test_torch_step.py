"""Parity: the port's batched substep against the JAX package's
``SolverMuJoCo.step_batched`` on the CPU (whose XLA branch is the kernels'
plain reference), on gymnasium's ant with MJCF actuation.

Single substep, identical inputs fed through the bridge: joint_q/body_q
atol = rtol = 2e-4, joint_qd atol = rtol = 5e-3 (test_batched_step.py:69-75).
Eight-substep rollout of the whole slice (the port's own importer, FK,
collision and step against the JAX package's): joint_q atol 1e-3, joint_qd
atol 2e-2, looser because float32 reorderings compound through 8 Jacobi
sweeps per substep."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newton_tpu as jt
from newton_tpu.parallel import batch_state as j_batch_state
from newton_tpu.sim.articulation import eval_fk as j_eval_fk
from newton_tpu.sim.collide import CollisionPipeline as JPipe
from newton_tpu.solvers import SolverMuJoCo as JSolver

import newton_tpu_torch as nt
from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, MODEL_INT_FIELDS
from newton_tpu_torch.solvers.generalized import linalg, pgs
from newton_tpu_torch.utils import bridge

torch.set_num_threads(1)

W = 4
DT = 1.0 / 240.0
ANT = os.path.join(nt.ASSET_DIR, "ant.xml")


def _jax_model_to_numpy(jm):
    leaves = {n: np.asarray(getattr(jm, n))
              for n in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS}
    leaves["custom"] = {k: np.asarray(v) for k, v in jm.custom.items()}
    st = jm.structure
    structure = {n: getattr(st, n) for n in bridge.STRUCTURE_FIELDS}
    structure["mjc_actuation"] = {n: getattr(st.mjc_actuation, n)
                                  for n in bridge.ACTUATION_FIELDS}
    structure["custom_specs"] = {
        k: dict(frequency=s.frequency.value, assignment=s.assignment.value,
                shape=s.shape, default=s.default)
        for k, s in st.custom_specs.items()}
    return leaves, structure


def _np(obj, fields):
    out = {n: np.asarray(getattr(obj, n)) for n in fields}
    out["custom"] = {k: np.asarray(v) for k, v in
                     getattr(obj, "custom", {}).items()}
    return out


@pytest.fixture(scope="module")
def ant():
    jb = jt.ModelBuilder()
    jb.add_mjcf(ANT)
    jm = jb.finalize()
    js = JSolver(jm, iterations=8, integrator="euler")
    tm = bridge.model_from_numpy(*_jax_model_to_numpy(jm), "cpu")

    class NS:
        pass
    ns = NS()
    ns.jm, ns.tm, ns.js, ns.jpipe = jm, tm, js, JPipe(jm)
    ns.ts = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    ns.j_step = jax.jit(lambda s, c, ct: js.step_batched(s, None, c, ct, DT))
    ns.j_collide = jax.jit(jax.vmap(ns.jpipe.collide))
    return ns


def _perturbed(jm, seed, drop, hip_push=0.0):
    rng = np.random.RandomState(seed)
    q = np.tile(np.asarray(jm.joint_q0), (W, 1)) \
        + 0.02 * rng.randn(W, 15).astype(np.float32)
    q[:, 2] -= drop
    q[:, 7::2] += hip_push          # hips past their +-30 degree limits
    qd = 0.1 * rng.randn(W, 14).astype(np.float32)
    return jax.vmap(lambda a, b, s: j_eval_fk(jm, a, b, s))(
        jnp.asarray(q), jnp.asarray(qd), j_batch_state(jm.state(), W))


def _controls(jm, ctrl, target_q=None):
    control = jm.control()

    def one(cv, tq):
        c = control.replace(custom={**control.custom, "mjc:ctrl": cv})
        return c if tq is None else c.replace(joint_target_q=tq)
    tq = None if target_q is None else jnp.asarray(target_q)
    return jax.vmap(one)(jnp.asarray(ctrl), tq)


def _assert_close(got, ref, q_atol=2e-4, qd_atol=5e-3):
    np.testing.assert_allclose(got.joint_q.numpy(), np.asarray(ref.joint_q),
                               atol=q_atol, rtol=2e-4)
    np.testing.assert_allclose(got.joint_qd.numpy(),
                               np.asarray(ref.joint_qd), atol=qd_atol,
                               rtol=5e-3)
    np.testing.assert_allclose(got.body_q.numpy(), np.asarray(ref.body_q),
                               atol=q_atol, rtol=2e-4)


@pytest.mark.parametrize("case", ["ctrl", "ctrl_drop", "pd_limits"])
def test_substep_matches_jax(ant, case):
    """MJCF ctrl at drop 0 and 0.08 (contacts active), and PD targets that
    push the hinges into their limits (limit rows active)."""
    rng = np.random.RandomState({"ctrl": 1, "ctrl_drop": 2,
                                 "pd_limits": 3}[case])
    sb = _perturbed(ant.jm, 10, 0.08 if case == "ctrl_drop" else 0.0,
                    0.6 if case == "pd_limits" else 0.0)
    ctrl = rng.uniform(-1, 1, (W, 8)).astype(np.float32)
    target = None
    if case == "pd_limits":
        target = np.tile(np.asarray(ant.jm.joint_q0), (W, 1)) \
            + 0.3 * rng.randn(W, 15).astype(np.float32)
    cb = _controls(ant.jm, ctrl, target)
    contacts = ant.j_collide(sb)
    if case == "ctrl_drop":
        assert np.asarray(contacts.rigid_contact_mask).any()
    ref = ant.j_step(sb, cb, contacts)
    got = ant.ts.step_batched(
        bridge.state_from_numpy(_np(sb, bridge.STATE_FIELDS), "cpu"), None,
        bridge.control_from_numpy(_np(cb, bridge.CONTROL_FIELDS), "cpu"),
        bridge.contacts_from_numpy(_np(contacts, bridge.CONTACT_FIELDS),
                                   "cpu"), DT)
    _assert_close(got, ref)


def test_substep_without_contacts_matches_jax(ant):
    """contacts=None: the limits-only impulse solve."""
    sb = _perturbed(ant.jm, 12, 0.0)
    ctrl = np.random.RandomState(4).uniform(-1, 1, (W, 8)).astype(np.float32)
    cb = _controls(ant.jm, ctrl)
    ref = jax.jit(lambda s, c: ant.js.step_batched(s, None, c, None, DT))(
        sb, cb)
    got = ant.ts.step_batched(
        bridge.state_from_numpy(_np(sb, bridge.STATE_FIELDS), "cpu"), None,
        bridge.control_from_numpy(_np(cb, bridge.CONTROL_FIELDS), "cpu"),
        None, DT)
    _assert_close(got, ref)


def test_rollout_matches_jax(ant):
    """The whole slice for 8 substeps: the port's own MJCF import,
    finalize, eval_fk, batch_state, collide and step, against the JAX
    package's, from the same perturbed coordinates and ctrl."""
    jm = ant.jm
    tb = nt.ModelBuilder()
    tb.add_mjcf(ANT)
    tm = tb.finalize("cpu")
    solver = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    pipe = nt.CollisionPipeline(tm)
    rng = np.random.RandomState(6)
    sb = _perturbed(jm, 13, 0.04)
    ts = nt.eval_fk(tm, torch.as_tensor(np.array(sb.joint_q)),
                    torch.as_tensor(np.array(sb.joint_qd)),
                    nt.batch_state(tm.state(), W))
    ctrl = rng.uniform(-1, 1, (W, 8)).astype(np.float32)
    cb = _controls(jm, ctrl)
    c = tm.control()
    tcb = nt.Control(joint_target_q=c.joint_target_q.expand(W, -1).clone(),
                     joint_target_qd=torch.zeros(W, 14),
                     joint_f=torch.zeros(W, 14),
                     custom={"mjc:ctrl": torch.as_tensor(ctrl)})
    for _ in range(8):
        sb = ant.j_step(sb, cb, ant.j_collide(sb))
        ts = solver.step_batched(ts, None, tcb, pipe.collide(ts), DT)
    assert bool(torch.isfinite(ts.joint_q).all())
    _assert_close(ts, sb, q_atol=1e-3, qd_atol=2e-2)


def test_cpu_path_launches_no_kernel(ant):
    before = (linalg.chol_inv_solve.launches, pgs.pgs_solve_fused.launches)
    s = nt.batch_state(nt.eval_fk(ant.tm, ant.tm.joint_q0, ant.tm.joint_qd0,
                                  ant.tm.state()), 2)
    ant.ts.step_batched(s, None, None, nt.CollisionPipeline(ant.tm)
                        .collide(s), DT)
    assert (linalg.chol_inv_solve.launches,
            pgs.pgs_solve_fused.launches) == before


@pytest.mark.parametrize("integrator", ["auto", "rk4", "implicit",
                                        "implicitfast"])
def test_unported_integrators_raise(ant, integrator):
    """gymnasium's ant.xml declares RK4; "auto" honours it, and the port
    raises instead of running euler under another name."""
    with pytest.raises(NotImplementedError, match="integrator"):
        nt.SolverMuJoCo(ant.tm, iterations=8, integrator=integrator)
