"""Trajectory parity of the slice's scenes with the JAX package: the
terrain ant (example_terrain_ant.py) x 4 under ``SolverMuJoCo`` with
random ctrl through ``replicate`` + ``step``, from a pose whose feet meet
the heightfield; the hydroelastic mesh stack under
``SolverFeatherstone``; the compliant pad under ``SolverXPBD``'s
compliant rows from penetrating poses (at rest, and rising so that its
slots separate), and its settled depth at the pressure balance
m g = k_eff A delta. Each 8 substeps against the JAX step, joint_q and
body_q within 2e-4, joint_qd and body_qd within 5e-3."""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 49-50)
from test_torch_worlds import _tiled_actuation  # noqa: E402

torch.set_num_threads(1)
DT = 1.0 / 240.0
TOL = {"joint_q": 2e-4, "body_q": 2e-4, "joint_qd": 5e-3, "body_qd": 5e-3}


def _run_pair(scene, n, j_solver, t_solver, hydro, steps, q_edit=None,
              ctrl=None, jb_edit=None, qd_edit=None):
    """``steps`` substeps of collide + step on both sides from the same
    coordinates; returns (JAX state, port state, port model, port
    pipeline, the port's last Contacts, port solver)."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_fk
    from newton_tpu.sim.collide import CollisionPipeline as JP
    jb, tb = scene(jt, n), scene(nt, n)
    if jb_edit is not None:
        jb_edit(jb)
    jm, tm = jb.finalize(), tb.finalize("cpu")
    q0 = np.asarray(jm.joint_q0).copy()
    if q_edit is not None:
        q_edit(q0)
    qd0 = np.asarray(jm.joint_qd0).copy()
    if qd_edit is not None:
        qd_edit(qd0)
    js = j_fk(jm, jnp.asarray(q0), jnp.asarray(qd0), jm.state())
    ts = nt.eval_fk(tm, torch.as_tensor(q0), torch.as_tensor(qd0),
                    tm.state())
    jp, tp = JP(jm, hydroelastic=hydro), nt.CollisionPipeline(
        tm, hydroelastic=hydro)
    jsol, tsol = j_solver(jm), t_solver(tm)
    jc, tc = jm.control(), tm.control()
    if ctrl is not None:
        jc.custom["mjc:ctrl"] = jnp.asarray(ctrl)
        tc.custom["mjc:ctrl"] = torch.as_tensor(ctrl)

    @jax.jit
    def j_run(s):
        def sub(s, _):
            return jsol.step(s, None, jc, jp.collide(s), DT), None
        return jax.lax.scan(sub, s, None, length=steps)[0]
    js = j_run(js)
    contacts = None
    for _ in range(steps):
        contacts = tp.collide(ts)
        ts = tsol.step(ts, None, tc, contacts, DT)
    return js, ts, tm, tp, contacts, tsol


def _close(js, ts, fields=TOL):
    for name, tol in fields.items():
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   np.asarray(getattr(js, name)), atol=tol,
                                   rtol=tol, err_msg=name)


def test_terrain_ant_matches_jax():
    """4 worlds, random ctrl, the root lowered so the feet press into the
    fractal field: the heightfield's two-sided slots are active and the
    step matches the JAX package's."""
    import newton_tpu as jt
    W = 4
    rng = np.random.RandomState(0)
    ctrl = rng.uniform(-1, 1, W * 8).astype(np.float32)

    def lower(q):
        q.reshape(W, -1)[:, 2] -= cs.TERRAIN_RAISE - 0.05

    def actuation(jb):
        r = jt.ModelBuilder()
        r.add_mjcf(nt.ASSET_DIR + "/ant.xml")
        jb.mjc_actuation = _tiled_actuation(r, W)
    js, ts, tm, tp, c, _ = _run_pair(
        cs.terrain_ant_scene, W,
        lambda m: jt.solvers.SolverMuJoCo(m, iterations=8,
                                          integrator="euler"),
        lambda m: nt.SolverMuJoCo(m, iterations=8, integrator="euler"),
        False, 8, q_edit=lower, ctrl=ctrl, jb_edit=actuation)
    _close(js, ts)
    hf = int(nt.GeoType.HFIELD)
    typ = tm.structure.shape_type
    on_field = typ[c.rigid_contact_shape1.numpy()] == hf
    assert (c.rigid_contact_mask.numpy() & on_field).sum() >= W
    assert torch.isfinite(ts.body_q).all()


def test_mesh_stack_hydroelastic_matches_jax():
    from newton_tpu.solvers.generalized.solver import SolverFeatherstone
    js, ts, tm, _, c, _ = _run_pair(
        cs.mesh_stack_scene, 1,
        lambda m: SolverFeatherstone(m, contact_iterations=8),
        lambda m: nt.SolverFeatherstone(m, contact_iterations=8), True, 8)
    _close(js, ts)
    assert bool(c.rigid_contact_mask.any())
    assert bool((c.rigid_contact_stiffness > 0).any())


def _pad_pair(sink, rise=0.0):
    """The compliant pad with the cube's bottom ``sink - 0.05`` m into the
    pad, rising at ``rise`` m/s."""
    import newton_tpu as jt

    def q_edit(q):
        q[2] -= sink

    def qd_edit(qd):
        qd[2] = rise
    return _run_pair(cs.compliant_pad_scene, 1,
                     lambda m: jt.solvers.SolverXPBD(m, iterations=8),
                     lambda m: nt.SolverXPBD(m, iterations=8), True, 8,
                     q_edit=q_edit, qd_edit=qd_edit)


def _assert_compliant_push(c, tsol):
    """Every active slot of the last substep is compliant, penetrating
    and pushing (lam_n > 0)."""
    active = c.rigid_contact_mask
    assert int(active.sum()) >= 4
    assert bool((c.rigid_contact_stiffness[active] > 0).all())
    assert bool((c.rigid_contact_depth[active] > 0).all())
    assert bool((tsol._last_lam_n[active] > 0).all())


@pytest.fixture(scope="module")
def pad():
    """The compliant pad from rest 10 mm deep (its pressure-balance depth
    is ~8 mm), so every substep pushes through the compliant rows."""
    return _pad_pair(0.06)


def test_compliant_pad_matches_jax(pad):
    """While the compliant slots push (depth > 0, lam_n > 0 on each in
    the last substep), the port's compliance, its push-only clamp and the
    bias exemption move the cube as the JAX package's do."""
    js, ts, _, _, c, tsol = pad
    _close(js, ts)
    _assert_compliant_push(c, tsol)
    assert float(ts.body_q[0, 2]) < cs.PAD_H     # still pressed in


def test_compliant_pad_rebound_matches_jax():
    """40 mm deep and rising at 0.5 m/s: the slots separate instead of
    approaching, where a rigid slot's depenetration bias would be taken
    out of the velocity and a compliant one keeps it (the exemption moves
    body_qd by ~0.09 against the JAX package when removed)."""
    js, ts, _, _, c, tsol = _pad_pair(0.09, rise=0.5)
    _close(js, ts)
    _assert_compliant_push(c, tsol)
    assert float(ts.body_qd[0, 2]) > 0.1


def test_compliant_pad_settles_at_pressure_balance(pad):
    """Continued to 1 s, the cube rests where m g = (kh / 2) A delta
    (example_compliant_pad.py's test_final, within 30%), and the force
    report of a compliant slot is its stiffness times its depth."""
    _, ts, tm, tp, _, _ = pad
    solver = nt.SolverXPBD(tm, iterations=8)
    for _ in range(232):
        ts = solver.step(ts, None, None, tp.collide(ts), DT)
    c = tp.collide(ts)
    ts, c2 = solver.step_with_contacts(ts, None, None, c, DT)
    mass = float(1.0 / tm.body_inv_mass[0])
    delta = mass * 9.81 / ((cs.PAD_KH / 2) * (2 * cs.PAD_H) ** 2)
    depth = cs.PAD_H - float(ts.body_q[0, 2])
    assert abs(depth - delta) < 0.3 * delta, (depth, delta)
    m = c.rigid_contact_mask & (c.rigid_contact_stiffness > 0)
    f = (c2.rigid_contact_force[m] * c.rigid_contact_normal[m]).sum(-1)
    torch.testing.assert_close(
        f.abs(), (c.rigid_contact_stiffness * c.rigid_contact_depth)[m])
