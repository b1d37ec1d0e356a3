"""The generalized solvers among bodies outside the articulations, in the
port against the JAX package on the CPU: kinematic bodies in the builder,
replicate and the bridge; contact slots whose other side is a body with
no joint (a kinematic conveyor belt: its velocity a moving support in
B2's rows) and slots with no side in an articulation (dropped); an
articulation mounted on another articulation's body; ``step_with_contacts``
of SolverFeatherstone, SolverMuJoCo and SolverKamino, flat and batched;
the third-law tower of tests/test_stacking.py; and the two reference
defects this slice pins (ROADMAP C.23, C.24). On a CUDA card: the
conveyor's step and force report on the card against the CPU, and two
card runs of it bit for bit.

Tolerances (tests/test_batched_step.py:69-75): body_q and joint_q atol =
rtol = 2e-4, joint_qd 5e-3; the contact force report per slot 1e-3 N.
The JAX package's tests' gates where this file repeats them on the port.

JAX is imported inside the fixtures and tests, so the GPU cases collect
where JAX is absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_free_bodies.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.utils import bridge

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 37-39)

torch.set_num_threads(1)

DT = 1.0 / 240.0
QTOL, QDTOL, FTOL = 2e-4, 5e-3, 1e-3
gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to_numpy(jm):
    from newton_tpu_torch.sim.model import (MODEL_BOOL_FIELDS,
                                            MODEL_FLOAT_FIELDS,
                                            MODEL_INT_FIELDS)
    leaves = {n: np.asarray(getattr(jm, n))
              for n in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS
              + MODEL_BOOL_FIELDS}
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


def _pair(builder_fn):
    """The JAX package's model of ``builder_fn(newton_tpu)`` and the same
    model on the port through the bridge."""
    import newton_tpu as jt
    jm = builder_fn(jt).finalize()
    return jm, bridge.model_from_numpy(*_to_numpy(jm), "cpu")


def _port_state(js):
    return bridge.state_from_numpy(
        {n: np.asarray(getattr(js, n)) for n in bridge.STATE_FIELDS}, "cpu")


def _close(got, ref, tol, what):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol, err_msg=what)


def _solvers(kind, jm, tm):
    import newton_tpu.solvers as js
    kw = dict(integrator="euler", warm_start=False)
    if kind == "mujoco":
        return (js.SolverMuJoCo(jm, iterations=16, **kw),
                nt.SolverMuJoCo(tm, iterations=16, **kw))
    if kind == "featherstone":
        return js.SolverFeatherstone(jm), nt.SolverFeatherstone(tm)
    return js.SolverKamino(jm), nt.SolverKamino(tm)


def _run_reports(jm, tm, j_solver, t_solver, js_, ts_, substeps,
                 control=None, relative_force=False):
    """``substeps`` steps with the force report on both sides from the
    same state; every substep's body_q, joint_qd and per-slot force held
    to the tolerances (with ``relative_force``, the force per slot to
    1e-3 of the report's largest entry). Returns the last (JAX, port)
    states and reports."""
    import jax
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jp, tp = JPipe(jm), nt.CollisionPipeline(tm)
    jctl = None if control is None else control[0]
    tctl = None if control is None else control[1]

    @jax.jit
    def jstep(s):
        return j_solver.step_with_contacts(s, None, jctl, jp.collide(s), DT)
    for k in range(substeps):
        js_, jc = jstep(js_)
        ts_, tc = t_solver.step_with_contacts(ts_, None, tctl,
                                              tp.collide(ts_), DT)
        _close(ts_.body_q, js_.body_q, QTOL, f"body_q, substep {k}")
        _close(ts_.joint_qd, js_.joint_qd, QDTOL, f"joint_qd, substep {k}")
        ref = np.asarray(jc.rigid_contact_force)
        if relative_force:
            # per shape pair (the sum of its slots) to 1e-3 of the largest
            # pair total, per slot to 1e-2 of the largest entry
            got = tc.rigid_contact_force.numpy()
            pair = (np.asarray(tm.structure.slot_shape0) * 4096
                    + np.asarray(tm.structure.slot_shape1))
            _, inv = np.unique(pair, return_inverse=True)
            tot_g = np.zeros((inv.max() + 1, 3))
            tot_r = np.zeros_like(tot_g)
            np.add.at(tot_g, inv, got)
            np.add.at(tot_r, inv, ref)
            big = max(float(np.abs(tot_r).max()), 1.0)
            np.testing.assert_allclose(tot_g, tot_r, rtol=0, atol=FTOL * big,
                                       err_msg=f"pair forces, substep {k}")
            np.testing.assert_allclose(
                got, ref, rtol=0,
                atol=10 * FTOL * max(float(np.abs(ref).max()), 1.0),
                err_msg=f"contact force, substep {k}")
        else:
            _close(tc.rigid_contact_force, ref, FTOL,
                   f"contact force, substep {k}")
    return js_, ts_, jc, tc


# ----------------------------------------------------------------------
# kinematic bodies: builder, replicate, bridge
# ----------------------------------------------------------------------
def test_kinematic_body_builder_matches_jax():
    """``add_body(qd=, kinematic=)``: flags, initial twists and zero
    inverse mass and inertia of the belt equal the JAX builder's, through
    replicate; add_builder carries them as replicate does; the numpy
    bridge carries both fields both ways."""
    jm, tm = _pair(lambda lib: cs.conveyor_scene(lib, 3))
    t2 = cs.conveyor_scene(nt, 3).finalize("cpu")
    for name in ("body_flags", "body_qd", "body_q", "body_inv_mass",
                 "body_inv_inertia", "body_mass"):
        np.testing.assert_array_equal(getattr(t2, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    belt = np.arange(3) * 3
    assert (t2.body_flags.numpy()[belt] == int(nt.sim.enums.BodyFlags
                                               .KINEMATIC)).all()
    assert (t2.body_inv_mass.numpy()[belt] == 0).all()
    assert (t2.body_mass.numpy()[belt] > 0).all()
    np.testing.assert_array_equal(t2.body_qd.numpy()[belt, 0],
                                  np.float32(cs.BELT_SPEED))
    one = cs.conveyor_scene(nt, 1)
    b = nt.ModelBuilder(gravity=-9.81)
    for _ in range(3):
        b.add_builder(one)
    t3 = b.finalize("cpu")
    for name in ("body_flags", "body_qd", "body_inv_mass"):
        np.testing.assert_array_equal(getattr(t3, name).numpy(),
                                      getattr(t2, name).numpy(), name)
    back = bridge.model_from_numpy(*bridge.model_to_numpy(t2), "cpu")
    for name in ("body_flags", "body_qd"):
        assert torch.equal(getattr(back, name), getattr(t2, name))


def _belt_pair_scene(lib):
    """The conveyor with a second kinematic box resting on the belt: its
    slots with the belt have no side in an articulation."""
    b = cs.conveyor_scene(lib, 1)
    cfg = b.default_shape_cfg.copy()
    k = b.add_body(xform=[1.5, 0.0, 0.2, 0, 0, 0, 1], kinematic=True)
    b.add_shape_box(k, hx=0.1, hy=0.1, hz=0.1, cfg=cfg)
    return cs.replicated(lib, b, 2)


def test_contact_plan_with_outside_bodies_matches_jax():
    """Slots whose other side is the belt enter the crates' cell with the
    belt in ``ob`` and weight 1; the slots between the belt and the other
    kinematic box (no side in an articulation) are in no plan; the plan
    equals the JAX package's."""
    import newton_tpu.solvers as js
    jm, tm = _pair(_belt_pair_scene)
    jp = js.SolverMuJoCo(jm).contact_plans
    tp = nt.SolverMuJoCo(tm).contact_plans
    assert len(jp) == len(tp) == 1
    for name in ("slots", "lb0", "lb1", "ob", "w"):
        np.testing.assert_array_equal(np.asarray(getattr(tp[0], name)),
                                      np.asarray(getattr(jp[0], name)), name)
    assert (tp[0].valid is None) == (jp[0].valid is None)
    st = tm.structure
    sb0, sb1 = np.asarray(st.slot_body0), np.asarray(st.slot_body1)
    outside = {0, 3, 4, 7}                      # belts and kinematic boxes
    both = np.nonzero(np.isin(sb0, list(outside))
                      & np.isin(sb1, list(outside)))[0]
    assert len(both) and not np.isin(both, tp[0].slots).any()
    others = tp[0].ob[tp[0].ob >= 0]
    assert set(np.unique(others).tolist()) == outside
    assert (np.asarray(tp[0].w) == 1.0).all()


@pytest.mark.parametrize("kind", ["mujoco", "featherstone", "kamino"])
def test_conveyor_step_with_contacts_matches_jax(kind):
    """example_basic_conveyor_forces.py x 2 worlds: 24 substeps of
    step_with_contacts, every substep's state and per-slot force report
    against the JAX package (48 entries per world compacted to 32, the
    belt's entries a moving support). Kamino's PADMM splits a crate's
    load among the coplanar contact points of its face in a way float32
    rounding moves (the states agree to 1e-6, single slots by 0.15% of
    the largest entry): its report is held per shape pair to 1e-3 of the
    largest pair total and per slot to 1e-2 of the largest entry."""
    jm, tm = _pair(lambda lib: cs.conveyor_scene(lib, 2))
    j_solver, t_solver = _solvers(kind, jm, tm)
    js_ = jm.state()
    _run_reports(jm, tm, j_solver, t_solver, js_, _port_state(js_), 24,
                 relative_force=kind == "kamino")


def test_conveyor_gates():
    """The example's physics on the port (2 worlds, 60 substeps): each
    crate moves with the belt within 5%, the reported normal force
    carries both crates' weight within 10%, the drag is finite, and the
    example's test_final holds (dragged more than 1 cm along +x, moving
    faster than 0.05 m/s, normal force above 0.3 of the weight)."""
    model = cs.conveyor_scene(nt, 2).finalize("cpu")
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverMuJoCo(model, iterations=16, warm_start=False)
    s = model.state()
    x0 = s.body_q[:, 0].clone()
    for _ in range(60):
        s, c = solver.step_with_contacts(s, None, None, pipe.collide(s), DT)
    crates = torch.tensor([1, 2, 4, 5])
    vx = s.body_qd[crates, 0]
    assert float((vx / cs.BELT_SPEED - 1).abs().max()) < 0.05
    f, m = c.rigid_contact_force, c.rigid_contact_mask
    weight = float(model.body_mass[crates].sum()) * 9.81
    normal = float(f[m][:, 2].abs().sum())
    assert abs(normal / weight - 1) < 0.10, (normal, weight)
    assert bool(torch.isfinite(f[m][:, 0].sum()))
    assert bool(((s.body_q[crates, 0] - x0[crates]) > 0.01).all())
    assert normal > 0.3 * weight


# ----------------------------------------------------------------------
# reference defects this slice pins
# ----------------------------------------------------------------------
def _platform_scene(kinematic):
    def make(lib):
        b = lib.ModelBuilder(gravity=-9.81)
        p = b.add_body(xform=[0, 0, 0.5, 0, 0, 0, 1], kinematic=kinematic)
        b.add_shape_box(p, hx=0.5, hy=0.5, hz=0.05)
        c = b.add_body(xform=[0, 0, 0.65, 0, 0, 0, 1])
        b.add_shape_box(c, hx=0.1, hy=0.1, hz=0.1)
        b.add_joint_free(c)
        return b
    return make


def test_jax_freezes_a_dynamic_body_without_joint():
    """ROADMAP C.23: a dynamic body (mass 100 kg) without a joint is never
    moved by the JAX package's generalized solvers (gravity and contact
    impulses leave it hanging at z = 0.5), yet its inverse mass joins the
    Delassus diagonal of the crate resting on it, which settles lower
    than on the same platform made kinematic. The port copies both, and
    the crate equals the JAX package's (2e-4)."""
    import jax
    import newton_tpu.solvers as js
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    z = {}
    for kin in (True, False):
        jm, tm = _pair(_platform_scene(kin))
        jp, jsol = JPipe(jm), js.SolverMuJoCo(jm, iterations=16,
                                              integrator="euler")
        tp, tsol = nt.CollisionPipeline(tm), nt.SolverMuJoCo(
            tm, iterations=16, integrator="euler")
        run = jax.jit(lambda s: jax.lax.scan(
            lambda s, _: (jsol.step(s, None, None, jp.collide(s), DT),
                          None), s, None, length=120)[0])
        jst, tst = run(jm.state()), tm.state()
        p0 = tst.body_q[0].clone()
        for _ in range(120):
            tst = tsol.step(tst, None, None, tp.collide(tst), DT)
        _close(tst.body_q, jst.body_q, QTOL, f"kinematic={kin}")
        assert torch.equal(tst.body_q[0], p0)
        assert float(np.asarray(jst.body_q)[0, 2]) == 0.5
        z[kin] = float(tst.body_q[1, 2])
    assert float(tm.body_inv_mass[0]) > 0
    assert z[False] < z[True] - 5e-5, z


def test_jax_mounted_base_falls_faster_than_g():
    """ROADMAP C.24: the JAX package's RNEA accumulates a mounted arm's
    gravity wrench into its base's bias forces, but neither group's mass
    matrix sees the other; released at rest in the air, the free base
    accelerates at g (m_base + m_arm) / m_base = 10.74 m/s^2 (a system in
    free fall accelerates at g) while the arm's joints stay at rest. The
    port copies it."""
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    import newton_tpu.solvers as js
    jm, tm = _pair(lambda lib: cs.mounted_scene(lib, 1, ground=False))
    jst = j_eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state())
    jo = js.SolverMuJoCo(jm, integrator="euler").step(jst, None, None,
                                                      None, DT)
    to = nt.SolverMuJoCo(tm, integrator="euler").step(_port_state(jst),
                                                      None, None, None, DT)
    m = tm.body_mass.numpy()
    expect = -9.81 * m.sum() / m[0]
    for out in (np.asarray(jo.body_qd), to.body_qd.numpy()):
        np.testing.assert_allclose(out[0, 2] / DT, expect, rtol=1e-5)
        assert abs(out[0, 2] / DT + 9.81) > 0.9
    np.testing.assert_array_equal(to.joint_qd.numpy()[6:], 0.0)
    _close(to.body_qd, jo.body_qd, QDTOL, "body_qd")


# ----------------------------------------------------------------------
# mounted articulations
# ----------------------------------------------------------------------
def test_mounted_arm_matches_jax():
    """mounted_scene x 2 worlds (a two-link arm mounted on a free base, on
    the ground): from a perturbed state with random joint forces, 24
    substeps against the JAX package; the arm's group carries the base as
    its mount and steps after it."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    import newton_tpu.solvers as js
    jm, tm = _pair(lambda lib: cs.mounted_scene(lib, 2))
    rng = np.random.RandomState(0)
    q = np.asarray(jm.joint_q0).copy()
    q[6:8] += 0.3 * rng.randn(2).astype(np.float32)
    q[14:16] += 0.3 * rng.randn(2).astype(np.float32)
    qd = (0.5 * rng.randn(*np.asarray(jm.joint_qd0).shape)).astype(
        np.float32)
    jst = j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state())
    f = (2.0 * rng.randn(jm.structure.joint_dof_count)).astype(np.float32)
    jc = jm.control().replace(joint_f=jnp.asarray(f))
    tc = tm.control()
    tc.joint_f = torch.as_tensor(f)
    jsol = js.SolverMuJoCo(jm, iterations=8, integrator="euler")
    tsol = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    assert [(g.g.n, g.g.d) for g in tsol.groups] == [(2, 6), (2, 2)]
    assert tsol.mount_order == [1]
    np.testing.assert_array_equal(tsol.groups[1].mounts, [[0], [3]])
    jp, tp = JPipe(jm), nt.CollisionPipeline(tm)
    step = jax.jit(lambda s: jsol.step(s, None, jc, jp.collide(s), DT))
    tst = _port_state(jst)
    for k in range(24):
        jst = step(jst)
        tst = tsol.step(tst, None, tc, tp.collide(tst), DT)
        _close(tst.body_q, jst.body_q, QTOL, f"body_q, substep {k}")
        _close(tst.joint_q, jst.joint_q, QTOL, f"joint_q, substep {k}")
        _close(tst.joint_qd, jst.joint_qd, QDTOL, f"joint_qd, substep {k}")


def test_mounted_arm_raises_where_not_ported():
    """A mounted articulation under RK4, the implicit integrator or
    sleeping raises, naming the case."""
    model = cs.mounted_scene(nt, 1).finalize("cpu")
    for kw in (dict(integrator="rk4"), dict(integrator="implicit"),
               dict(integrator="euler", sleep_threshold=0.01)):
        with pytest.raises(NotImplementedError, match="mounted"):
            nt.SolverMuJoCo(model, **kw)


def test_joints_outside_articulations_are_unreachable():
    """The builder puts every joint in an articulation (add_joint opens
    one when there is none): in every scene the port builds, the groups
    cover every dof; the solver's check raises, naming the case, only on
    a structure edited by hand."""
    scenes = [cs.conveyor_scene(nt, 3), cs.mounted_scene(nt, 2),
              cs.tower_scene(nt, 2), cs.rod_scene(nt, 2)[0]]
    rods = nt.ModelBuilder()
    rods.add_rod_graph([[0, 0, 1], [0.5, 0, 1], [1.0, 0.3, 1],
                        [1.0, -0.3, 1]], [(0, 1), (1, 2), (1, 3)])
    rods.add_joint_distance(-1, rods.add_body(), max_distance=0.5)
    scenes.append(rods)
    ant = nt.ModelBuilder()
    ant.add_mjcf(os.path.join(nt.ASSET_DIR, "ant.xml"))
    b = nt.ModelBuilder()
    b.add_builder(ant)
    b.add_builder(ant)
    scenes.append(b)
    for sc in scenes:
        m = sc.finalize("cpu")
        solver = nt.SolverMuJoCo(m, integrator="euler")
        assert sum(g.g.n * g.g.d for g in solver.groups) == \
            m.structure.joint_dof_count
    m = cs.conveyor_scene(nt, 2).finalize("cpu")
    m.structure.articulation_start = np.asarray([0, 2, 3], np.int32)
    with pytest.raises(NotImplementedError, match="no ModelBuilder call"):
        nt.SolverMuJoCo(m)


# ----------------------------------------------------------------------
# contact force reports
# ----------------------------------------------------------------------
def _two_box_scene(lib):
    """Two free boxes side by side, each its own articulation (one group
    of two rows per world), touching along x, on the ground: the box-box
    slots are two-sided (an entry in each row, weight 0.5 each)."""
    b = lib.ModelBuilder(gravity=-9.81)
    for i, x in enumerate((0.0, 0.199)):
        if i:
            b.add_articulation()
        body = b.add_body(xform=[x, 0.0, 0.1, 0, 0, 0, 1])
        b.add_shape_box(body, hx=0.1, hy=0.1, hz=0.1)
        b.add_joint_free(body)
    b.add_ground_plane()
    return cs.replicated(lib, b, 2)


def test_two_sided_force_report_matches_jax():
    """A contact between two rows of one group: both halves add into the
    shared slot (weight 0.5 each) in a fixed order; 12 substeps of the
    report against the JAX package, with a push on one box."""
    import jax.numpy as jnp
    import newton_tpu.solvers as js
    jm, tm = _pair(_two_box_scene)
    plan = nt.SolverMuJoCo(tm).contact_plans[0]
    assert (np.asarray(plan.w) == 0.5).any()
    f = np.zeros(jm.structure.joint_dof_count, np.float32)
    f[0] = 30.0
    jc = jm.control().replace(joint_f=jnp.asarray(f))
    tc = tm.control()
    tc.joint_f = torch.as_tensor(f)
    jsol = js.SolverMuJoCo(jm, iterations=16, integrator="euler")
    tsol = nt.SolverMuJoCo(tm, iterations=16, integrator="euler")
    js_ = jm.state()
    _run_reports(jm, tm, jsol, tsol, js_, _port_state(js_), 12,
                 control=(jc, tc))


def test_third_law_reaction_matches_jax():
    """tests/test_stacking.py:161 on the port: two boxes settled 200
    substeps under SolverMuJoCo(iterations=40, contact_cap=0); the
    ground's contacts carry both weights and the box-box contact one
    weight (within 35%, the JAX test's gate), and the per-slot report
    equals the JAX package's (1e-3 N)."""
    import jax
    from newton_tpu.geometry.types import GeoType
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    import newton_tpu.solvers as js
    jm, tm = _pair(lambda lib: cs.tower_scene(lib, 1))
    kw = dict(iterations=40, integrator="euler", warm_start=False,
              contact_cap=0)
    jsol, tsol = js.SolverMuJoCo(jm, **kw), nt.SolverMuJoCo(tm, **kw)
    jp, tp = JPipe(jm), nt.CollisionPipeline(tm)
    settle = jax.jit(lambda s: jax.lax.scan(
        lambda s, _: (jsol.step(s, None, None, jp.collide(s), DT), None),
        s, None, length=200)[0])
    jst = settle(jsol.init_state(jm.state()))
    tst = tsol.init_state(tm.state())
    for _ in range(200):
        tst = tsol.step(tst, None, None, tp.collide(tst), DT)
    _close(tst.body_q, jst.body_q, QTOL, "settled body_q")
    _, jc = jsol.step_with_contacts(jst, None, None, jp.collide(jst), DT)
    _, tc = tsol.step_with_contacts(tst, None, None, tp.collide(tst), DT)
    _close(tc.rigid_contact_force, jc.rigid_contact_force, FTOL, "forces")
    f = tc.rigid_contact_force.numpy()
    mask = tc.rigid_contact_mask.numpy()
    s0 = tc.rigid_contact_shape0.numpy()
    s1 = tc.rigid_contact_shape1.numpy()
    plane = np.asarray(tm.structure.shape_type) == int(GeoType.PLANE)
    gnd = mask & (plane[np.maximum(s0, 0)] | plane[np.maximum(s1, 0)])
    bb = mask & ~plane[np.maximum(s0, 0)] & ~plane[np.maximum(s1, 0)]
    w_one = 9.81 / float(tm.body_inv_mass[0])
    assert abs(abs(f[gnd][:, 2].sum()) - 2 * w_one) < 0.35 * 2 * w_one
    assert abs(abs(f[bb][:, 2].sum()) - w_one) < 0.35 * w_one


def test_step_with_contacts_batched_matches_flat():
    """The force report of step_batched (a one-world tower over a leading
    env axis) equals the flat step's of each env alone (1e-6 N and 1e-6
    relative: the two paths reduce in different orders), and
    update_contacts equals step_with_contacts without control."""
    model = cs.tower_scene(nt, 1).finalize("cpu")
    pipe = nt.CollisionPipeline(model)
    solver = nt.SolverMuJoCo(model, iterations=40, integrator="euler",
                             contact_cap=0)
    s = model.state()
    for _ in range(30):
        s = solver.step(s, None, None, pipe.collide(s), DT)
    s2 = s.clone()
    s2.body_q[:, 0] += 0.3
    s2 = nt.eval_fk(model, *nt.eval_ik(model, s2), s2)
    flat = [solver.step_with_contacts(x, None, None, pipe.collide(x), DT)[1]
            for x in (s, s2)]
    sb = nt.batch_state(s, 2)
    sb.body_q[1], sb.body_qd[1] = s2.body_q, s2.body_qd
    sb.joint_q[1], sb.joint_qd[1] = s2.joint_q, s2.joint_qd
    _, cb = solver.step_with_contacts(sb, None, None, pipe.collide(sb), DT)
    for w in range(2):
        np.testing.assert_allclose(cb.rigid_contact_force[w].numpy(),
                                   flat[w].rigid_contact_force.numpy(),
                                   atol=1e-6, rtol=1e-6)
    upd = solver.update_contacts(pipe.collide(s), s, None, DT)
    assert torch.equal(upd.rigid_contact_force, flat[0].rigid_contact_force)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@gpu
def test_conveyor_on_card_matches_cpu(cuda):
    """The conveyor x 64 worlds: 8 substeps of step_with_contacts on the
    card against the CPU (2e-4 / 5e-3, forces 1e-3 N), and two card runs
    of a substep and its report equal bit for bit."""
    out = {}
    for dev in (cuda, "cpu"):
        m = cs.conveyor_scene(nt, 64).finalize(dev)
        pipe = nt.CollisionPipeline(m)
        solver = nt.SolverMuJoCo(m, iterations=16, warm_start=False)
        s = m.state()
        for _ in range(8):
            s, c = solver.step_with_contacts(s, None, None, pipe.collide(s),
                                             DT)
        out[str(dev)] = (s, c)
        if dev != "cpu":
            a = solver.step_with_contacts(s, None, None, pipe.collide(s), DT)
            b = solver.step_with_contacts(s, None, None, pipe.collide(s), DT)
            assert torch.equal(a[0].body_q, b[0].body_q)
            assert torch.equal(a[1].rigid_contact_force,
                               b[1].rigid_contact_force)
    (sd, cd), (sc, cc) = out[str(cuda)], out["cpu"]
    _close(sd.body_q, sc.body_q.numpy(), QTOL, "body_q")
    _close(sd.joint_qd, sc.joint_qd.numpy(), QDTOL, "joint_qd")
    _close(cd.rigid_contact_force, cc.rigid_contact_force.numpy(), FTOL,
           "forces")


@gpu
def test_mounted_on_card_matches_cpu(cuda):
    """mounted_scene x 64 on the card against the CPU over 8 substeps."""
    out = {}
    for dev in (cuda, "cpu"):
        m = cs.mounted_scene(nt, 64).finalize(dev)
        pipe = nt.CollisionPipeline(m)
        solver = nt.SolverMuJoCo(m, iterations=8, integrator="euler")
        s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
        for _ in range(8):
            s = solver.step(s, None, None, pipe.collide(s), DT)
        out[str(dev)] = s
    _close(out[str(cuda)].body_q, out["cpu"].body_q.numpy(), QTOL, "body_q")
    _close(out[str(cuda)].joint_qd, out["cpu"].joint_qd.numpy(), QDTOL,
           "joint_qd")
