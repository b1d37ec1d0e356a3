"""Distance and cable joints in the port against the JAX package on the
CPU: the builder (``add_joint_distance``, ``add_joint_cable``,
``add_rod(joint="cable")``, ``add_rod_graph`` with ball and cable joints),
FK and IK of their layouts, the cables' compliant rows in SolverXPBD's
joint sweep and ``cable_velocity_pass``, Dahl friction
(``friction_model="dahl"``), and the ball-jointed rod graph under
SolverFeatherstone (tests/test_solvers.py:211); the JAX package's gates of
tests/test_cable.py:45-102 and tests/test_dahl_friction.py:45-77 on the
port. On a CUDA card: the cable pile's substep on the card against the
CPU and two card runs of it bit for bit.

Tolerances: body_q and joint_q atol = rtol = 2e-4, body_qd and joint_qd
5e-3 (tests/test_batched_step.py:69-75); one joint sweep and one damping
pass 1e-5; the gates are the JAX tests'.

JAX is imported inside the tests, so the GPU cases collect where JAX is
absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_cable.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.math import quat_mul

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 43-44)
from test_torch_free_bodies import _pair, _port_state  # noqa: E402

torch.set_num_threads(1)

QTOL, QDTOL = 2e-4, 5e-3
gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cantilever(lib, bend_ke=5.0):
    """tests/test_cable.py:32: six cable segments from (0, 0, 1) to
    (0.6, 0, 1), fixed root."""
    b = lib.ModelBuilder(gravity=-9.81)
    b.add_rod([0, 0, 1.0], [0.6, 0, 1.0], segments=6, radius=0.01,
              joint="cable", bend_ke=bend_ke, bend_kd=0.4, stretch_ke=2.0e4,
              stretch_kd=1.0, root_joint="fixed")
    return b


def _graph(joint):
    def make(lib):
        b = lib.ModelBuilder()
        pts = [[0, 0, 1], [0.5, 0, 1], [1.0, 0.3, 1], [1.0, -0.3, 1]]
        b.add_rod_graph(pts, [(0, 1), (1, 2), (1, 3)], bend_ke=50.0,
                        joint=joint)
        return b
    return make


def _distance_scene(lib):
    """A free sphere with a second hanging from it by a distance joint."""
    b = lib.ModelBuilder()
    a = b.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1])
    b.add_shape_sphere(a, radius=0.05)
    b.add_joint_free(a)
    c = b.add_body(xform=[0.3, 0, 0.8, 0, 0, 0, 1])
    b.add_shape_sphere(c, radius=0.05)
    b.add_joint_distance(a, c, min_distance=0.2, max_distance=0.5)
    return b


def _compare(make, solver_kind, substeps, dt, fk=True, state=None,
             pipe=False, **kw):
    """``substeps`` of ``make(lib)`` on both packages from the FK state
    (or the given JAX state), every substep's body_q, body_qd, joint_q and
    joint_qd held to the tolerances; returns the port's model, solver and
    state."""
    import jax
    import newton_tpu.solvers as js
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    jm, tm = _pair(make)
    cls = {"xpbd": "SolverXPBD", "featherstone": "SolverFeatherstone"}
    jsol = getattr(js, cls[solver_kind])(jm, **kw)
    tsol = getattr(nt, cls[solver_kind])(tm, **kw)
    jst = state
    if jst is None:
        jst = (j_eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state()) if fk
               else jm.state())
    if hasattr(jsol, "init_state"):
        jst = jsol.init_state(jst)
    tst = _port_state(jst)
    if hasattr(tsol, "init_state"):
        tst = tsol.init_state(tst)
    # static mode: the pile's 440 candidate pairs would pick the JAX
    # package's dynamic mode, which the port does not have (ROADMAP A.5)
    jp = JPipe(jm, mode="static") if pipe else None
    tp = nt.CollisionPipeline(tm, mode="static") if pipe else None
    step = jax.jit(lambda s: jsol.step(s, None, None,
                                       jp.collide(s) if pipe else None, dt))
    for k in range(substeps):
        jst = step(jst)
        tst = tsol.step(tst, None, None, tp.collide(tst) if pipe else None,
                        dt)
        for name, tol in (("body_q", QTOL), ("body_qd", QDTOL),
                          ("joint_q", QTOL), ("joint_qd", QDTOL)):
            np.testing.assert_allclose(
                getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
                atol=tol, rtol=tol, err_msg=f"{name}, substep {k}")
    return tm, tsol, tst, jst


def test_cable_builder_dof_layout():
    """tests/test_cable.py:45 on the port: the six stiffness slots [shear,
    shear, stretch, bend, bend, twist], no coordinates, shear and twist
    defaulting to stretch and bend."""
    b = nt.ModelBuilder()
    b0 = b.add_body(xform=np.array([0, 0, 0, 0, 0, 0, 1.0]))
    b1 = b.add_body(xform=np.array([0, 0, 0.5, 0, 0, 0, 1.0]))
    j = b.add_joint_cable(b0, b1, stretch_stiffness=100.0,
                          shear_stiffness=50.0, bend_stiffness=2.0,
                          twist_stiffness=0.5, bend_damping=0.25)
    assert b.joint_type[j] == int(nt.JointType.CABLE)
    d0 = b.joint_qd_start[j]
    assert b.joint_target_ke[d0:d0 + 6] == [50.0, 50.0, 100.0, 2.0, 2.0, 0.5]
    assert b.joint_q_start[j + 1] == b.joint_q_start[j]
    j2 = b.add_joint_cable(b0, b1, stretch_stiffness=10.0,
                           bend_stiffness=3.0, bend_damping=0.5)
    d2 = b.joint_qd_start[j2]
    assert b.joint_target_ke[d2:d2 + 6] == [10.0, 10.0, 10.0, 3.0, 3.0, 3.0]
    assert b.joint_target_kd[d2 + 5] == 0.5


@pytest.mark.parametrize("make", [
    _cantilever, _graph("ball"), _graph("cable"), _distance_scene,
    lambda lib: cs.dahl_scene(lib, 2)[0],
    lambda lib: cs.cable_pile_scene(lib, 1)],
    ids=["cable rod", "ball graph", "cable graph", "distance", "dahl",
         "pile"])
def test_builder_matches_jax(make):
    """Every joint, dof and body table of the distance and cable scenes
    equals the JAX builder's, and so does FK from joint_q0 and IK of it."""
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.articulation import eval_ik as j_eval_ik
    jm, _ = _pair(make)
    tm = make(nt).finalize("cpu")
    st_j, st_t = jm.structure, tm.structure
    for name in ("joint_type", "joint_parent", "joint_child",
                 "joint_q_start", "joint_qd_start", "joint_dof_dim",
                 "joint_parent_joint", "articulation_start"):
        np.testing.assert_array_equal(np.asarray(getattr(st_t, name)),
                                      np.asarray(getattr(st_j, name)), name)
    for name in ("joint_X_p", "joint_X_c", "joint_axis", "joint_q0",
                 "joint_target_ke", "joint_target_kd", "joint_limit_lower",
                 "joint_limit_upper", "body_q", "body_mass", "body_com",
                 "body_inertia", "shape_scale", "shape_transform"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
    js = j_eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state())
    ts = nt.eval_fk(tm, tm.joint_q0, tm.joint_qd0, tm.state())
    np.testing.assert_allclose(ts.body_q.numpy(), np.asarray(js.body_q),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(nt.eval_ik(tm, ts), j_eval_ik(jm, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def test_cable_sweep_and_damping_match_jax():
    """One joint sweep (the cables' stretch, shear, bend and twist rows
    into every body, with the averaging counts) and one
    cable_velocity_pass at a perturbed pose of the cantilever, against
    the JAX package's (1e-5)."""
    import jax.numpy as jnp
    from newton_tpu.math import quat_rotate as jqr
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.solvers import SolverXPBD as JXPBD
    jm, tm = _pair(_cantilever)
    jsol, tsol = JXPBD(jm, iterations=8), nt.SolverXPBD(tm, iterations=8)
    rng = np.random.RandomState(0)
    bq = np.asarray(j_eval_fk(jm, jm.joint_q0, jm.joint_qd0,
                              jm.state()).body_q).copy()
    bq[:, :3] += 0.01 * rng.randn(6, 3)
    q = bq[:, 3:] + 0.05 * rng.randn(6, 4)
    bq[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    bq = bq.astype(np.float32)
    x = jnp.asarray(bq[:, :3]) + jqr(jnp.asarray(bq[:, 3:]), jm.body_com)
    dt = 1.0 / 960.0
    dx, dth, nc = jsol._plan.solve_joints(jm, x, jnp.asarray(bq[:, 3:]), dt,
                                          0.0, 0.0, None)
    xt = torch.as_tensor(np.asarray(x))
    qt = torch.as_tensor(bq[:, 3:])
    p = tsol._plan
    acc = p.sums(0)[1](p.solve_joints(tm, xt, qt, p.inv_inertia_world(tm, qt),
                                      dt, 0.0, 0.0, None))
    for got, ref in ((acc[:, 0:3], dx), (acc[:, 3:6], dth), (acc[:, 6], nc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
    v = rng.randn(6, 3).astype(np.float32)
    w = rng.randn(6, 3).astype(np.float32)
    jv, jw = jsol._plan.cable_velocity_pass(jm, x, jnp.asarray(bq[:, 3:]),
                                            jnp.asarray(v), jnp.asarray(w),
                                            dt)
    tv, tw = p.cable_velocity_pass(tm, xt, qt, torch.as_tensor(v),
                                   torch.as_tensor(w), dt)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5,
                               rtol=1e-5)


def test_cantilever_matches_jax():
    """The cantilever under SolverXPBD(iterations=8) at dt 1/960: 8
    substeps against the JAX package."""
    _compare(_cantilever, "xpbd", 8, 1.0 / 960.0, iterations=8)


@pytest.mark.parametrize("joint", ["ball", "cable"])
def test_rod_graph_matches_jax_under_xpbd(joint):
    """tests/test_solvers.py:211's branching graph (free root, ball or
    cable joints at the shared points) under SolverXPBD(iterations=4):
    12 substeps of free fall against the JAX package."""
    _compare(_graph(joint), "xpbd", 12, 1.0 / 480.0, iterations=4)


def test_rod_graph_matches_jax_under_featherstone():
    """tests/test_solvers.py:211 on the port: the ball-jointed graph under
    SolverFeatherstone, 16 substeps of 1/480 against the JAX package; after
    the JAX test's 240 substeps the state is finite."""
    tm, solver, s, _ = _compare(_graph("ball"), "featherstone", 16,
                                1.0 / 480.0)
    for _ in range(224):
        s = solver.step(s, None, tm.control(), None, 1.0 / 480.0)
    assert bool(torch.isfinite(s.body_q).all())


def test_distance_joint_matches_jax():
    """A distance joint has a free joint's layout and constrains nothing
    under SolverXPBD, as in the JAX package (16 substeps), and steps under
    SolverFeatherstone as a free joint (8 substeps)."""
    _compare(_distance_scene, "xpbd", 16, 1.0 / 240.0, iterations=4)
    _compare(_distance_scene, "featherstone", 8, 1.0 / 240.0)


def test_cable_pile_matches_jax():
    """example_cable_pile.py (one world, every candidate pair in static
    mode): 8 substeps of the drop under SolverXPBD(iterations=6) against
    the JAX package."""
    _compare(lambda lib: cs.cable_pile_scene(lib, 1), "xpbd", 8,
             1.0 / 240.0, fk=False, pipe=True, iterations=6)


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


def _dahl_box(lib):
    return cs.dahl_box_scene(lib, 1)


def test_dahl_matches_jax():
    """A box sliding at 2 m/s on the ground under Dahl friction (sigma
    5e4): 16 substeps against the JAX package, the bristle state too
    (1e-3 of its largest entry)."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverXPBD as JXPBD
    jm, tm = _pair(_dahl_box)
    kw = dict(iterations=4, friction_model="dahl", dahl_sigma=5.0e4)
    jsol, tsol = JXPBD(jm, **kw), nt.SolverXPBD(tm, **kw)
    qd = np.zeros((1, 6), np.float32)
    qd[0, 0] = 2.0
    jst = jsol.init_state(jm.state()).replace(body_qd=jnp.asarray(qd))
    tst = tsol.init_state(_port_state(jst))
    jp, tp = JPipe(jm), nt.CollisionPipeline(tm)
    step = jax.jit(lambda s: jsol.step(s, None, None, jp.collide(s),
                                       1.0 / 240.0))
    for k in range(16):
        jst = step(jst)
        tst = tsol.step(tst, None, None, tp.collide(tst), 1.0 / 240.0)
        for name, tol in (("body_q", QTOL), ("body_qd", QDTOL)):
            np.testing.assert_allclose(
                getattr(tst, name).numpy(), np.asarray(getattr(jst, name)),
                atol=tol, rtol=tol, err_msg=f"{name}, substep {k}")
        ref = np.asarray(jst.custom["xpbd:dahl_f"])
        np.testing.assert_allclose(
            tst.custom["xpbd:dahl_f"].numpy(), ref, rtol=0,
            atol=1e-3 * max(float(np.abs(ref).max()), 1.0),
            err_msg=f"dahl_f, substep {k}")


def _push(solver, pipe, state, frames, force=None):
    xs = []
    for _ in range(frames):
        for _ in range(4):
            if force is not None:
                state.body_f[0, 0] = force
            state = solver.step(state, None, None, pipe.collide(state),
                                1.0 / 240.0)
        xs.append(float(state.body_q[0, 0]))
    return state, np.asarray(xs)


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


@gpu
def test_cable_pile_on_card_matches_cpu(cuda):
    """The cable pile x 16 worlds: 4 substeps on the card against the CPU
    (2e-4 / 5e-3) and two card runs of a substep bit for bit."""
    out = {}
    for dev in (cuda, "cpu"):
        m = cs.cable_pile_scene(nt, 16).finalize(dev)
        pipe = nt.CollisionPipeline(m, mode="static")
        solver = nt.SolverXPBD(m, iterations=6)
        s = m.state()
        for _ in range(4):
            s = solver.step(s, None, None, pipe.collide(s), 1.0 / 240.0)
        out[str(dev)] = s
        if dev != "cpu":
            a = solver.step(s, None, None, pipe.collide(s), 1.0 / 240.0)
            b = solver.step(s, None, None, pipe.collide(s), 1.0 / 240.0)
            assert torch.equal(a.body_q, b.body_q)
            assert torch.equal(a.body_qd, b.body_qd)
    for name, tol in (("body_q", QTOL), ("body_qd", QDTOL)):
        np.testing.assert_allclose(getattr(out[str(cuda)], name).cpu(),
                                   getattr(out["cpu"], name), atol=tol,
                                   rtol=tol)
