"""``SolverXPBD``'s rigid-body path in the port against the JAX package on
the CPU: ``integrate_bodies`` and ``eval_ik`` on the ant, the humanoid,
the hopper (a D6 root with linear axes) and the rod (ball joints);
``SolverXPBD.step`` on the replicated ant with direct ctrl (``bench.py
--solver xpbd``), the domino spiral, the two-box stack, the pendulum and
revolute, prismatic (limits and drives), ball and fixed joints;
the JAX package's XPBD physics gates on the port; the features that are
not ported raise. On a CUDA card: the step on the card against the CPU,
and two runs of one substep on the card against each other.

Tolerances: integrate_bodies and eval_ik 1e-5 (float32 transform
chains); ``step`` body_q and joint_q atol = rtol = 2e-4, joint_qd and
body_qd 5e-3 (tests/test_batched_step.py:69-75); the contact force
report 1e-3 of its largest entry (impulses accumulated over 8 Jacobi
sweeps); the physics gates are tests/test_solvers.py's. On the card:
the step against the CPU at the same tolerances, and two runs of a
substep on the card equal bit for bit (every sum in a fixed order).

JAX is imported inside the fixtures and tests, so the GPU cases collect
where JAX is absent (the card's machine)::

    python -m pytest -o addopts="" --noconftest -m gpu tests/test_torch_xpbd.py
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.solvers import integrate_bodies
from newton_tpu_torch.utils import bridge

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phases 21-23)

torch.set_num_threads(1)

DT = 1.0 / 240.0
ATOL = 1e-5
gpu = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax_model_to_numpy(jm):
    from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, \
        MODEL_INT_FIELDS
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


def _robot(lib, name):
    if name == "rod":
        return cs.rod_scene(lib, 2)[0]
    b = lib.ModelBuilder()
    b.add_mjcf(os.path.join(nt.ASSET_DIR, f"{name}.xml"))
    return b


def _state_pair(jm, tm, seed, acc=5.0):
    """The same perturbed FK state on both sides, with random twists and
    wrenches of each body's scale (about ``acc`` m/s^2 and rad/s^2)."""
    import jax.numpy as jnp
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    rng = np.random.RandomState(seed)
    q = np.asarray(jm.joint_q0).copy()
    q = q + 0.1 * rng.randn(*q.shape).astype(np.float32)
    qd = 0.5 * rng.randn(*np.asarray(jm.joint_qd0).shape).astype(np.float32)
    js = j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state())
    B = jm.body_count
    scale = np.concatenate([np.repeat(np.asarray(jm.body_mass)[:, None], 3,
                                      1),
                            np.diagonal(np.asarray(jm.body_inertia),
                                        axis1=1, axis2=2)], 1)
    f = (acc * scale * rng.randn(B, 6)).astype(np.float32)
    js = js.replace(body_f=jnp.asarray(f))
    ts = bridge.state_from_numpy(
        {n: np.asarray(getattr(js, n)) for n in bridge.STATE_FIELDS}, "cpu")
    return js, ts


@pytest.fixture(scope="module", params=["ant", "humanoid", "hopper", "rod"])
def robot(request):
    """The JAX package's model of each robot, and the same model on the
    port through the bridge."""
    import newton_tpu as jt
    jm = _robot(jt, request.param).finalize()
    return jm, bridge.model_from_numpy(*_jax_model_to_numpy(jm), "cpu")


def test_integrate_bodies_matches_jax(robot):
    """Semi-implicit Euler with the gyroscopic term, gravity and angular
    damping: body_q and body_qd within 1e-5 of the JAX package's."""
    from newton_tpu.solvers.solver import integrate_bodies as j_integrate
    jm, tm = robot
    js, ts = _state_pair(jm, tm, 0)
    ref = j_integrate(jm, js, DT, 0.05)
    got = integrate_bodies(tm, ts, DT, 0.05)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


def test_eval_ik_matches_jax(robot):
    """Maximal -> generalized coordinates of every joint type on the
    robot (free, revolute, D6 with angular and linear axes, ball, fixed):
    joint_q and joint_qd within 1e-5 of the JAX package's ``eval_ik``,
    and the FK of the port's result gives back the bodies."""
    from newton_tpu.sim.articulation import eval_ik as j_eval_ik
    jm, tm = robot
    js, ts = _state_pair(jm, tm, 1)
    ref = j_eval_ik(jm, js)
    got = nt.eval_ik(tm, ts)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=0)


# ----------------------------------------------------------------------
# SolverXPBD.step
# ----------------------------------------------------------------------
def _ant_scene(lib, n=4):
    r = lib.ModelBuilder()
    r.add_mjcf(os.path.join(nt.ASSET_DIR, "ant.xml"))
    b = lib.ModelBuilder()
    b.replicate(r, n)
    return b


def _box_stack(lib):
    """tests/test_solvers.py's two-box stack: unit boxes, the top one 0.1
    off in x and 5 cm into the base, on a ground plane."""
    b = lib.ModelBuilder()
    base = b.add_body(xform=[0, 0, 0.5, 0, 0, 0, 1])
    top = b.add_body(xform=[0.1, 0, 1.45, 0, 0, 0, 1])
    for body in (base, top):
        b.add_shape_box(body, hx=0.5, hy=0.5, hz=0.5)
        b.add_joint_free(body)
    b.add_ground_plane()
    return b


def _pendulum(lib):
    """tests/test_solvers.py's pendulum: a box link on a revolute joint
    about y, released horizontal."""
    b = lib.ModelBuilder()
    link = b.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1])
    b.add_shape_box(link, hx=0.5, hy=0.05, hz=0.05)
    b.add_joint_revolute(parent=-1, child=link, axis="Y",
                         xform_c=[-0.5, 0, 0, 0, 0, 0, 1], armature=0.0)
    return b


def _joints(lib):
    """A revolute link about y and a prismatic link along x, each with
    limits and a target drive, a ball-jointed link and a fixed one, all
    hanging from the world (example_basic_joints.py's links)."""
    w = lib.ModelBuilder()
    cfg = lib.ShapeConfig(density=1000.0)

    def link(x):
        body = w.add_body(xform=[x, 0, 1.0, 0, 0, 0, 1])
        w.add_shape_capsule(body, radius=0.05, half_height=0.2, cfg=cfg)
        return body
    hinge = [0, 0, 0.3, 0, 0, 0, 1]
    w.add_joint_revolute(-1, link(0.0), axis="Y",
                         xform_p=[0, 0, 1.3, 0, 0, 0, 1], xform_c=hinge,
                         target_ke=50.0, limit_lower=-0.4, limit_upper=0.4)
    w.add_joint_prismatic(-1, link(1.0), axis="X",
                          xform_p=[1.0, 0, 1.0, 0, 0, 0, 1], target_ke=80.0,
                          limit_lower=-0.05, limit_upper=0.1)
    w.add_joint_ball(-1, link(2.0), xform_p=[2.0, 0, 1.3, 0, 0, 0, 1],
                     xform_c=hinge)
    w.add_joint_fixed(-1, link(3.0), xform_p=[3.0, 0, 1.0, 0, 0, 0, 1])
    return w


def _sphere(lib):
    b = lib.ModelBuilder()
    body = b.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1])
    b.add_shape_sphere(body, radius=0.5)
    b.add_joint_free(body)
    b.add_ground_plane()
    return b


SCENES = {
    "ant x 4": (_ant_scene, 8), "domino spiral": (None, 4),
    "box stack": (_box_stack, 8), "pendulum": (_pendulum, 4),
    "joints and drives": (_joints, 4),
}


def _ant_ctrl(model, rng):
    """bench.py --solver xpbd's direct actuation: joint_f = ctrl * gear,
    ctrl uniform in the ctrl range clipped to [-1, 1]."""
    gear = model.custom["mjc:actuator_gear"]
    lo = torch.clamp(model.custom["mjc:actuator_ctrlrange_lo"], -1.0, 0.0)
    hi = torch.clamp(model.custom["mjc:actuator_ctrlrange_hi"], 0.0, 1.0)
    u = torch.as_tensor(rng.rand(gear.shape[0]).astype(np.float32),
                        device=gear.device)
    return (lo + u * (hi - lo)) * gear


@pytest.fixture(scope="module", params=sorted(SCENES))
def xpbd(request):
    """A scene on both sides with its first state (FK of joint_q0; the
    domino spiral's first domino nudged), its control and the JAX step
    jitted."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    from newton_tpu.solvers import SolverXPBD as JX
    name = request.param
    scene, iters = SCENES[name]
    if name == "domino spiral":
        jb, qd = cs.domino_scene(jt, 2)
        tb, _ = cs.domino_scene(nt, 2)
    else:
        jb, tb, qd = scene(jt), scene(nt), None
    jm, tm = jb.finalize(), tb.finalize("cpu")
    qd0 = tm.joint_qd0.clone()
    if name == "joints and drives":
        qd0[0], qd0[1] = 3.0, 1.0        # swing into the limits
    js = j_eval_fk(jm, jm.joint_q0, jnp.asarray(qd0.numpy()), jm.state())
    ts = nt.eval_fk(tm, tm.joint_q0, qd0, tm.state())
    if qd is not None:
        js = js.replace(body_qd=jnp.asarray(qd))
        ts.body_qd = torch.as_tensor(qd)
    tc = jc = None
    if name == "ant x 4":
        tc = tm.control()
        tc.joint_f = _ant_ctrl(tm, np.random.RandomState(0))
        jc = jm.control().replace(joint_f=jnp.asarray(tc.joint_f.numpy()))
    elif name == "pendulum":
        tc, jc = tm.control(), jm.control()
    elif name == "joints and drives":
        tc = tm.control()
        tc.joint_target_q[0], tc.joint_target_q[1] = 0.3, 0.05
        jc = jm.control().replace(
            joint_target_q=jnp.asarray(tc.joint_target_q.numpy()))
    jsol = JX(jm, iterations=iters)
    jp = JPipe(jm) if jm.structure.rigid_contact_max else None
    tp = nt.CollisionPipeline(tm) if jp is not None else None

    def jstep(s):
        return jsol.step_with_contacts(
            s, None, jc, jp.collide(s) if jp is not None else None, DT)
    return dict(name=name, jm=jm, tm=tm, js=js, ts=ts, tc=tc, tp=tp,
                tsol=nt.SolverXPBD(tm, iterations=iters),
                jstep=jax.jit(jstep))


def _assert_states(got, ref, q_atol=2e-4, qd_atol=5e-3):
    for name, atol in (("joint_q", q_atol), ("body_q", q_atol),
                       ("joint_qd", qd_atol), ("body_qd", qd_atol)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=atol, err_msg=name)


@pytest.mark.parametrize("substeps", [1, 4])
def test_xpbd_step_matches_jax(xpbd, substeps):
    """``SolverXPBD.step`` on the flat state against the JAX package's,
    1 and 4 substeps (collide each substep); the contact force report of
    ``step_with_contacts`` within 1e-3 of its largest entry."""
    p = xpbd
    js, ts = p["js"], p["ts"]
    for _ in range(substeps):
        contacts = p["tp"].collide(ts) if p["tp"] is not None else None
        ts, tcon = p["tsol"].step_with_contacts(ts, None, p["tc"], contacts,
                                                DT)
        js, jcon = p["jstep"](js)
    _assert_states(ts, js)
    if contacts is not None:
        ref = np.asarray(jcon.rigid_contact_force)
        np.testing.assert_allclose(tcon.rigid_contact_force.numpy(), ref,
                                   atol=1e-3 * max(np.abs(ref).max(), 1.0),
                                   rtol=0)
        if p["name"] in ("box stack", "domino spiral"):
            assert np.abs(ref).max() > 0      # resting contacts report


def _roll(model, solver, frames, substeps=4, pipe=True, qd=None):
    s = nt.eval_fk(model, model.joint_q0, model.joint_qd0, model.state())
    if qd is not None:
        s.body_qd = torch.as_tensor(qd)
    pipeline = nt.CollisionPipeline(model) if pipe else None
    ctl = model.control()
    traj = []
    for _ in range(frames):
        for _ in range(substeps):
            contacts = pipeline.collide(s) if pipe else None
            s = solver.step(s, None, ctl, contacts, DT)
        traj.append(s.body_q.numpy().copy())
    return s, np.stack(traj)


def _assert_finite(s):
    for name in ("body_q", "body_qd", "joint_q", "joint_qd"):
        assert torch.isfinite(getattr(s, name)).all(), name
    qn = torch.linalg.vector_norm(s.body_q[:, 3:7], dim=-1)
    np.testing.assert_allclose(qn.numpy(), 1.0, atol=1e-3)


def test_xpbd_sphere_rests_on_ground():
    """tests/test_solvers.py:61 on the port: a sphere of radius 0.5
    dropped from z = 1 rests at z = 0.5 (+-0.02) after 0.5 s."""
    m = _sphere(nt).finalize("cpu")
    s, _ = _roll(m, nt.SolverXPBD(m, iterations=2), 120)
    _assert_finite(s)
    assert abs(float(s.body_q[0, 2]) - 0.5) < 0.02


def test_xpbd_pendulum_envelope():
    """tests/test_solvers.py:69 on the port: the pendulum released
    horizontal stays within z in (-0.51, 0.05), |x| < 0.51, its COM 0.5
    from the pivot (5e-3), for 0.25 s."""
    m = _pendulum(nt).finalize("cpu")
    s, traj = _roll(m, nt.SolverXPBD(m, iterations=4), 60, pipe=False)
    _assert_finite(s)
    z, x = traj[:, 0, 2], traj[:, 0, 0]
    assert z.min() > -0.51 and z.max() < 0.05
    assert np.abs(x).max() < 0.51
    np.testing.assert_allclose(np.linalg.norm(traj[:, 0, :3], axis=-1), 0.5,
                               atol=5e-3)


def test_xpbd_dynamic_dynamic_box_stack():
    """tests/test_solvers.py:275 on the port: the offset box on a box,
    starting 5 cm into it, settles stacked after 2 s (base z 0.5 +-0.05,
    top 1.5 +-0.08)."""
    m = _box_stack(nt).finalize("cpu")
    s, _ = _roll(m, nt.SolverXPBD(m, iterations=8), 120)
    q = s.body_q.numpy()
    assert np.isfinite(q).all()
    assert abs(q[0, 2] - 0.5) < 0.05 and abs(q[1, 2] - 1.5) < 0.08, q[:, 2]


def test_xpbd_unported_features_raise():
    """Batched contacts and compliant (hydroelastic) contacts raise, naming
    themselves, and so does an unknown friction model. Particles, cable
    joints and Dahl friction, which raised before they were ported, build
    and step (their parity with the JAX package is in
    tests/test_torch_xpbd_particles.py and tests/test_torch_cable.py)."""
    b = nt.ModelBuilder()
    b.add_particle([0.0, 0.0, 1.0])
    pm = b.finalize("cpu")
    ps = nt.SolverXPBD(pm).step(pm.state(), None, None, None, DT)
    assert float(ps.particle_q[0, 2]) < 1.0
    m = _pendulum(nt).finalize("cpu")
    dahl = nt.SolverXPBD(m, friction_model="dahl")
    assert "xpbd:dahl_f" in dahl.init_state(m.state()).custom
    with pytest.raises(ValueError, match="friction_model"):
        nt.SolverXPBD(m, friction_model="viscous")
    rod = nt.ModelBuilder()
    rod.add_rod([0, 0, 1], [1, 0, 1], joint="cable")
    rm = rod.finalize("cpu")
    rs = nt.SolverXPBD(rm).step(rm.state(), None, None, None, DT)
    assert bool(torch.isfinite(rs.body_q).all())
    with pytest.raises(NotImplementedError, match="cable"):
        nt.SolverMuJoCo(rm)
    m = _sphere(nt).finalize("cpu")
    solver = nt.SolverXPBD(m)
    s = m.state()
    pipe = nt.CollisionPipeline(m)
    with pytest.raises(ValueError, match="flat"):
        solver.step(nt.batch_state(s, 2), None, None,
                    pipe.collide(nt.batch_state(s, 2)), DT)
    c = pipe.collide(s)
    c.rigid_contact_stiffness = torch.ones(c.rigid_contact_max)
    # compliant (hydroelastic) slots are ported: they step
    assert bool(torch.isfinite(solver.step(s, None, None, c, DT)
                               .body_q).all())


def test_xpbd_step_keeps_body_f_and_inputs():
    """``step`` returns state_in's body_f (the joint forces' wrenches act
    inside the substep only) and leaves its inputs unchanged."""
    m = _pendulum(nt).finalize("cpu")
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    s.body_f = torch.full_like(s.body_f, 0.25)
    before = s.clone()
    c = m.control()
    c.joint_f = torch.ones_like(c.joint_f)
    out = nt.SolverXPBD(m).step(s, None, c, None, DT)
    assert torch.equal(out.body_f, before.body_f)
    for name in ("body_q", "body_qd", "body_f", "joint_q", "joint_qd"):
        assert torch.equal(getattr(s, name), getattr(before, name))
    assert not torch.equal(out.body_q, s.body_q)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _card_case(name, dev):
    if name == "ant":
        b, qd = _ant_scene(nt, 16), None
    else:
        b, qd = cs.domino_scene(nt, 16)
    m = b.finalize(dev)
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    if qd is not None:
        s.body_qd = torch.as_tensor(qd, device=dev)
    c = m.control()
    if name == "ant":
        c.joint_f = _ant_ctrl(m, np.random.RandomState(0)).to(dev)
    return m, s, c


@gpu
@pytest.mark.parametrize("name", ["ant", "domino"])
def test_xpbd_step_on_card_matches_cpu(cuda, name):
    """Four substeps of the ant x 16 (direct ctrl) and the domino spiral
    x 16 on the card equal the same on the CPU (body_q/joint_q 2e-4,
    joint_qd/body_qd 5e-3); two runs of one substep on the card are equal
    bit for bit (every sum in a fixed order)."""
    m, s, c = _card_case(name, cuda)
    mc, sc, cc = _card_case(name, "cpu")
    iters = 8 if name == "ant" else 4
    solver, solver_c = (nt.SolverXPBD(x, iterations=iters) for x in (m, mc))
    pipe, pipe_c = nt.CollisionPipeline(m), nt.CollisionPipeline(mc)
    for _ in range(4):
        s = solver.step(s, None, c, pipe.collide(s), DT)
        sc = solver_c.step(sc, None, cc, pipe_c.collide(sc), DT)
    for name_, atol in (("joint_q", 2e-4), ("body_q", 2e-4),
                        ("joint_qd", 5e-3), ("body_qd", 5e-3)):
        torch.testing.assert_close(getattr(s, name_).cpu(),
                                   getattr(sc, name_), atol=atol, rtol=atol)
    contacts = pipe.collide(s)
    a = solver.step(s, None, c, contacts, DT)
    b = solver.step(s, None, c, contacts, DT)
    for name_ in ("body_q", "body_qd", "joint_q", "joint_qd"):
        assert torch.equal(getattr(a, name_), getattr(b, name_)), name_
