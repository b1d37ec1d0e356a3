"""The port's ArticulationView and world reset against the JAX package's
on the same inputs: ``test_selection.py``'s 4-world scene (a free base
and a revolute arm, and a global ball outside the worlds) through every
getter and setter, with masks; attribute access by frequency; masked FK;
gains; the view's mass matrices, Jacobians and inverse dynamics and
``eval_dense_jacobian_rows`` on two gymnasium ants; ``Solver.reset``
with a mask. Tolerances: gathers and writes bit for bit; FK float32
1e-5; dynamics 1e-4 absolute and relative (CRBA and RNEA sums in other
orders; bias forces of order 10 N m)."""

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.sim import dynamics_api as dyn
from newton_tpu_torch.utils import ArticulationView, match_labels

torch.set_num_threads(1)
DYN_TOL = dict(atol=1e-4, rtol=1e-4)
ROBOTS = "articulation_*"              # the four robots, not the ball


def _robot_scene(lib, ball=True):
    robot = lib.ModelBuilder()
    root = robot.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1], key="base")
    robot.add_shape_sphere(root, radius=0.2)
    robot.add_joint_free(root)
    arm = robot.add_body(xform=[0.5, 0, 1.0, 0, 0, 0, 1], key="arm")
    robot.add_shape_capsule(arm, radius=0.05, half_height=0.2)
    robot.add_joint_revolute(parent=root, child=arm, axis="Z",
                             xform_p=[0.25, 0, 0, 0, 0, 0, 1],
                             xform_c=[-0.25, 0, 0, 0, 0, 0, 1])
    b = lib.ModelBuilder()
    b.replicate(robot, 4)
    if ball:
        # a global body (world -1), outside every world, an articulation
        # of its own
        b.add_articulation(key="ball")
        g = b.add_body(xform=[2.0, 0, 0.5, 0, 0, 0, 1], key="ball")
        b.add_shape_sphere(g, radius=0.1)
        b.add_joint_free(g)
    return b


@pytest.fixture(scope="module")
def scene():
    """(JAX model, port model, JAX state, port state) at a random state."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_fk
    jm, tm = _robot_scene(jt).finalize(), _robot_scene(nt).finalize("cpu")
    rng = np.random.default_rng(6)
    q = np.asarray(jm.joint_q0).copy()
    q[7::8][:4] += rng.uniform(-1, 1, 4)
    qd = rng.normal(0, 1, jm.joint_dof_count).astype(np.float32)
    js = j_fk(jm, jnp.asarray(q, jnp.float32), jnp.asarray(qd), jm.state())
    # the port's state holds the JAX state's values (FK may differ in the
    # last bit; the accessors are held bit for bit)
    ts = nt.State(**{**vars(tm.state()), **{
        f: torch.as_tensor(np.asarray(getattr(js, f)))
        for f in ("joint_q", "joint_qd", "body_q", "body_qd")}})
    return jm, tm, js, ts


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               **(tol or dict(atol=1e-5, rtol=1e-5)))


def test_match_labels():
    from newton_tpu.utils.selection import match_labels as j_match
    keys = ["world_0/robot", "world_1/robot", "other", "r2d2"]
    for pat in ("*robot", [0, 2], "other", ["other", "*_1/*"], r"^r\d",
                None, "*", "nothing"):
        assert match_labels(keys, pat) == j_match(keys, pat)


def test_view_getters_match_jax(scene):
    from newton_tpu.utils.selection import ArticulationView as JV
    jm, tm, js, ts = scene
    jv, tv = JV(jm, ROBOTS), ArticulationView(tm, ROBOTS)
    assert (tv.count, tv.joint_dof_count, tv.joint_coord_count,
            tv.link_count, tv.root_is_free, tv.joint_names) == (
        jv.count, jv.joint_dof_count, jv.joint_coord_count, jv.link_count,
        jv.root_is_free, jv.joint_names)
    for name in ("dof_idx", "coord_idx", "link_idx", "joint_idx",
                 "shape_idx", "root_body"):
        _eq(getattr(tv, name).cpu(), getattr(jv, name))
    jc, tc = jm.control(), tm.control()
    for fn in ("get_dof_positions", "get_dof_velocities",
               "get_root_transforms", "get_root_velocities",
               "get_link_transforms", "get_link_velocities"):
        _eq(getattr(tv, fn)(ts), getattr(jv, fn)(js))
    for fn in ("get_dof_forces", "get_dof_position_targets",
               "get_dof_velocity_targets"):
        _eq(getattr(tv, fn)(tc), getattr(jv, fn)(jc))
    for g, r in zip(tv.get_dof_limits() + tv.get_gains(),
                    jv.get_dof_limits() + jv.get_gains()):
        _eq(g, r)
    for name, src in (("joint_armature", "model"), ("body_mass", "model"),
                      ("joint_q", "state"), ("body_qd", "state"),
                      ("shape_material_mu", "model")):
        t_src, j_src = (tm, jm) if src == "model" else (ts, js)
        _eq(tv.get_attribute(name, t_src), jv.get_attribute(name, j_src))
    with pytest.raises(AttributeError):
        tv.get_attribute("no_such_thing", tm)


def test_view_setters_with_masks_match_jax(scene):
    import jax.numpy as jnp
    from newton_tpu.utils.selection import ArticulationView as JV
    jm, tm, js, ts = scene
    jv, tv = JV(jm, ROBOTS), ArticulationView(tm, ROBOTS)
    rng = np.random.default_rng(7)
    mask = np.array([True, False, True, False])
    jc, tc = jm.control(), tm.control()
    for fn, get, shape, src in (
            ("set_dof_positions", "get_dof_positions", (4, 8), "state"),
            ("set_dof_velocities", "get_dof_velocities", (4, 7), "state"),
            ("set_root_transforms", "get_root_transforms", (4, 7), "state"),
            ("set_root_velocities", "get_root_velocities", (4, 6), "state"),
            ("set_dof_forces", "get_dof_forces", (4, 7), "control")):
        x = rng.normal(0, 1, shape).astype(np.float32)
        for m in (None, mask):
            js_, ts_ = (js, ts) if src == "state" else (jc, tc)
            jm_ = None if m is None else jnp.asarray(m)
            tm_ = None if m is None else torch.as_tensor(m)
            jout = getattr(jv, fn)(js_, jnp.asarray(x), mask=jm_)
            tout = getattr(tv, fn)(ts_, torch.as_tensor(x), mask=tm_)
            for f in ("joint_q", "joint_qd", "body_q", "body_qd",
                      "joint_f"):
                if hasattr(tout, f):
                    _eq(getattr(tout, f), getattr(jout, f))
    x = rng.normal(0, 1, (4, 8)).astype(np.float32)
    _eq(tv.set_dof_position_targets(tc, torch.as_tensor(x)).joint_target_q,
        jv.set_dof_position_targets(jc, jnp.asarray(x)).joint_target_q)
    x = rng.normal(0, 1, (4, 7)).astype(np.float32)
    _eq(tv.set_dof_velocity_targets(tc, torch.as_tensor(x)).joint_target_qd,
        jv.set_dof_velocity_targets(jc, jnp.asarray(x)).joint_target_qd)
    # attributes by frequency, with a mask, on a model and a state
    x = rng.uniform(0.1, 1.0, (4, 2)).astype(np.float32)
    _eq(tv.set_attribute("body_mass", tm, torch.as_tensor(x),
                         mask=torch.as_tensor(mask)).body_mass,
        jv.set_attribute("body_mass", jm, jnp.asarray(x),
                         mask=jnp.asarray(mask)).body_mass)
    x = rng.normal(0, 1, (4, 8)).astype(np.float32)
    _eq(tv.set_attribute("joint_q", ts, torch.as_tensor(x)).joint_q,
        jv.set_attribute("joint_q", js, jnp.asarray(x)).joint_q)
    assert torch.equal(ts.joint_q, torch.as_tensor(np.asarray(js.joint_q)))
    # gains: a new Model, kept as view.model
    m2, jm2 = tv.set_gains(kp=100.0, kd=5.0), jv.set_gains(kp=100.0, kd=5.0)
    assert tv.model is m2 and m2 is not tm
    _eq(m2.joint_target_ke, jm2.joint_target_ke)
    _eq(m2.joint_target_kd, jm2.joint_target_kd)


def test_masked_fk_and_view_subset_match_jax(scene):
    import jax.numpy as jnp
    from newton_tpu.utils.selection import ArticulationView as JV
    jm, tm, js, ts = scene
    rng = np.random.default_rng(8)
    for pattern in (ROBOTS, [1, 3]):
        jv, tv = JV(jm, pattern), ArticulationView(tm, pattern)
        n = tv.count
        x = np.asarray(jv.get_root_transforms(js)).copy()
        x[:, 2] += rng.uniform(0.5, 1.5, n)
        js2 = jv.set_root_transforms(js, jnp.asarray(x))
        ts2 = tv.set_root_transforms(ts, torch.as_tensor(x))
        mask = np.arange(n) % 2 == 0
        _eq(tv.articulation_mask(torch.as_tensor(mask)),
            jv.articulation_mask(jnp.asarray(mask)))
        for m in (None, mask):
            jout = jv.eval_fk(js2, None if m is None else jnp.asarray(m))
            tout = tv.eval_fk(ts2, None if m is None else torch.as_tensor(m))
            _close(tout.body_q, jout.body_q)
            _close(tout.body_qd, jout.body_qd, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def ants():
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_fk
    models = []
    for lib in (jt, nt):
        r = lib.ModelBuilder()
        r.add_mjcf(nt.ASSET_DIR + "/ant.xml")
        b = lib.ModelBuilder()
        b.replicate(r, 2)
        models.append(b.finalize() if lib is jt else b.finalize("cpu"))
    jm, tm = models
    rng = np.random.default_rng(9)
    q = np.asarray(jm.joint_q0).copy()
    q.reshape(2, -1)[:, 7:] += rng.uniform(-0.5, 0.5, (2, 8))
    qd = rng.normal(0, 1, jm.joint_dof_count).astype(np.float32)
    js = j_fk(jm, jnp.asarray(q, jnp.float32), jnp.asarray(qd), jm.state())
    ts = nt.eval_fk(tm, torch.as_tensor(q, dtype=torch.float32),
                    torch.as_tensor(qd), tm.state())
    return jm, tm, js, ts, rng


def test_view_dynamics_match_jax(ants):
    """Mass matrices, body Jacobians and inverse dynamics (with and
    without qdd) of the view and of the dynamics API, and Jacobian rows
    at points on the lower legs."""
    import jax.numpy as jnp
    from newton_tpu.sim import dynamics_api as jdyn
    from newton_tpu.utils.selection import ArticulationView as JV
    jm, tm, js, ts, rng = ants
    jv, tv = JV(jm, "*"), ArticulationView(tm, "*")
    _close(tv.eval_mass_matrix(ts), jv.eval_mass_matrix(js), **DYN_TOL)
    _close(tv.eval_jacobian(ts), jv.eval_jacobian(js), **DYN_TOL)
    qdd = rng.normal(0, 1, (2, 14)).astype(np.float32)
    for a in (None, qdd):
        _close(tv.eval_inverse_dynamics(ts, None if a is None else
                                        torch.as_tensor(a)),
               jv.eval_inverse_dynamics(js, None if a is None else
                                        jnp.asarray(a)), **DYN_TOL)
    _close(dyn.eval_inverse_dynamics(tm, ts),
           jdyn.eval_inverse_dynamics(jm, js), **DYN_TOL)
    bodies = np.array([3, 6, 9, 12])
    pts = rng.normal(0, 0.5, (2, 4, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (2, 4, 3)).astype(np.float32)
    _close(dyn.eval_dense_jacobian_rows(tm, ts, torch.as_tensor(pts),
                                        bodies, torch.as_tensor(dirs)),
           jdyn.eval_dense_jacobian_rows(jm, js, jnp.asarray(pts), bodies,
                                         jnp.asarray(dirs)), **DYN_TOL)


def test_view_dynamics_pendulum_analytic():
    """test_selection.py's horizontal rod: M = m L^2 / 3, |tau| = m g L / 2
    (m = 10, L = 1)."""
    sub = nt.ModelBuilder()
    link = sub.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1])
    sub.add_shape_box(link, hx=0.5, hy=0.05, hz=0.05)
    sub.add_joint_revolute(parent=-1, child=link, axis="Y",
                           xform_c=[-0.5, 0, 0, 0, 0, 0, 1], armature=0.0)
    b = nt.ModelBuilder()
    b.replicate(sub, 4)
    m = b.finalize("cpu")
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    view = ArticulationView(m, "*")
    np.testing.assert_allclose(view.eval_mass_matrix(s)[:, 0, 0].numpy(),
                               10 / 3, rtol=0.02)
    assert view.eval_jacobian(s).shape == (4, 1, 6, 1)
    np.testing.assert_allclose(view.eval_inverse_dynamics(s)[:, 0].abs()
                               .numpy(), 49.05, rtol=0.02)


def test_reset_with_mask_matches_jax(scene):
    """Worlds 1 and 3 back at the initial state, 0 and 2 untouched; the
    global ball is reset by every masked reset, even one whose mask is
    all False (the JAX package ORs worlds < 0 into the mask: ROADMAP
    C.38); no mask gives the initial State."""
    import jax.numpy as jnp
    from newton_tpu.solvers import SolverFeatherstone as JS
    jm, tm, js, ts = scene
    jsol, tsol = JS(jm), nt.SolverFeatherstone(tm)
    rng = np.random.default_rng(10)
    # one state on both sides, moved off the initial one
    moved = {f: (np.asarray(getattr(js, f)) + rng.normal(
        0, 0.1, getattr(js, f).shape)).astype(np.float32)
        for f in ("joint_q", "joint_qd", "body_q", "body_qd")}
    js = js.replace(**{f: jnp.asarray(v) for f, v in moved.items()})
    ts = nt.State(**{**vars(ts), **{f: torch.as_tensor(v)
                                    for f, v in moved.items()}})
    for mask in ([False, True, False, True], [False] * 4, None):
        jout = jsol.reset(js, None if mask is None else jnp.asarray(mask))
        tout = tsol.reset(ts, None if mask is None else torch.tensor(mask))
        for f in ("body_q", "body_qd", "joint_q", "joint_qd"):
            _eq(getattr(tout, f), getattr(jout, f))
    ball = tm.structure.body_count - 1
    out = tsol.reset(ts, torch.tensor([False] * 4))
    assert tm.structure.body_world[ball] == -1
    assert torch.equal(out.body_q[ball], tm.body_q[ball])
    assert torch.equal(out.body_q[:ball], ts.body_q[:ball])
