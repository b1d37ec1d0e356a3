"""Equality constraints in the port against the JAX package on the CPU:
the builder's eq leaves (add_equality_constraint, add_constraint_mimic,
replicate, add_builder) and the numpy bridge; CONNECT, WELD and JOINT
rows stepped through ``step`` and ``step_batched`` (Euler and RK4);
tests/test_equality.py's gates on the port; MJCF ``<equality>``; and
the cases the port raises where the JAX planner drops rows or mixes up
indices without a word (ROADMAP C.18).

Tolerances: joint_q and body_q atol 2e-4, joint_qd 5e-3
(tests/test_batched_step.py:69-75); leaves exact; the physics gates are
tests/test_equality.py's.
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.utils import bridge

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes of phase 30)

torch.set_num_threads(1)

DT = 1.0 / 240.0
EQ_LEAVES = ("eq_obj1", "eq_obj2", "eq_anchor", "eq_relpose",
             "eq_polycoef", "eq_enabled", "eq_torquescale")


def _mixed(lib):
    """Two worlds (add_world) of a 3-link chain with a CONNECT, a WELD and
    a mimic, plus replicate x 2 of it: every remap path."""
    w = lib.ModelBuilder()
    prev = -1
    links, joints = [], []
    for i in range(3):
        link = w.add_body(xform=[0.5 + i, 0, 0, 0, 0, 0, 1])
        w.add_shape_capsule(link, radius=0.05, half_height=0.25)
        joints.append(w.add_joint_revolute(
            parent=prev, child=link, axis="Y",
            xform_p=[0.5, 0, 0, 0, 0, 0, 1] if prev >= 0
            else [0, 0, 0, 0, 0, 0, 1], xform_c=[-0.5, 0, 0, 0, 0, 0, 1]))
        links.append(link)
        prev = link
    w.add_equality_constraint(lib.EqType.CONNECT, body1=links[2],
                              body2=links[0], anchor=(0.5, 0.1, 0.0))
    w.add_equality_constraint(lib.EqType.WELD, body1=links[1], body2=-1,
                              relpose=[0, 0, 0, 0, 0.0998, 0, 0.995])
    w.add_constraint_mimic(joints[2], joints[1], multiplier=0.5, offset=0.2)
    b = lib.ModelBuilder()
    b.add_world(w)
    b.add_world(w, xform=[0, 2.0, 0, 0, 0, 0, 1])
    b.replicate(w, 2)
    return b


def _leaves(m):
    return {n: np.asarray(getattr(m, n).cpu() if torch.is_tensor(
        getattr(m, n)) else getattr(m, n)) for n in EQ_LEAVES}


def _jax_bridge(jm):
    from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, \
        MODEL_INT_FIELDS
    leaves = {n: np.asarray(getattr(jm, n))
              for n in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS}
    leaves["eq_enabled"] = np.asarray(jm.eq_enabled)
    leaves["custom"] = {k: np.asarray(v) for k, v in jm.custom.items()}
    st = jm.structure
    structure = {n: getattr(st, n) for n in bridge.STRUCTURE_FIELDS}
    au = st.mjc_actuation
    structure["mjc_actuation"] = None if au is None else {
        n: getattr(au, n) for n in bridge.ACTUATION_FIELDS}
    structure["custom_specs"] = {}
    return bridge.model_from_numpy(leaves, structure, "cpu")


def test_equality_leaves_match_jax():
    import newton_tpu as jt
    jm = _mixed(jt).finalize()
    pm = _mixed(nt).finalize("cpu")
    a, b = _leaves(jm), _leaves(pm)
    for n in EQ_LEAVES:
        np.testing.assert_allclose(b[n], a[n], atol=1e-7, err_msg=n)
    for n in ("eq_count", "eq_type", "eq_world"):
        np.testing.assert_array_equal(getattr(pm.structure, n),
                                      getattr(jm.structure, n))
    assert pm.structure.eq_count == 12


def test_bridge_carries_equality_rows():
    import newton_tpu as jt
    jm = _mixed(jt).finalize()
    bm = _jax_bridge(jm)
    pm = _mixed(nt).finalize("cpu")
    for n in EQ_LEAVES:
        np.testing.assert_array_equal(_leaves(bm)[n], _leaves(pm)[n])
    leaves, structure = bridge.model_to_numpy(pm)
    back = bridge.model_from_numpy(leaves, structure, "cpu")
    for n in EQ_LEAVES:
        np.testing.assert_array_equal(_leaves(back)[n], _leaves(pm)[n])
    np.testing.assert_array_equal(back.structure.eq_type,
                                  pm.structure.eq_type)


def _jax_run(jm, substeps, q0=None, qd0=None, solver_kw=None):
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk
    q0 = jm.joint_q0 if q0 is None else jnp.asarray(q0)
    qd0 = jm.joint_qd0 if qd0 is None else jnp.asarray(qd0)
    s = eval_fk(jm, q0, qd0, jm.state())
    solver = jt.solvers.SolverFeatherstone(jm, **(solver_kw or {}))
    ctrl = jm.control()

    @jax.jit
    def run(s):
        def sub(s, _):
            return solver.step(s, None, ctrl, None, DT), None
        return jax.lax.scan(sub, s, None, length=substeps)[0]
    return run(s)


def _port_run(pm, substeps, q0=None, qd0=None, solver_kw=None):
    q0 = pm.joint_q0 if q0 is None else torch.as_tensor(q0)
    qd0 = pm.joint_qd0 if qd0 is None else torch.as_tensor(qd0)
    s = nt.eval_fk(pm, q0, qd0, pm.state())
    solver = nt.SolverFeatherstone(pm, **(solver_kw or {}))
    ctrl = pm.control()
    for _ in range(substeps):
        s = solver.step(s, None, ctrl, None, DT)
    return s


def _assert_close(t, j):
    for name, tol in (("joint_q", 2e-4), ("body_q", 2e-4),
                      ("joint_qd", 5e-3)):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), atol=tol,
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("kind", ["connect", "mimic", "weld",
                                  "connect_rk4"])
def test_equality_steps_match_jax(kind):
    """Replicated scenes (3 worlds) through step, 40 substeps from a
    kicked start: joint_q/body_q 2e-4, joint_qd 5e-3."""
    import newton_tpu as jt
    base = kind.split("_")[0]
    jb, pb = cs.linkage_scene(jt, 3, base), cs.linkage_scene(nt, 3, base)
    kw = dict(integrator="rk4") if kind.endswith("rk4") else {}
    jm, pm = jb.finalize(), pb.finalize("cpu")
    qd0 = np.zeros(pm.joint_dof_count, np.float32)
    qd0[0] = 1.5
    t = _port_run(pm, 40, qd0=qd0, solver_kw=kw)
    j = _jax_run(jm, 40, qd0=qd0, solver_kw=kw)
    _assert_close(t, j)


def test_equality_step_batched_matches_jax():
    """The CONNECT linkage as a one-world model, 4 kicked envs through
    step_batched against the JAX package's step_batched (its transposed
    batched path), 20 substeps."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.parallel.envs import batch_state as jbatch
    from newton_tpu.sim.articulation import eval_fk
    jm = cs.linkage_scene(jt, 1, "connect").finalize()
    pm = cs.linkage_scene(nt, 1, "connect").finalize("cpu")
    W = 4
    qd = np.zeros((W, 2), np.float32)
    qd[:, 0] = np.linspace(0.5, 2.0, W)
    js = jbatch(eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state()), W)
    js = jax.vmap(lambda s, v: eval_fk(jm, s.joint_q, v, s))(
        js, jnp.asarray(qd))
    jsol = jt.solvers.SolverFeatherstone(jm)
    ps = nt.batch_state(nt.eval_fk(pm, pm.joint_q0, pm.joint_qd0,
                                   pm.state()), W)
    ps = nt.eval_fk(pm, ps.joint_q, torch.as_tensor(qd), ps)
    psol = nt.SolverFeatherstone(pm)
    jstep = jax.jit(lambda s: jsol.step_batched(s, None, None, None, DT))
    for _ in range(20):
        js = jstep(js)
        ps = psol.step_batched(ps, None, None, None, DT)
    _assert_close(ps, js)


def test_connect_parallel_linkage_gate():
    """tests/test_equality.py:56 on the port: after 1 s the anchors stay
    within 5e-3, the joints within 1e-3, and the linkage swung > 0.5."""
    m = cs.linkage_scene(nt, 1, "connect").finalize("cpu")
    s = _port_run(m, 240)
    g = cs.eq_gates("connect", s, 1)
    assert g["drift"] < 5e-3 and g["q_diff"] < 1e-3 and g["q0_min"] > 0.5


def test_mimic_constraint_gate():
    """tests/test_equality.py:70 on the port: |q0 - q1| < 2e-2."""
    m = cs.linkage_scene(nt, 1, "mimic").finalize("cpu")
    s = _port_run(m, 240)
    q = s.joint_q.numpy()
    assert np.isfinite(q).all() and abs(q[0] - q[1]) < 2e-2


def test_weld_holds_the_box():
    m = cs.linkage_scene(nt, 2, "weld").finalize("cpu")
    s = _port_run(m, 240)
    cs.eq_gates("weld", s, 2)


MJCF_EQ = """<mujoco model="eq">
  <worldbody>
    <body name="a" pos="0.5 0 0">
      <joint name="ja" type="hinge" axis="0 1 0" pos="-0.5 0 0"/>
      <geom type="capsule" fromto="-0.5 0 0 0.5 0 0" size="0.05"/>
    </body>
    <body name="b" pos="0.5 0.4 0">
      <joint name="jb" type="hinge" axis="0 1 0" pos="-0.5 0 0"/>
      <geom type="capsule" fromto="-0.5 0 0 0.5 0 0" size="0.05"/>
    </body>
  </worldbody>
  <equality>
    {eq}
  </equality>
</mujoco>
"""


@pytest.mark.parametrize("eq", [
    '<connect body1="a" body2="b" anchor="0.5 0 0"/>',
    '<weld body1="b" body2="a"/>',
    '<joint joint1="ja" joint2="jb" polycoef="0.1 2 0 0 0"/>',
    '<connect body1="a" anchor="0.5 0 0.1"/><joint joint1="jb"/>'])
def test_mjcf_equality_matches_jax(tmp_path, eq):
    import newton_tpu as jt
    path = tmp_path / "eq.xml"
    path.write_text(MJCF_EQ.replace("{eq}", eq))
    jb, pb = jt.ModelBuilder(), nt.ModelBuilder()
    jb.add_mjcf(str(path))
    pb.add_mjcf(str(path))
    jm, pm = jb.finalize(), pb.finalize("cpu")
    a, b = _leaves(jm), _leaves(pm)
    for n in EQ_LEAVES:
        np.testing.assert_allclose(b[n], a[n], atol=1e-7, err_msg=n)
    np.testing.assert_array_equal(pm.structure.eq_type, jm.structure.eq_type)
    t = _port_run(pm, 20)
    j = _jax_run(jm, 20)
    _assert_close(t, j)


@pytest.mark.parametrize("snippet, word", [
    ('<weld body1="b" body2="a" relpose="0 0 0 1 0 0 0"/>', "relpose"),
    ('<connect body1="a" body2="b" anchor="0 0 0" active="false"/>',
     "inactive"),
    ('<distance body1="a"/>', "distance"),
])
def test_mjcf_equality_unported_raises(tmp_path, snippet, word):
    path = tmp_path / "eq.xml"
    path.write_text(MJCF_EQ.replace("{eq}", snippet))
    with pytest.raises(NotImplementedError, match=word):
        nt.ModelBuilder().add_mjcf(str(path))


def _two_articulations(lib):
    """The CONNECT linkage with an add_articulation before each link."""
    w = lib.ModelBuilder()
    w.add_articulation()
    l1 = w.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1])
    w.add_shape_capsule(l1, radius=0.05, half_height=0.25)
    w.add_joint_revolute(parent=-1, child=l1, axis="Y",
                         xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
    w.add_articulation()
    l2 = w.add_body(xform=[0.5, 0.4, 0, 0, 0, 0, 1])
    w.add_shape_capsule(l2, radius=0.05, half_height=0.25)
    w.add_joint_revolute(parent=-1, child=l2, axis="Y",
                         xform_p=[0, 0.4, 0, 0, 0, 0, 1],
                         xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
    w.add_equality_constraint(lib.EqType.CONNECT, body1=l1, body2=l2,
                              anchor=(0.5, 0, 0))
    return w


def test_jax_drops_an_equality_between_two_articulations():
    """ROADMAP C.18: the linkage with each link its own articulation is
    one group of two rows in the JAX package, and its CONNECT (row 0's
    body to row 1's) is dropped: the kicked links part (0.13 rad after 1
    s) where the one-articulation linkage holds them together. The port
    raises for that case."""
    import newton_tpu as jt
    qd0 = np.array([2.0, 0.0], np.float32)
    one = np.asarray(_jax_run(cs.linkage_scene(jt, 1, "connect").finalize(),
                              240, qd0=qd0).joint_q)
    two = np.asarray(_jax_run(_two_articulations(jt).finalize(), 240,
                              qd0=qd0).joint_q)
    assert abs(one[0] - one[1]) < 1e-3
    assert abs(two[0] - two[1]) > 0.05
    with pytest.raises(NotImplementedError, match="C.18"):
        nt.SolverFeatherstone(_two_articulations(nt).finalize("cpu"))


def _ragged(lib):
    """Two worlds of the linkage, the second without its constraint."""
    b = lib.ModelBuilder()
    b.add_world(cs.linkage_scene(lib, 1, "connect"))
    w = cs.linkage_scene(lib, 1, "connect")
    for name in ("eq_type", "eq_obj1", "eq_obj2", "eq_anchor", "eq_relpose",
                 "eq_polycoef", "eq_enabled", "eq_torquescale", "eq_world",
                 "eq_key"):
        getattr(w, name).clear()
    b.add_world(w)
    return b


@pytest.mark.parametrize("case", ["ragged_rows", "two_articulations",
                                  "disabled", "joint_without_dof",
                                  "world_only"])
def test_unported_equality_cases_raise(case):
    if case == "ragged_rows":
        m = _ragged(nt).finalize("cpu")
        word = "different numbers of equality"
    elif case == "two_articulations":
        m = _two_articulations(nt).finalize("cpu")
        word = "C.18"
    else:
        b = cs.linkage_scene(nt, 1, "connect")
        if case == "disabled":
            b.eq_enabled[0] = False
            word = "disabled"
        elif case == "joint_without_dof":
            f = b.add_body(xform=[0, 0, 1, 0, 0, 0, 1])
            jf = b.add_joint_fixed(-1, f)
            b.add_constraint_mimic(jf, 0)
            word = "no dof"
        else:
            b.add_equality_constraint(nt.EqType.CONNECT, body1=-1, body2=-1)
            word = "outside the articulations"
        m = b.finalize("cpu")
    with pytest.raises(NotImplementedError, match=word):
        nt.SolverFeatherstone(m)
