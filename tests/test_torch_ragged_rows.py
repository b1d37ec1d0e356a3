"""Ragged and heterogeneous rows of an articulation group in the port's
generalized solver against the JAX package's ``SolverMuJoCo.step``, which
sums every tendon and actuator on the flat dof vector: worlds whose rows
differ in their number of fixed tendons, actuators or spatial tendons, or
in what those drive, and fixed tendons (and a motor on one) between two
articulations. Each scene is built by each package's own builder (the
JAX builder keeps one MJCF's actuator table, so the JAX side is handed
the worlds' tables joined) and stepped 8 substeps from the same state.

Tolerances (tests/test_batched_step.py:69-75): joint_q and body_q
atol = rtol = 2e-4, joint_qd 5e-3. The uniform case keeps its tables:
a replicated humanoid's and tendon finger's row tables hash to the
digests the solver built before rows could be ragged.
"""

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke as cs
import newton_tpu_torch as nt

torch.set_num_threads(1)

DT = 1.0 / 240.0
SUBSTEPS = 8

ARM = """<mujoco model="arm"><option gravity="0 0 -9.81"/>
<worldbody><body name="a" pos="0 0 1">
<joint name="j0" type="hinge" axis="0 1 0" damping="0.1"/>
<geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/>
<body name="b" pos="0.3 0 0">
<joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
<geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/></body></body>
</worldbody>{}</mujoco>"""
TENDON = ('<tendon><fixed name="t" stiffness="5"><joint joint="j0" '
          'coef="1"/><joint joint="j1" coef="-1"/></fixed></tendon>')
TENDON_J1 = ('<tendon><fixed name="t" stiffness="3" damping="0.2">'
             '<joint joint="j1" coef="2"/></fixed></tendon>')
MOTOR_J0 = '<actuator><motor name="m" joint="j0" gear="2"/></actuator>'
MOTOR_J1 = '<actuator><motor name="m" joint="j1" gear="3"/></actuator>'
MOTOR_T = '<actuator><motor name="m" tendon="t" gear="1.5"/></actuator>'


def _finger(with_tendon):
    """The tendon finger's MJCF (example_tendon_finger.py), or the same
    finger without its <spatial> tendon and the motor that pulls it."""
    xml = cs.FINGER_MJCF
    if not with_tendon:
        for tag in ("tendon", "actuator"):
            a, b = xml.index(f"<{tag}>"), xml.index(f"</{tag}>")
            xml = xml[:a] + xml[b + len(tag) + 3:]
    return xml


def _write(tmp_path, xml, k):
    path = tmp_path / f"w{k}.xml"
    path.write_text(xml)
    return str(path)


def _models(tmp_path, worlds, tendons=(), motor_on_tendon=None):
    """Each package's model of ``worlds`` (a list of worlds, each a list
    of MJCF texts: one articulation each), with ``tendons`` (joints,
    coefs, ke, kd) added over the whole model and a motor of gear 1.5 on
    tendon ``motor_on_tendon`` (index among all fixed tendons)."""
    import newton_tpu as jt
    from newton_tpu.sim.model import AttributeAssignment as JAssign
    from newton_tpu.sim.model import AttributeFrequency as JFreq
    from newton_tpu.solvers.generalized.actuation import \
        MJCActuation as JAct
    from newton_tpu_torch.sim.model import (AttributeAssignment,
                                            AttributeFrequency)
    from newton_tpu_torch.solvers.generalized.actuation import MJCActuation
    paths = [[_write(tmp_path, x, f"{w}_{a}") for a, x in enumerate(xs)]
             for w, xs in enumerate(worlds)]
    jb, aus = jt.ModelBuilder(), []
    for ps in paths:
        jb.begin_world()
        for p in ps:
            jb.add_mjcf(p)
            if getattr(jb, "mjc_actuation", None) is not None:
                aus.append(jb.mjc_actuation)
                jb.mjc_actuation = None
        jb.end_world()
    tb = nt.ModelBuilder()
    for ps in paths:
        w = nt.ModelBuilder()
        for p in ps:
            w.add_mjcf(p)
        tb.add_world(w)
    for lib_b in (jb, tb):
        for joints, coefs, ke, kd in tendons:
            lib_b.add_tendon_fixed(joints, coefs, stiffness=ke, damping=kd)
    if motor_on_tendon is not None:
        # (the MJCF texts of these scenes carry no actuators)
        for Act, target in ((JAct, aus), (MJCActuation, None)):
            a = Act(1)
            a.tendon[0] = motor_on_tendon
            a.gear[0] = 1.5
            if target is None:
                tb.mjc_actuation = a.finish()
            else:
                target.append(a.finish())
        tb.add_custom_attribute("mjc:ctrl", AttributeFrequency.ONCE,
                                shape=(1,),
                                assignment=AttributeAssignment.CONTROL)
    if aus:
        jb.mjc_actuation = _joined(JAct, aus)
        jb.custom_attributes.pop("mjc:ctrl", None)
        jb.add_custom_attribute("mjc:ctrl", JFreq.ONCE,
                                shape=(jb.mjc_actuation.n,),
                                assignment=JAssign.CONTROL, default=0.0)
    jm, tm = jb.finalize(), tb.finalize("cpu")
    if aus:
        # the two builders' tables agree: the port's add_world joins them
        for name in ("dof", "coord", "tendon", "sten", "gear"):
            np.testing.assert_array_equal(
                getattr(tm.structure.mjc_actuation, name),
                getattr(jm.structure.mjc_actuation, name), err_msg=name)
    return jm, tm


def _joined(Act, aus):
    out = Act(sum(a.n for a in aus))
    for name in ("dof", "coord", "tendon", "sten", "gear", "dyntype",
                 "dynprm", "gaintype", "gainprm", "biastype", "biasprm",
                 "ctrlrange", "forcerange", "actrange", "ctrllimited",
                 "forcelimited", "actlimited", "lengthrange", "acc0"):
        setattr(out, name, np.concatenate([np.asarray(getattr(a, name))
                                           for a in aus]))
    return out.finish()


def _run_both(jm, tm, q0, ctrl=None, integrator="euler"):
    """8 substeps of each package from joint_q = q0 at rest."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    q0 = np.asarray(q0, np.float32)
    qd0 = np.zeros(tm.structure.joint_dof_count, np.float32)
    js = j_eval_fk(jm, jnp.asarray(q0), jnp.asarray(qd0), jm.state())
    ts = nt.eval_fk(tm, torch.as_tensor(q0), torch.as_tensor(qd0),
                    tm.state())
    jc, tc = jm.control(), tm.control()
    if ctrl is not None:
        jc = jc.replace(custom={**jc.custom,
                                "mjc:ctrl": jnp.asarray(ctrl, jnp.float32)})
        tc.custom["mjc:ctrl"] = torch.as_tensor(ctrl, dtype=torch.float32)
    jsolver = JSolver(jm, iterations=8, integrator=integrator)
    tsolver = nt.SolverMuJoCo(tm, iterations=8, integrator=integrator)
    j_step = jax.jit(lambda s: jsolver.step(s, None, jc, None, DT))
    for _ in range(SUBSTEPS):
        js = j_step(js)
        ts = tsolver.step(ts, None, tc, None, DT)
    return js, ts, tsolver


def _assert_states(got, ref, q_atol=2e-4, qd_atol=5e-3):
    for name, atol in (("joint_q", q_atol), ("joint_qd", qd_atol),
                       ("body_q", q_atol)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=atol, err_msg=name)


# (worlds, ctrl): rows that differ, each a scene the JAX package steps
CASES = {
    # 1. a fixed tendon in world 0 only
    "ragged_fixed_tendons": ([[ARM.format(TENDON)], [ARM.format("")]],
                             None),
    # 2. a motor in world 0 only
    "ragged_actuators": ([[ARM.format(MOTOR_J0)], [ARM.format("")]],
                         [0.7]),
    # 4. equal counts, different structures: the motor's joint, the
    # tendon's joints and coefficients, a tendon motor beside a joint one
    "motor_joint_differs": ([[ARM.format(MOTOR_J0)], [ARM.format(MOTOR_J1)],
                             [ARM.format(MOTOR_J0)]], [0.7, -0.5, 0.3]),
    "tendon_joints_differ": ([[ARM.format(TENDON)],
                              [ARM.format(TENDON_J1)]], None),
    "tendon_motor_beside_joint_motor": (
        [[ARM.format(TENDON + MOTOR_T)], [ARM.format(TENDON + MOTOR_J1)]],
        [0.8, -0.6]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_ragged_rows_match_jax(tmp_path, name):
    worlds, ctrl = CASES[name]
    jm, tm = _models(tmp_path, worlds)
    q0 = np.tile([0.3, 0.5], len(worlds))
    js, ts, solver = _run_both(jm, tm, q0, ctrl)
    _assert_states(ts, js)
    # one group whose rows differ: the worlds really move apart
    assert len(solver.groups) == 1
    q = ts.joint_q.numpy().reshape(len(worlds), 2)
    assert np.abs(q[0] - q[1]).max() > 1e-2


def test_ragged_rows_without_control_match_jax(tmp_path):
    """A fixed tendon pulls with no Control too (the JAX package sums the
    tendons before it reads the Control)."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    jm, tm = _models(tmp_path, [[ARM.format(TENDON)], [ARM.format("")]])
    q0 = np.tile([0.3, 0.5], 2).astype(np.float32)
    js = j_eval_fk(jm, jnp.asarray(q0), jm.joint_qd0, jm.state())
    ts = nt.eval_fk(tm, torch.as_tensor(q0), tm.joint_qd0, tm.state())
    jsolver, tsolver = JSolver(jm, iterations=8), nt.SolverMuJoCo(
        tm, iterations=8)
    j_step = jax.jit(lambda s: jsolver.step(s, None, None, None, DT))
    for _ in range(SUBSTEPS):
        js, ts = j_step(js), tsolver.step(ts, None, None, None, DT)
    _assert_states(ts, js)


def test_ragged_spatial_tendons_match_jax(tmp_path):
    """3. The tendon finger (its <spatial> flexor and the motor on it)
    beside the same finger without them, and the finger again: the rows
    carry 1, 0 and 1 spatial tendons and actuators."""
    worlds = [[_finger(True)], [_finger(False)], [_finger(True)]]
    jm, tm = _models(tmp_path, worlds)
    q0 = np.tile([0.2, 0.4], 3)
    js, ts, solver = _run_both(jm, tm, q0, ctrl=[-6.0, -3.0])
    _assert_states(ts, js)
    grp = solver.groups[0]
    assert grp.sten_rows.tolist() == [[0], [-1], [1]]
    assert grp.act_rows.tolist() == [[0], [-1], [1]]
    q = ts.joint_q.numpy().reshape(3, 2)
    assert np.abs(q[0] - q[1]).max() > 1e-2


@pytest.mark.parametrize("integrator", ["euler", "implicitfast"])
def test_tendon_between_articulations_matches_jax(tmp_path, integrator):
    """5. Fixed tendons between two articulations of a world (the JAX
    package sums them on the flat dofs and keeps their damping explicit),
    one of them pulled by a motor, beside an in-row tendon; two worlds of
    two arms each."""
    worlds = [[ARM.format(""), ARM.format("")]] * 2
    tendons = [([0, 2], [1.0, -1.0], 5.0, 0.5),      # world 0, across arms
               ([5, 7], [0.5, 1.0], 2.0, 0.0),       # world 1, across arms
               ([4, 5], [1.0, 1.0], 4.0, 0.3)]       # world 1, one arm
    jm, tm = _models(tmp_path, worlds, tendons, motor_on_tendon=0)
    q0 = [0.3, 0.5, -0.2, 0.1, 0.4, -0.3, 0.1, 0.6]
    js, ts, solver = _run_both(jm, tm, q0, ctrl=[0.9],
                               integrator=integrator)
    _assert_states(ts, js)
    assert solver.cross is not None
    assert solver.cross.tendons.tolist() == [0, 1]


def test_tendon_between_articulations_refused_under_rk4(tmp_path):
    worlds = [[ARM.format(""), ARM.format("")]]
    tb = nt.ModelBuilder()
    for k, x in enumerate(worlds[0]):
        tb.add_mjcf(_write(tmp_path, x, k))
    tb.add_tendon_fixed([0, 2], [1.0, -1.0], stiffness=5.0)
    with pytest.raises(NotImplementedError, match="RK4"):
        nt.SolverMuJoCo(tb.finalize("cpu"), integrator="rk4")


# ----------------------------------------------------------------------
# the uniform case keeps its tables bit for bit
# ----------------------------------------------------------------------
# sha256 of the row tables (names below) of a replicated humanoid x 3
# (fixed tendons, joint motors) and tendon finger x 2 (a spatial tendon,
# a tendon motor) under implicitfast, as the solver built them before
# rows could be ragged
_TABLE_GOLDEN = {
    "humanoid":
        "c0ceefe8fe5918ffe1712374d0dae74fdab039a14dd57deb332ed05fc107d794",
    "finger":
        "bfe5ab5a5c76c3140e2e83530d1e930b317aa9a1cde9b2a137f991c3dda962c3",
}
_TABLES = ("tendon_Cq", "tendon_Cd", "tendon_ke", "tendon_kd", "tendon_L0",
           "row_tendon", "row_act")
_ACT = ("is_joint", "dof", "coord", "gear", "is_ten", "tendon", "ten_map",
        "is_st", "sten", "gp9", "bp9", "lengthrange", "acc0")
_RAU = ("dof", "coord", "tendon", "sten", "gear", "gainprm", "biasprm")


def table_digest(solver):
    """sha256 over a solver's per-group tendon and actuator tables."""
    h = hashlib.sha256()

    def put(name, v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.ascontiguousarray(v)
        h.update(f"{name}:{v.dtype}:{v.shape};".encode())
        h.update(v.tobytes())
    for grp in solver.groups:
        t = grp.tables
        for name in ("tendon_rows", "act_rows", "sten_rows"):
            put(name, np.asarray(getattr(grp, name), np.int64))
        for name in _TABLES:
            if getattr(t, name, None) is not None:
                put(name, getattr(t, name))
        if t.sten is not None:
            h.update(repr([p.key() for p in t.sten.paths]).encode())
            for name in ("ke", "kd", "L0"):
                put("sten_" + name, getattr(t.sten, name))
        au = grp.actuation
        if au is not None:
            for name in _ACT:
                if getattr(au, name, None) is not None:
                    put("act_" + name, getattr(au, name))
            rau = grp.row_model.structure.mjc_actuation
            for name in _RAU:
                put("rau_" + name, getattr(rau, name))
    return h.hexdigest()


def uniform_solvers(lib_nt, tmp_path):
    """The uniform scenes' solvers (humanoid x 3, finger x 2)."""
    hb = lib_nt.ModelBuilder()
    hb.replicate(_humanoid_builder(lib_nt), 3)
    fb = lib_nt.ModelBuilder()
    f = lib_nt.ModelBuilder()
    f.add_mjcf(_write(tmp_path, _finger(True), "f"))
    fb.replicate(f, 2)
    return {name: lib_nt.SolverMuJoCo(b.finalize("cpu"), iterations=8,
                                      integrator="implicitfast")
            for name, b in (("humanoid", hb), ("finger", fb))}


def _humanoid_builder(lib_nt):
    r = lib_nt.ModelBuilder()
    r.add_mjcf(lib_nt.ASSET_DIR + "/humanoid.xml")
    return r


def test_uniform_tables_are_unchanged(tmp_path):
    for name, solver in uniform_solvers(nt, tmp_path).items():
        assert table_digest(solver) == _TABLE_GOLDEN[name], name
        for grp in solver.groups:
            # one row's tables: no leading row axis
            t = grp.tables
            assert not t.tendons or t.tendon_Cq.dim() == 2
            assert t.sten is None or t.sten.sel is None
            assert grp.actuation is None or not grp.actuation.per_row
            assert grp.tables.act_pad is None
