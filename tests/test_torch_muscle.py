"""Parity: the port's MJCF actuation (muscle gain, bias and dynamics,
every dyntype's activation step, the ``<general>``, ``<intvelocity>``,
``<damper>``, ``<cylinder>`` and ``<muscle>`` actuators, fixed- and
spatial-tendon transmissions, muscle ``acc0``), the muscle arm
(newton_tpu_torch/assets/muscle_arm.xml, a test scene) and the waypoint
muscles of ``SolverSemiImplicit`` against the JAX package's.

Tolerances: the muscle curves and the actuator step 1e-5 relative
(float32, the same formulas); acc0 1e-4 relative (float64 host solves on
float32 mass matrices); the arm's 40 substeps joint_q 1e-4, joint_qd 1e-3
and the activations 1e-5; the muscle pairs' 200 steps body_q 1e-5 and the
gates of tests/test_solvers.py:140 and :356.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
import newton_tpu_torch as nt
from newton_tpu_torch.solvers.generalized import actuation as ta

torch.set_num_threads(1)

ARM = os.path.join(nt.ASSET_DIR, "muscle_arm.xml")
EVERY = """
<mujoco model="every">
  <option gravity="0 0 -9.81" timestep="0.002"/>
  <worldbody>
    <body name="a" pos="0 0 1">
      <joint name="h1" type="hinge" axis="0 1 0" range="-60 60"/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.03"/>
      <body name="b" pos="0.3 0 0">
        <joint name="h2" type="hinge" axis="0 1 0" range="-30 90"/>
        <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.02"/>
        <body name="c" pos="0.2 0 0">
          <joint name="s3" type="slide" axis="1 0 0" range="-0.1 0.1"/>
          <geom type="sphere" size="0.03"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="couple" stiffness="1" damping="0.2">
      <joint joint="h1" coef="1"/>
      <joint joint="h2" coef="-0.5"/>
    </fixed>
  </tendon>
  <actuator>
    <motor joint="h1" gear="2" ctrlrange="-1 1"/>
    <position joint="h2" kp="5" kv="0.3" timeconst="0.05"/>
    <velocity joint="s3" kv="2"/>
    <general joint="h1" dyntype="integrator" gaintype="affine"
             biastype="affine" gainprm="2 0.5 -0.2" biasprm="0 -1 -0.1"
             ctrlrange="-1 1" actrange="-2 2"/>
    <general joint="h2" dyntype="filter" dynprm="0.1" gainprm="3"/>
    <intvelocity joint="s3" kp="4" kv="0.5" ctrlrange="-0.5 0.5"/>
    <damper joint="h2" kv="0.4" ctrlrange="0 1"/>
    <cylinder joint="h1" area="0.01" timeconst="0.2" bias="1 -2 -0.5"/>
    <muscle joint="h2" force="30"/>
    <muscle tendon="couple" scale="100" tausmooth="0.2"/>
  </actuator>
</mujoco>
"""


def _both(tmp_path, xml_or_path, name):
    import newton_tpu as jt
    path = xml_or_path
    if xml_or_path.lstrip().startswith("<"):
        path = str(tmp_path / f"{name}.xml")
        with open(path, "w") as f:
            f.write(xml_or_path)
    jb = jt.ModelBuilder()
    jb.add_mjcf(path)
    b = nt.ModelBuilder()
    b.add_mjcf(path)
    return jb.finalize(), b.finalize("cpu")


def _prm(rng, n):
    """Muscle parameters around MuJoCo's defaults."""
    prm = np.zeros((n, 9), np.float32)
    prm[:, 0] = rng.uniform(0.6, 0.8, n)
    prm[:, 1] = rng.uniform(1.0, 1.2, n)
    prm[:, 2] = np.where(rng.rand(n) > 0.5, -1.0, rng.uniform(10, 100, n))
    prm[:, 3] = rng.uniform(50, 300, n)
    prm[:, 4] = rng.uniform(0.3, 0.6, n)
    prm[:, 5] = rng.uniform(1.4, 1.8, n)
    prm[:, 6] = rng.uniform(1.0, 2.0, n)
    prm[:, 7] = rng.uniform(1.0, 1.5, n)
    prm[:, 8] = rng.uniform(1.1, 1.4, n)
    return prm


def test_muscle_curves_match_jax():
    """Gain, bias and activation rate over a grid of lengths, velocities,
    controls and activations spanning every branch (below, inside and
    above the force-length bump; shortening and lengthening; activating
    and deactivating; hard and smooth switching)."""
    import jax.numpy as jnp
    from newton_tpu.solvers.generalized import actuation as ja
    rng = np.random.RandomState(0)
    n = 4096
    prm = _prm(rng, n)
    lr = np.stack([rng.uniform(0.1, 0.2, n), rng.uniform(0.3, 0.4, n)],
                  -1).astype(np.float32)
    acc0 = rng.uniform(0.5, 20, n).astype(np.float32)
    length = rng.uniform(0.0, 0.55, n).astype(np.float32)
    vel = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    ctrl = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    act = rng.uniform(-0.1, 1.1, n).astype(np.float32)
    dyn = np.stack([rng.uniform(0.005, 0.02, n), rng.uniform(0.02, 0.06, n),
                    np.where(rng.rand(n) > 0.5, 0.0, 0.3)],
                   -1).astype(np.float32)
    T = torch.as_tensor
    for got, ref in (
            (ta.muscle_gain(T(length), T(vel), T(lr), T(acc0), T(prm)),
             ja.muscle_gain(jnp.asarray(length), jnp.asarray(vel),
                            jnp.asarray(lr), jnp.asarray(acc0),
                            jnp.asarray(prm))),
            (ta.muscle_bias(T(length), T(lr), T(acc0), T(prm)),
             ja.muscle_bias(jnp.asarray(length), jnp.asarray(lr),
                            jnp.asarray(acc0), jnp.asarray(prm))),
            (ta.muscle_dynamics(T(ctrl), T(act), T(dyn)),
             ja.muscle_dynamics(jnp.asarray(ctrl), jnp.asarray(act),
                                jnp.asarray(dyn)))):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_importer_tables_match_jax(tmp_path):
    """Every actuator type the importer takes (motor, position with a
    timeconst, velocity, general with integrator and filter dynamics and
    affine gain/bias, intvelocity, damper, cylinder, muscles on a joint and
    on a fixed tendon, and the arm's muscles on spatial tendons): the
    MJCActuation tables equal the JAX package's, muscle lengthranges
    included."""
    for xml, name in ((EVERY, "every"), (ARM, "arm")):
        jm, tm = _both(tmp_path, xml, name)
        ja_, ta_ = jm.structure.mjc_actuation, tm.structure.mjc_actuation
        assert ta_.n == ja_.n and ta_.has_act and ta_.has_muscle
        for f in ("dof", "coord", "tendon", "sten", "dyntype", "gaintype",
                  "biastype", "ctrllimited", "forcelimited", "actlimited"):
            np.testing.assert_array_equal(getattr(ta_, f), getattr(ja_, f),
                                          err_msg=f)
        for f in ("gear", "dynprm", "gainprm", "biasprm", "ctrlrange",
                  "forcerange", "actrange", "lengthrange"):
            np.testing.assert_allclose(getattr(ta_, f), getattr(ja_, f),
                                       rtol=1e-6, err_msg=f)
        assert "mjc:act" in tm.structure.custom_specs


def test_acc0_matches_jax(tmp_path):
    """acc0 = |M(q0)^-1 moment| of the muscles (joint, fixed-tendon and
    spatial-tendon transmissions) after the solver's construction."""
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    for xml, name in ((EVERY, "every"), (ARM, "arm")):
        jm, tm = _both(tmp_path, xml, name)
        JSolver(jm)
        nt.SolverMuJoCo(tm)
        ja_, ta_ = jm.structure.mjc_actuation, tm.structure.mjc_actuation
        np.testing.assert_allclose(ta_.acc0, ja_.acc0, rtol=1e-4)
        assert (ta_.acc0 != 1.0).sum() >= 2


def test_eval_mass_matrix_matches_jax(tmp_path):
    """``sim/dynamics_api.eval_mass_matrix`` (the mass matrix acc0 solves
    with) against the JAX package's at the default pose, 1e-5 relative."""
    from newton_tpu.sim.dynamics_api import eval_mass_matrix as j_mass
    from newton_tpu_torch.sim.dynamics_api import eval_mass_matrix
    jm, tm = _both(tmp_path, EVERY, "every")
    got, ref = eval_mass_matrix(tm, tm.state()), j_mass(jm, jm.state())
    assert len(got) == len(ref) == 1
    r = np.asarray(ref[0])
    np.testing.assert_allclose(got[0].numpy(), r, rtol=1e-5,
                               atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("integ", ["euler", "implicitfast"])
@pytest.mark.parametrize("xml", ["every", "arm"])
def test_actuated_steps_match_jax(tmp_path, xml, integ):
    """40 substeps of 2 ms with random ctrl in each actuator's range and a
    nonzero start: joint_q, joint_qd and ``mjc:act`` of the port's ``step``
    against the JAX package's (the actuator velocity gains, tendon kd and
    spatial tendons enter D under implicitfast)."""
    import jax
    import jax.numpy as jnp
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    jm, tm = _both(tmp_path, EVERY if xml == "every" else ARM, xml)
    js = JSolver(jm, iterations=8, integrator=integ)
    ts = nt.SolverMuJoCo(tm, iterations=8, integrator=integ)
    rng = np.random.RandomState(4)
    au = tm.structure.mjc_actuation
    lo = np.where(au.ctrllimited, au.ctrlrange[:, 0], -1.0)
    hi = np.where(au.ctrllimited, au.ctrlrange[:, 1], 1.0)
    ctrl = rng.uniform(lo, hi).astype(np.float32)
    q0 = np.asarray(jm.joint_q0) + rng.uniform(-0.2, 0.2,
                                               tm.joint_coord_count)
    q0 = q0.astype(np.float32)
    qd0 = rng.uniform(-0.5, 0.5, tm.joint_dof_count).astype(np.float32)
    jc = jm.control()
    jc = jc.replace(custom={**jc.custom, "mjc:ctrl": jnp.asarray(ctrl)})
    sj = j_eval_fk(jm, jnp.asarray(q0), jnp.asarray(qd0), jm.state())
    step = jax.jit(lambda s: jax.lax.scan(
        lambda x, _: (js.step(x, None, jc, None, 0.002), None), s, None,
        length=40)[0])
    sj = step(sj)
    st = nt.eval_fk(tm, torch.as_tensor(q0), torch.as_tensor(qd0),
                    tm.state())
    tc = tm.control()
    tc.custom["mjc:ctrl"] = torch.as_tensor(ctrl)
    for _ in range(40):
        st = ts.step(st, None, tc, None, 0.002)
    np.testing.assert_allclose(st.joint_q.numpy(), np.asarray(sj.joint_q),
                               atol=1e-4)
    np.testing.assert_allclose(st.joint_qd.numpy(), np.asarray(sj.joint_qd),
                               atol=1e-3)
    np.testing.assert_allclose(st.custom["mjc:act"].numpy(),
                               np.asarray(sj.custom["mjc:act"]), atol=1e-5)


def test_arm_muscles_flex_the_elbow():
    """The arm x 2 through ``replicate``: full flexor ctrl flexes the elbow
    past the idle arm's, and the activations stay in [0, 1]."""
    b = nt.ModelBuilder()
    r = nt.ModelBuilder()
    r.add_mjcf(ARM)
    b.replicate(r, 2)
    m = b.finalize("cpu")
    solver = nt.SolverMuJoCo(m)
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    c = m.control()
    ctrl = torch.zeros(2, 6)
    ctrl[1, 0] = 1.0
    c.custom["mjc:ctrl"] = ctrl.reshape(-1)
    for _ in range(150):
        s = solver.step(s, None, c, None, cs.ARM_DT)
    act = s.custom["mjc:act"].view(2, 6)
    q = s.joint_q.view(2, 2)
    assert torch.isfinite(s.joint_q).all()
    assert float(act.min()) >= 0.0 and float(act.max()) <= 1.0
    assert float(q[1, 1] - q[0, 1]) > 0.2


@pytest.mark.parametrize("passive", [False, True])
def test_semi_implicit_muscles_match_jax(passive):
    """tests/test_solvers.py:140 and :356 on the port: 200 steps of 1 ms,
    body_q against the JAX package's; the contracting pair: zero activation
    holds the bodies to 1e-6, full activation closes the gap below 0.9
    about the midpoint (within 1e-5); the passive tendon pulls a stretched
    pair closer."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.solvers import SolverSemiImplicit as JSemi
    jm = cs.muscle_pair_scene(jt, 1, passive).finalize()
    tm = cs.muscle_pair_scene(nt, 1, passive).finalize("cpu")
    js, ts = JSemi(jm), nt.SolverSemiImplicit(tm)
    acts = [0.0] if passive else [0.0, 1.0]
    for a in acts:
        jc = jm.control().replace(muscle_activations=jnp.full((1,), a))
        roll = jax.jit(lambda s: jax.lax.scan(
            lambda x, _: (js.step(x.clear_forces(), None, jc, None, 1e-3),
                          None), s, None, length=200)[0])
        sj = roll(jm.state())
        tc = tm.control()
        tc.muscle_activations = torch.full((1,), a)
        st = tm.state()
        for _ in range(200):
            st = ts.step(st, None, tc, None, 1e-3)
        np.testing.assert_allclose(st.body_q.numpy(), np.asarray(sj.body_q),
                                   atol=1e-5)
        gap = float(torch.linalg.vector_norm(st.body_q[1, :3]
                                             - st.body_q[0, :3]))
        if passive:
            assert gap < 2.0
        elif a == 0.0:
            torch.testing.assert_close(st.body_q, tm.body_q, atol=1e-6,
                                       rtol=0)
        else:
            assert gap < 0.9
            mid = 0.5 * (st.body_q[0, 0] + st.body_q[1, 0])
            assert abs(float(mid) - 0.5) < 1e-5


def test_bridge_round_trip(tmp_path):
    """The JAX arm (spatial tendons, muscles, ``mjc:act``) with a waypoint
    muscle pair added, through the bridge: the port's model equals the
    JAX model's leaves, tables and paths, converts back exactly, and a
    State with ``mjc:act`` and a Control with ``muscle_activations`` round
    trip."""
    import newton_tpu as jt
    from newton_tpu_torch.sim.model import (MODEL_FLOAT_FIELDS,
                                            MODEL_INT_FIELDS)
    from newton_tpu_torch.utils import bridge

    def build(lib):
        b = lib.ModelBuilder()
        b.add_mjcf(ARM)
        b.add_articulation()
        b1 = b.add_body(xform=[0, 0, 2, 0, 0, 0, 1])
        b.add_shape_box(b1, hx=0.1, hy=0.1, hz=0.1)
        b.add_joint_free(b1)
        b.add_muscle([b1, 1], [(0.1, 0, 0), (0.05, 0, 0)], f0=50.0, lm=0.5,
                     lt=0.1, lmax=1.0, pen=0.1, passive_ke=3.0)
        return b
    jm = build(jt).finalize()
    tm = build(nt).finalize("cpu")
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
    bm = bridge.model_from_numpy(leaves, structure, "cpu")
    for name in ("sten_params", "muscle_params", "muscle_points",
                 "muscle_bodies"):
        np.testing.assert_allclose(getattr(bm, name).numpy(),
                                   getattr(tm, name).numpy(), rtol=1e-6,
                                   err_msg=name)
    assert [p.key() for p in bm.structure.sten_paths] == \
        [p.key() for p in tm.structure.sten_paths]
    assert bm.structure.sten_key == tm.structure.sten_key
    np.testing.assert_array_equal(bm.structure.muscle_start,
                                  tm.structure.muscle_start)
    for f in bridge.ACTUATION_FIELDS[1:]:
        np.testing.assert_allclose(
            np.asarray(getattr(bm.structure.mjc_actuation, f), float),
            np.asarray(getattr(tm.structure.mjc_actuation, f), float),
            rtol=1e-6, err_msg=f)
    back = bridge.model_from_numpy(*bridge.model_to_numpy(bm), "cpu")
    for name in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS:
        assert torch.equal(getattr(back, name), getattr(bm, name)), name
    assert [p.key() for p in back.structure.sten_paths] == \
        [p.key() for p in bm.structure.sten_paths]
    s = tm.state()
    s.custom["mjc:act"] = torch.arange(6, dtype=torch.float32)
    s2 = bridge.state_from_numpy(bridge.state_to_numpy(s), "cpu")
    assert torch.equal(s2.custom["mjc:act"], s.custom["mjc:act"])
    c = tm.control()
    c.muscle_activations = torch.tensor([0.25])
    c2 = bridge.control_from_numpy(bridge.control_to_numpy(c), "cpu")
    assert torch.equal(c2.muscle_activations, c.muscle_activations)
