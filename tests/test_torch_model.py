"""Parity: the port's MJCF importer + finalize, eval_fk and bridge against
the JAX package, on gymnasium's ant (the in-repo copy both packages read).

Integer and structure fields must be equal; float leaves agree to 1e-6
(both builders author in float64 and round once to float32); FK agrees to
1e-5 (float32 transform chains, 3 levels deep)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newton_tpu as jt
from newton_tpu.parallel import batch_state as j_batch_state
from newton_tpu.sim.articulation import eval_fk as j_eval_fk

import newton_tpu_torch as nt
from newton_tpu_torch.sim.model import MODEL_FLOAT_FIELDS, MODEL_INT_FIELDS
from newton_tpu_torch.utils import bridge

torch.set_num_threads(1)

ANT = os.path.join(nt.ASSET_DIR, "ant.xml")
HUMANOID = os.path.join(nt.ASSET_DIR, "humanoid.xml")


def jax_model_to_numpy(jm):
    """JAX Model -> the bridge's numpy dicts."""
    leaves = {n: np.asarray(getattr(jm, n))
              for n in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS}
    leaves["custom"] = {k: np.asarray(v) for k, v in jm.custom.items()}
    st = jm.structure
    structure = {n: getattr(st, n) for n in bridge.STRUCTURE_FIELDS}
    au = st.mjc_actuation
    structure["mjc_actuation"] = {n: getattr(au, n)
                                  for n in bridge.ACTUATION_FIELDS}
    structure["custom_specs"] = {
        k: dict(frequency=s.frequency.value, assignment=s.assignment.value,
                shape=s.shape, default=s.default)
        for k, s in st.custom_specs.items()}
    return leaves, structure


@pytest.fixture(scope="module")
def ant():
    jb = jt.ModelBuilder()
    jb.add_mjcf(ANT)
    tb = nt.ModelBuilder()
    tb.add_mjcf(ANT)
    return jb.finalize(), tb.finalize("cpu")


def test_ant_counts(ant):
    _, tm = ant
    st = tm.structure
    assert (st.body_count, st.joint_coord_count, st.joint_dof_count) == \
        (13, 15, 14)
    assert st.rigid_contact_max == 25 and len(st.candidate_pairs) == 13
    assert st.mjc_actuation.n == 8


def test_float_leaves_match_jax(ant):
    jm, tm = ant
    for name in MODEL_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_int_leaves_match_jax(ant):
    jm, tm = ant
    for name in MODEL_INT_FIELDS:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)),
                                      err_msg=name)


def test_structure_matches_jax(ant):
    """Topology, candidate pairs and the contact slot layout: equal."""
    jm, tm = ant
    for name in bridge.STRUCTURE_FIELDS:
        a, b = getattr(jm.structure, name), getattr(tm.structure, name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            assert a == b, name


def test_actuation_and_custom_match_jax(ant):
    jm, tm = ant
    ja, ta = jm.structure.mjc_actuation, tm.structure.mjc_actuation
    for name in bridge.ACTUATION_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(ta, name)),
                                      np.asarray(getattr(ja, name)),
                                      err_msg=name)
    assert list(tm.custom) == list(jm.custom)
    for k, v in jm.custom.items():
        np.testing.assert_array_equal(tm.custom[k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(tm.control().custom["mjc:ctrl"].numpy(),
                                  np.asarray(jm.control().custom["mjc:ctrl"]))


@pytest.mark.parametrize("drop", [0.0, 0.08])
def test_eval_fk_matches_jax(ant, drop):
    """Batched FK on perturbed coordinates (as test_batched_step.py:55)."""
    jm, tm = ant
    W = 6
    rng = np.random.RandomState(3)
    q = np.tile(np.asarray(jm.joint_q0), (W, 1)) \
        + 0.02 * rng.randn(W, 15).astype(np.float32)
    q[:, 2] -= drop
    qd = 0.1 * rng.randn(W, 14).astype(np.float32)
    sb = j_batch_state(jm.state(), W)
    ref = jax.vmap(lambda a, b, s: j_eval_fk(jm, a, b, s))(
        jnp.asarray(q), jnp.asarray(qd), sb)
    got = nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd),
                     nt.batch_state(tm.state(), W))
    np.testing.assert_allclose(got.body_q.numpy(), np.asarray(ref.body_q),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.body_qd.numpy(), np.asarray(ref.body_qd),
                               atol=1e-5, rtol=0)


def test_bridge_round_trip(ant):
    """Port Model -> numpy -> Model, and State/Control through the bridge:
    exact."""
    _, tm = ant
    leaves, structure = bridge.model_to_numpy(tm)
    back = bridge.model_from_numpy(leaves, structure, "cpu")
    for name in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS:
        assert torch.equal(getattr(back, name), getattr(tm, name)), name
    for name in bridge.STRUCTURE_FIELDS:
        a, b = getattr(tm.structure, name), getattr(back.structure, name)
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b), name
    s = nt.eval_fk(tm, tm.joint_q0, tm.joint_qd0, tm.state())
    s2 = bridge.state_from_numpy(bridge.state_to_numpy(s), "cpu")
    assert all(torch.equal(getattr(s, n), getattr(s2, n))
               for n in bridge.STATE_FIELDS)
    c = tm.control()
    c2 = bridge.control_from_numpy(bridge.control_to_numpy(c), "cpu")
    assert torch.equal(c.custom["mjc:ctrl"], c2.custom["mjc:ctrl"])


def test_bridge_from_jax_model(ant):
    """The JAX Model through the bridge equals the port's own finalize to
    1e-6, and the bridged model steps like the port's own."""
    jm, tm = ant
    bm = bridge.model_from_numpy(*jax_model_to_numpy(jm), "cpu")
    for name in MODEL_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(bm, name).numpy(),
                                   getattr(tm, name).numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
    s = nt.batch_state(nt.eval_fk(bm, bm.joint_q0, bm.joint_qd0, bm.state()),
                       2)
    out = nt.SolverMuJoCo(bm, iterations=8, integrator="euler").step_batched(
        s, None, None, nt.CollisionPipeline(bm).collide(s), 1.0 / 240.0)
    assert bool(torch.isfinite(out.joint_q).all())


def test_humanoid_raises_naming_element(tmp_path):
    """The humanoid's fixed tendons import, and so do spatial tendons now;
    a spatial tendon through a <pulley> added to them is not ported, and
    the importer says so instead of dropping it (the JAX importer skips
    the tendon with a warning)."""
    with open(HUMANOID) as f:
        text = f.read()
    path = tmp_path / "humanoid_spatial.xml"
    path.write_text(text.replace(
        "<worldbody>", '<worldbody><site name="a"/><site name="b" '
        'pos="0 0 1"/>').replace(
        "<tendon>", '<tendon><spatial name="s"><site site="a"/><pulley '
        'divisor="2"/><site site="b"/></spatial>'))
    nt.ModelBuilder().add_mjcf(HUMANOID)
    with pytest.raises(NotImplementedError, match="pulley"):
        nt.ModelBuilder().add_mjcf(str(path))


@pytest.mark.parametrize("snippet, word", [
    ('<worldbody><body><geom type="ellipsoid" size="1 1 1"/></body>'
     '</worldbody>', "ellipsoid"),
    ('<worldbody><body><joint type="slide"/><joint type="hinge"/>'
     '<geom size="0.1"/></body></worldbody>', "slide"),
    ('<worldbody><body><site name="s"/><geom size="0.1"/></body>'
     '</worldbody>', "site"),
    ('<equality/><worldbody/>', "equality"),
    ('<worldbody><body><joint name="a" pos="0 0 0"/><joint name="b" '
     'pos="0 0 0.1"/><geom size="0.1"/></body></worldbody>', "positions"),
    ('<worldbody><body><joint name="a"/><geom size="0.1"/></body>'
     '</worldbody><tendon><fixed name="t"><joint joint="a"/></fixed>'
     '</tendon><actuator><motor tendon="t"/></actuator>', "tendon"),
    ('<option viscosity="0.1"/><worldbody/>', "fluid"),
])
def test_unsupported_mjcf_raises(tmp_path, snippet, word):
    path = tmp_path / "m.xml"
    path.write_text(f'<mujoco model="m">{snippet}</mujoco>')
    if word in ("site", "tendon"):
        # sites (massless, never colliding) and actuators on fixed tendons
        # import now
        b = nt.ModelBuilder()
        b.add_mjcf(str(path))
        m = b.finalize("cpu")
        if word == "site":
            assert int(nt.GeoType.NONE) in b.shape_type
            assert m.structure.rigid_contact_max == 0
        else:
            au = m.structure.mjc_actuation
            assert (au.tendon[0], au.dof[0]) == (0, -1)
        return
    if word == "equality":
        # <equality> imports now (connect, weld and joint rows); an empty
        # section adds no constraint
        b = nt.ModelBuilder()
        b.add_mjcf(str(path))
        assert b.eq_type == [] and b.finalize("cpu").structure.eq_count == 0
        return
    if word == "slide":
        # a slide then a hinge in one body is one D6 joint now; a slide
        # after a hinge (a translation along a rotated axis) still raises
        b = nt.ModelBuilder()
        b.add_mjcf(str(path))
        assert b.joint_dof_dim == [(1, 1)]
        path.write_text(f'<mujoco model="m">{snippet}</mujoco>'.replace(
            '<joint type="slide"/><joint type="hinge"/>',
            '<joint type="hinge"/><joint type="slide"/>'))
    with pytest.raises(NotImplementedError, match=word):
        nt.ModelBuilder().add_mjcf(str(path))
