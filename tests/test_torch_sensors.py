"""The port's IMU, frame-transform and contact sensors against the JAX
package's on the same inputs: two gymnasium ants with a site on each
torso, at a random state and a previous state a step earlier (IMU, frame
transforms with a world-static reference), and Contacts of the static
pipeline and of the dynamic-pair pipeline whose forces, points and
masks are replaced by seeded random ones (the contact sensor reads only
those and the slots' shapes). Contact cases: counterpart sets, a shape
in two sensing sets, and no counterpart restriction. Tolerances: float32
elementwise 1e-5 absolute and relative; the contact sums (forces of
order 10 N over up to 100 slots, summed in another order than JAX's
einsum) 1e-4 absolute and relative."""

import dataclasses

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.sensors import (SensorContact, SensorFrameTransform,
                                      SensorIMU)

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
SUM_TOL = dict(atol=1e-4, rtol=1e-4)
N = 2


def _scene(lib):
    r = lib.ModelBuilder()
    r.add_mjcf(nt.ASSET_DIR + "/ant.xml")
    r.add_site(0, xform=[0.05, -0.02, 0.1, 0.0, 0.0, np.sin(0.3),
                         np.cos(0.3)], key="imu")
    b = lib.ModelBuilder()
    b.replicate(r, N)
    return b


@pytest.fixture(scope="module")
def pair():
    """(JAX model, port model, JAX states, port states): the state and
    one a step of 1/240 s earlier, with other velocities."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_fk
    jm, tm = _scene(jt).finalize(), _scene(nt).finalize("cpu")
    rng = np.random.default_rng(4)
    states = []
    for k in range(2):
        q = np.asarray(jm.joint_q0).copy()
        q.reshape(N, -1)[:, 7:] += rng.uniform(-0.4, 0.4, (N, 8))
        q.reshape(N, -1)[:, 2] -= 0.3
        qd = rng.normal(0, 1, jm.joint_dof_count).astype(np.float32)
        js = j_fk(jm, jnp.asarray(q, jnp.float32), jnp.asarray(qd),
                  jm.state())
        ts = nt.eval_fk(tm, torch.as_tensor(q, dtype=torch.float32),
                        torch.as_tensor(qd), tm.state())
        states.append((js, ts))
    return jm, tm, states


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


def test_imu_matches_jax(pair):
    from newton_tpu.sensors import SensorIMU as JIMU
    jm, tm, ((js, ts), (jp, tp)) = pair
    sites = [i for i, k in enumerate(tm.structure.shape_key)
             if k.endswith("imu")]
    assert len(sites) == N
    ji, ti = JIMU(jm, sites), SensorIMU(tm, sites)
    for prev in ((None, None), (jp, tp)):
        ref = ji.update(js, prev[0], 1.0 / 240.0)
        got = ti.update(ts, prev[1], 1.0 / 240.0)
        for g, r in zip(got, ref):
            _close(g, r)
    # by key: the first site of that key
    key = tm.structure.shape_key[sites[0]]
    _close(SensorIMU(tm, [key]).update(ts)[1], JIMU(jm, [key]).update(js)[1])


def test_frame_transform_matches_jax(pair):
    from newton_tpu.sensors import SensorFrameTransform as JFT
    jm, tm, ((js, ts), _) = pair
    keys = tm.structure.shape_key
    site = [i for i, k in enumerate(keys) if k.endswith("imu")][0]
    floor = [i for i, k in enumerate(keys) if k.endswith("floor")][0]
    targets = [1, 3, 7, floor, site + 1]
    for refs in ([site], [floor], [site] * len(targets)):
        ref = JFT(jm, refs, targets).update(js)
        got = SensorFrameTransform(tm, refs, targets).update(ts)
        _close(got, ref)
    with pytest.raises(ValueError, match="matched"):
        SensorFrameTransform(tm, ["*ankle*"], [1])


def _random_contacts(jc, tc, rng):
    """The same random forces, points and mask on both Contacts (of equal
    slot shapes)."""
    import jax.numpy as jnp
    C = tc.rigid_contact_mask.shape[0]
    f = rng.normal(0, 10, (C, 3)).astype(np.float32)
    p = rng.normal(0, 1, (C, 3)).astype(np.float32)
    m = rng.random(C) < 0.7
    tc = dataclasses.replace(
        tc, rigid_contact_force=torch.as_tensor(f),
        rigid_contact_position=torch.as_tensor(p),
        rigid_contact_mask=torch.as_tensor(m) & (tc.rigid_contact_shape0
                                                 >= 0))
    jc = jc.replace(
        rigid_contact_shape0=jnp.asarray(tc.rigid_contact_shape0.numpy()),
        rigid_contact_shape1=jnp.asarray(tc.rigid_contact_shape1.numpy()),
        rigid_contact_force=jnp.asarray(f),
        rigid_contact_position=jnp.asarray(p),
        rigid_contact_mask=jnp.asarray(tc.rigid_contact_mask.numpy()))
    return jc, tc


def _sensor_sets(st):
    """Per world: the four lower legs (counterpart: that world's floor),
    the torso, and world 0's first lower leg again in a set of its own
    (a shape in two sensing sets); counterparts per set."""
    keys = st.shape_key
    ankles = [i for i, k in enumerate(keys) if "ankle" in k]
    floors = [i for i, k in enumerate(keys) if k.endswith("floor")]
    torsos = [i for i, k in enumerate(keys) if k.endswith("torso_geom")]
    per = len(ankles) // N
    sense = [ankles[w * per:(w + 1) * per] for w in range(N)]
    sense += [[t] for t in torsos] + [[ankles[0], torsos[1]]]
    counter = [[floors[w]] for w in range(N)] + [[floors[0], floors[1]]] * N
    counter += [[floors[0], ankles[1]]]
    return sense, counter


@pytest.mark.parametrize("mode", ["static", "dynamic"])
@pytest.mark.parametrize("counterparts", [True, False])
def test_contact_sensor_matches_jax(pair, mode, counterparts):
    from newton_tpu.sensors import SensorContact as JSC
    from newton_tpu.sim.collide import CollisionPipeline as JP
    jm, tm, ((js, ts), _) = pair
    sense, counter = _sensor_sets(tm.structure)
    if not counterparts:
        counter = None
    jc = JP(jm).collide(js)
    kw = dict(mode="dynamic", dynamic_pair_budget=24) \
        if mode == "dynamic" else {}
    tc = nt.CollisionPipeline(tm, **kw).collide(ts)
    assert tc.dynamic == (mode == "dynamic")
    jc, tc = _random_contacts(jc, tc, np.random.default_rng(5))
    ref = JSC(jm, sense, counter).update(jc)
    got = SensorContact(tm, sense, counter).update(tc)
    for g, r in zip(got, ref):
        _close(g, r, SUM_TOL)
    assert float(got[0].abs().sum()) > 0.0
    # no dense (sensors, shapes) or (sensors, slots) tables
    sc = SensorContact(tm, sense, counter)
    assert not any(isinstance(v, np.ndarray) and v.ndim == 2
                   for v in vars(sc).values())
