"""Parity: the port's batched static collision pipeline and its narrow-phase
pair functions against the JAX package (``jax.vmap(pipe.collide)``).

Masks and shape indices are equal; depth, position and normal on active
slots agree to 1e-5 (float32 transform chains)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newton_tpu as jt
from newton_tpu.geometry import narrow_phase as j_np
from newton_tpu.parallel import batch_state as j_batch_state
from newton_tpu.sim.articulation import eval_fk as j_eval_fk
from newton_tpu.sim.collide import CollisionPipeline as JPipe

import newton_tpu_torch as nt
from newton_tpu_torch.geometry import narrow_phase as t_np

torch.set_num_threads(1)

ATOL = 1e-5
W = 6


@pytest.fixture(scope="module")
def ant():
    path = os.path.join(nt.ASSET_DIR, "ant.xml")
    jb = jt.ModelBuilder()
    jb.add_mjcf(path)
    tb = nt.ModelBuilder()
    tb.add_mjcf(path)
    jm, tm = jb.finalize(), tb.finalize("cpu")
    return jm, tm, JPipe(jm), nt.CollisionPipeline(tm)


@pytest.mark.parametrize("drop", [0.0, 0.08])
def test_collide_matches_jax(ant, drop):
    jm, tm, jp, tp = ant
    rng = np.random.RandomState(11)
    q = np.tile(np.asarray(jm.joint_q0), (W, 1)) \
        + 0.02 * rng.randn(W, 15).astype(np.float32)
    q[:, 2] -= drop
    qd = 0.1 * rng.randn(W, 14).astype(np.float32)
    sb = jax.vmap(lambda a, b, s: j_eval_fk(jm, a, b, s))(
        jnp.asarray(q), jnp.asarray(qd), j_batch_state(jm.state(), W))
    ref = jax.vmap(jp.collide)(sb)
    tsb = nt.batch_state(tm.state(), W)
    tsb.body_q = torch.as_tensor(np.array(sb.body_q))
    got = tp.collide(tsb)
    mask = np.asarray(ref.rigid_contact_mask)
    np.testing.assert_array_equal(got.rigid_contact_mask.numpy(), mask)
    if drop:
        assert mask.any()
    for name in ("rigid_contact_shape0", "rigid_contact_shape1"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name in ("rigid_contact_depth", "rigid_contact_position",
                 "rigid_contact_normal"):
        np.testing.assert_allclose(getattr(got, name).numpy()[mask],
                                   np.asarray(getattr(ref, name))[mask],
                                   atol=ATOL, rtol=0, err_msg=name)
    np.testing.assert_array_equal(got.rigid_contact_depth.numpy()[~mask], 0)


def _random_transforms(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.randn(n, 3), q], 1).astype(np.float32)


@pytest.mark.parametrize("name", ["plane_sphere", "plane_capsule"])
def test_pair_function_matches_jax(name):
    rng = np.random.RandomState(5)
    n = 32
    X0, X1 = _random_transforms(rng, n), _random_transforms(rng, n)
    s0 = np.zeros((n, 3), np.float32)
    s1 = np.abs(rng.rand(n, 3)).astype(np.float32) + 0.05
    ref = getattr(j_np, name)(*map(jnp.asarray, (X0, X1, s0, s1)))
    got = getattr(t_np, name)(*map(torch.as_tensor, (X0, X1, s0, s1)))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)


def test_unported_pair_raises():
    from newton_tpu_torch.geometry.types import GeoType
    with pytest.raises(NotImplementedError, match="MESH-BOX"):
        t_np.contact_fn_for(int(GeoType.MESH), int(GeoType.BOX))
    fn, swapped, k = t_np.contact_fn_for(int(GeoType.BOX),
                                         int(GeoType.CAPSULE))
    assert (fn, swapped, k) == (t_np.capsule_box, True, 4)
