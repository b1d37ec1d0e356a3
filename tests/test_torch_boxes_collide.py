"""Every pair class of the port's static collide against the JAX
package's on one scene of boxes, cylinders, spheres, capsules and
planes (split from test_torch_boxes.py, whose scenes it uses): masks and
shape indices exactly, points, normals and depths 1e-5."""

import os
import sys

import numpy as np
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_boxes import (  # noqa: E402
    _all_pairs_scene,
    _assert_contacts,
    _poses,
)

torch.set_num_threads(1)


def test_collide_every_pair_class_matches_jax():
    """``collide`` on a scene with every new pair class, flat over 4
    replicated worlds and batched over 6 envs of one world, equals the JAX
    package's slot for slot: 8- and 16-slot classes land on their pairs'
    slots, the mask is exact, depth, position and normal within 1e-5."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.parallel import batch_state as j_batch_state
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    rng = np.random.RandomState(3)
    # flat: 4 worlds
    jm = _all_pairs_scene(jt, 4).finalize()
    tm = _all_pairs_scene(nt, 4).finalize("cpu")
    bq = _poses(rng, 4, 6)
    ref = JPipe(jm).collide(jm.state().replace(body_q=jnp.asarray(bq)))
    ts = tm.state()
    ts.body_q = torch.as_tensor(bq)
    got = nt.CollisionPipeline(tm).collide(ts)
    mask = _assert_contacts(tm, got, ref)
    # every class has active slots, on both slot counts' classes
    sb = tm.structure
    typ = sb.shape_type
    live = {(int(typ[a]), int(typ[b])) for a, b in
            zip(sb.slot_shape0[mask], sb.slot_shape1[mask])}
    assert len(live) >= 12, live
    # batched: one world, 6 envs
    jm1 = _all_pairs_scene(jt, 1).finalize()
    tm1 = _all_pairs_scene(nt, 1).finalize("cpu")
    bq1 = _poses(rng, 6, 6).reshape(6, 6, 7)
    sb_j = j_batch_state(jm1.state(), 6).replace(body_q=jnp.asarray(bq1))
    ref_b = jax.vmap(JPipe(jm1).collide)(sb_j)
    tsb = nt.batch_state(tm1.state(), 6)
    tsb.body_q = torch.as_tensor(bq1)
    got_b = nt.CollisionPipeline(tm1).collide(tsb)
    assert got_b.rigid_contact_mask.shape == (6, sb.rigid_contact_max // 4)
    mask_b = _assert_contacts(tm1, got_b, ref_b)
    assert mask_b.any(1).all()
