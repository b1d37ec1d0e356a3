"""The dynamic-pair pipeline's Contacts in the port against the JAX package
on the CPU, slot for slot (top-k ties included), at two scenes and two
budgets each, and the overflow count at a budget of one pair (split from
test_torch_dynamic.py, whose helpers they use).

Tolerances: masks, shape indices and overflow counts exactly; contact
points, normals and depths 1e-5 (float32 transform chains)."""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_dynamic import (  # noqa: E402
    _assert_contacts,
    _jax_state_like,
    grid_scene,
    pile_scene,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("scene, budget", [("grid", 40), ("grid", 10),
                                           ("pile", 64), ("pile", 16)])
def test_dynamic_contacts_match_jax(scene, budget):
    """``mode="dynamic"``: the slot count, every slot's mask and shape
    indices (top-k ties to the lower index, the grid's equal overlaps
    included), points, normals and depths, and ``broad_phase_dropped``
    equal the JAX pipeline's: at the start state and, for the pile, after
    its boxes fell 0.12 into each other."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe
    make = grid_scene if scene == "grid" else pile_scene
    jm, tm = make(jt).finalize(), make(nt).finalize("cpu")
    jp = JPipe(jm, mode="dynamic", dynamic_pair_budget=budget)
    tp = nt.CollisionPipeline(tm, mode="dynamic", dynamic_pair_budget=budget)
    assert tp.rigid_contact_max == jp.rigid_contact_max
    assert tp.rigid_contact_max < tm.structure.rigid_contact_max
    states = [np.asarray(jm.state().body_q)]
    if scene == "pile":
        q = states[0].copy()
        q[:, 2] -= 0.12 * (q[:, 2] > 0.5) + 0.05 * np.arange(len(q)) % 3
        states.append(q)
    for q in states:
        ref = jp.collide(_jax_state_like(jm, q))
        ts = tm.state()
        ts.body_q = torch.as_tensor(q)
        got = tp.collide(ts)
        assert got.dynamic and got.slots is None
        _assert_contacts(got, ref, f"{scene} {budget}: ")
    assert np.asarray(ref.rigid_contact_mask).any()


def test_overflow_count_at_budget_one():
    """tests/test_broad_phase.py:98 on the port: a 14-box stack with a
    budget of 1 (8 entries, the per-class floor) drops overlapping pairs
    and counts them, as the JAX pipeline does."""
    import newton_tpu as jt
    from newton_tpu.sim.collide import CollisionPipeline as JPipe

    def stack(lib):
        b = lib.ModelBuilder()
        for i in range(14):
            body = b.add_body(xform=[0, 0, 0.1 + 0.19 * i, 0, 0, 0, 1])
            b.add_shape_box(body, hx=0.1, hy=0.1, hz=0.1)
            b.add_joint_free(body)
        return b
    jm, tm = stack(jt).finalize(), stack(nt).finalize("cpu")
    ref = JPipe(jm, mode="dynamic", dynamic_pair_budget=1).collide(
        jm.state())
    got = nt.CollisionPipeline(tm, mode="dynamic",
                               dynamic_pair_budget=1).collide(tm.state())
    assert int(got.broad_phase_dropped) > 0
    _assert_contacts(got, ref)
