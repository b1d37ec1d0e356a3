"""The port's contact examples against the JAX package's own examples on
the CPU, frame by frame from the same start (none of them draws random
numbers): ``hetero_worlds`` (B2's padded, non-uniform plan) through its
spheres' landing, ``contact_forces`` (the reported force and its logged
scalar), ``contact_restitution`` (the rebound apexes it tracks) through
the first bounce, ``mujoco_sleeping`` through the first frame at which
a box sleeps (frame 8), its ``sleep:count:*`` counters compared exactly,
``muscle`` (``State.clear_forces`` every substep) and ``balance_bird``.

Tolerances, atol = rtol: rigid bodies under the generalized solvers
``joint_q``/``body_q`` 2e-4 and ``joint_qd``/``body_qd`` 5e-3
(tests/test_batched_step.py:69-75); the XPBD and semi-implicit examples
the same 2e-4 and 5e-3 that tests/test_torch_xpbd.py:275-276 holds XPBD
steps to; reported forces, logged scalars and the tracked apexes 5e-3.

Reference defects that shape these numbers and that the port reproduces:
``mujoco_sleeping``'s solver wakes a box only on ``joint_f`` (C.19; no
force is applied here, so the sleeping boxes stay frozen). The JAX
package's ``SensorContact`` dense matrices (C.37) are not on these
paths: ``contact_forces`` reads ``step_with_contacts``' report.
"""

import numpy as np
import pytest
import torch

from test_torch_examples_basic_parity import (SCALAR_TOL, _np,
                                              frame_by_frame, scalars,
                                              state_fields)

torch.set_num_threads(1)


def _contact_forces(ex):
    return {**state_fields(ex), **scalars(ex),
            "normal_force": (np.asarray(ex.normal_force), SCALAR_TOL)}


def _restitution(ex):
    return {**state_fields(ex),
            "max_height": (np.asarray(ex.max_height), SCALAR_TOL),
            "bounced": (np.asarray(ex.bounced), 0.0)}


def _sleeping(ex):
    out = state_fields(ex)
    for k, v in ex.state.custom.items():
        if k.startswith("sleep:count:"):
            out[k] = (_np(v), 0.0)
    out["asleep"] = (np.asarray(ex.asleep_count()), 0.0)
    return out


def _bodies(ex):
    return {k: v for k, v in state_fields(ex).items()
            if k.startswith("body_")}


# (frames compared, what is read)
CASES = {
    "hetero_worlds": (20, state_fields),
    "contact_forces": (16, _contact_forces),
    "contact_restitution": (30, _restitution),
    "mujoco_sleeping": (10, _sleeping),
    "muscle": (8, _bodies),
    "balance_bird": (8, state_fields),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_contact_example_matches_jax_frame_by_frame(name):
    frames, read = CASES[name]
    jex, tex = frame_by_frame(name, frames, read)
    if name == "mujoco_sleeping":
        assert tex.asleep_count() >= 1       # compared through a sleep
    if name == "contact_restitution":
        assert tex.bounced.any()             # compared through a bounce
    if name == "hetero_worlds":
        assert not tex.solver.contact_plans[0].uniform
