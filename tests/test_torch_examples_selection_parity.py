"""The port's selection and sensor examples against the JAX package's own
examples on the CPU, frame by frame from the same start (none of them
draws random numbers): ``selection_reset`` at 2 worlds through frame 31,
so that the masked root reset of frame 30 and the frame after it are
compared; ``selection_cartpole``, ``selection_articulations``,
``selection_multiple`` (both views' reads), ``selection_materials``
(per-world friction written through the view) and ``sensor_imu`` (its
logged ``imu/acc_z`` and the last acceleration).

Tolerances, atol = rtol: rigid bodies under the generalized solvers
``joint_q``/``body_q`` 2e-4 and ``joint_qd``/``body_qd`` 5e-3
(tests/test_batched_step.py:69-75); the XPBD examples the same 2e-4 and
5e-3 that tests/test_torch_xpbd.py:275-276 holds XPBD steps to; logged
scalars and the IMU's acceleration 5e-3.

Reference defects that shape these numbers and that the port reproduces:
``selection_cartpole``, ``selection_articulations`` and
``selection_materials`` replicate with spacing, and a free root (the
materials' boxes) is offset twice (C.45).
"""

import numpy as np
import pytest
import torch

from test_torch_examples_basic_parity import (Q_TOL, QD_TOL, SCALAR_TOL,
                                              _np, frame_by_frame, scalars,
                                              state_fields)

torch.set_num_threads(1)


def _views(*names):
    def read(ex):
        out = state_fields(ex)
        for n in names:
            v = getattr(ex, n)
            out[f"{n} q"] = (_np(v.get_dof_positions(ex.state)), Q_TOL)
            out[f"{n} qd"] = (_np(v.get_dof_velocities(ex.state)), QD_TOL)
        return out
    return read


def _roots(ex):
    return {**state_fields(ex),
            "roots": (_np(ex.view.get_root_transforms(ex.state)), Q_TOL)}


def _imu(ex):
    return {**state_fields(ex), **scalars(ex),
            "last_accel": (np.asarray(ex.last_accel), SCALAR_TOL)}


def _materials(ex):
    return {**_roots(ex), "mu": (_np(ex.view.get_attribute(
        "shape_material_mu", ex.model)), 0.0)}


# (frames compared, what is read)
CASES = {
    "selection_reset": (31, _roots),
    "selection_cartpole": (8, _views("view")),
    "selection_articulations": (8, _views("view")),
    "selection_multiple": (8, _views("carts", "pends")),
    "selection_materials": (8, _materials),
    "sensor_imu": (8, _imu),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_selection_example_matches_jax_frame_by_frame(name):
    frames, read = CASES[name]
    jex, tex = frame_by_frame(name, frames, read)
    if name == "selection_reset":
        assert tex.frame_i == 31 and tex.worlds == 2
        assert tex.reset_mask.device == tex.model.device
