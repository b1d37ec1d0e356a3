"""Four of the port's examples against the JAX package's own examples on
the CPU, frame by frame from the same start: ``robot_cartpole`` (state
feedback on the inverted pendulum), ``tendon_finger`` (a spatial tendon
and the motor on it), ``controller_impedance_hetero`` (per-world gains of
the model-based impedance law) and ``mpm_sand``. None of them draws
random numbers.

Tolerances: the robots' joint_q and body_q atol = rtol = 2e-4 and
joint_qd 5e-3 (tests/test_batched_step.py:69-75); the sand's particle_q
1e-6, particle_qd 1e-4, mpm:F 1e-5 and mpm:C 1e-3 absolute, as
tests/test_torch_mpm.py holds the port's MPM steps to the JAX package's.
"""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROBOT_TOL = {"joint_q": 2e-4, "joint_qd": 5e-3, "body_q": 2e-4}
MPM_TOL = {"particle_q": 1e-6, "particle_qd": 1e-4, "mpm:F": 1e-5,
           "mpm:C": 1e-3}
# (example, frames compared, tolerances)
CASES = {"robot_cartpole": (8, ROBOT_TOL), "tendon_finger": (8, ROBOT_TOL),
         "controller_impedance_hetero": (8, ROBOT_TOL),
         "mpm_sand": (2, MPM_TOL)}


class _Args:
    device = "cpu"
    num_worlds = 2
    test = False


def _read(state, name, numpy):
    v = state.custom[name] if ":" in name else getattr(state, name)
    return numpy(v)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_matches_jax_frame_by_frame(name):
    from newton_tpu.viewer import ViewerNull as JViewerNull

    from newton_tpu_torch.viewer import ViewerNull
    frames, tol = CASES[name]
    jmod = importlib.import_module(f"newton_tpu.examples.example_{name}")
    tmod = importlib.import_module(
        f"newton_tpu_torch.examples.example_{name}")
    jex = jmod.Example(JViewerNull(), _Args())
    tex = tmod.Example(ViewerNull(), _Args())
    for frame in range(frames + 1):
        for key, atol in tol.items():
            got = _read(tex.state, key, lambda t: t.numpy())
            ref = _read(jex.state, key, np.asarray)
            rtol = atol if tol is ROBOT_TOL else 0.0
            np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol,
                                       err_msg=f"{name} frame {frame} {key}")
        if frame < frames:
            jex.step()
            tex.step()
            jex.render()
            tex.render()
    assert tex.time == pytest.approx(jex.time)
