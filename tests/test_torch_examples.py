"""The port's examples entry point (``python -m newton_tpu_torch.examples``)
on the CPU: the registry holds exactly the ported examples, the CLI runs
one as a subprocess, nothing of JAX or the JAX package is imported, the
default device is the card (the CPU only on request), and every ported
example runs 2 frames on the CPU and ends finite.

The slow tier runs each example for the frame count of the JAX package's
example sweep (tests/test_examples.py:FRAMES) and its ``test_final``, as
that sweep does. The ``gpu`` cases step one robot and one MPM example on
the card, a frame through the kernels against a frame through their
plain versions (JAX is not needed)::

    python -m pytest -o addopts="" --noconftest -m gpu \\
        tests/test_torch_examples.py
"""

import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from newton_tpu_torch.examples import EXAMPLES, main
from newton_tpu_torch.viewer import ViewerNull

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORTED = {"robot_humanoid_batch", "robot_ant", "robot_cartpole",
          "robot_cheetah", "robot_walker2d", "robot_policy",
          "robot_arm_reach", "terrain_ant", "tendon_finger",
          "controller_impedance_hetero", "mpm_sand", "mpm_granular",
          "mpm_multi_material", "mpm_snow_ball", "mpm_viscous",
          "mpm_beam_twist"}
gpu = pytest.mark.gpu
needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA device")


class _Args:
    device = "cpu"
    num_worlds = 2
    test = True
    benchmark = False


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _finite(state):
    for name in ("body_q", "body_qd", "particle_q", "joint_q"):
        v = getattr(state, name)
        assert torch.isfinite(v).all(), name


def test_registry_lists_the_ported_examples():
    assert set(EXAMPLES) == PORTED
    for name, module in EXAMPLES.items():
        assert module == f"newton_tpu_torch.examples.example_{name}"


def test_cli_runs_an_example_as_a_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "newton_tpu_torch.examples", "robot_cartpole",
         "--device", "cpu", "--viewer", "null", "--num-frames", "2",
         "--test"], cwd=ROOT, env=_env(), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "test passed"


def test_examples_import_neither_jax_nor_the_jax_package():
    code = ("import sys, importlib\n"
            "from newton_tpu_torch.examples import EXAMPLES\n"
            "for m in EXAMPLES.values():\n"
            "    importlib.import_module(m)\n"
            "bad = [k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'newton_tpu' or "
            "k.startswith('newton_tpu.')]\n"
            "assert not bad, bad\n"
            "print(len(EXAMPLES))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [str(len(PORTED))]


def test_chip_smoke_runs_the_sweeps_frame_counts():
    """chip_smoke.py phase 60 runs each example for the JAX sweep's frame
    count, and names the kernels every ported example must launch."""
    import chip_smoke as cs
    from test_examples import FRAMES
    assert {n: FRAMES.get(n, 8) for n in PORTED} == {
        n: cs.EXAMPLE_FRAMES.get(n, 8) for n in PORTED}
    assert set(cs.EXAMPLE_KERNELS) == PORTED


def test_cli_lists_the_examples(capsys, monkeypatch):
    monkeypatch.setattr(sys, "stdin", None)
    assert main([]) == 1
    out = capsys.readouterr().out
    assert "robot_humanoid_batch" in out and "mpm_sand" in out


@pytest.mark.skipif("torch.cuda.is_available()",
                    reason="the default device is the card")
def test_default_device_is_the_card():
    """Without CUDA, an example asked for no device raises (no fallback to
    the CPU), as ModelBuilder.finalize does."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["robot_cartpole", "--viewer", "null", "--num-frames", "1"])


@pytest.mark.parametrize("name", sorted(PORTED))
def test_example_runs_two_frames_on_the_cpu(name):
    torch.set_num_threads(1)
    module = importlib.import_module(EXAMPLES[name])
    example = module.Example(ViewerNull(max_frames=2), _Args())
    for _ in range(2):
        example.step()
        example.render()
    _finite(example.state)
    assert example.time > 0.0


@pytest.mark.slow
@pytest.mark.examples
@pytest.mark.parametrize("name", sorted(PORTED))
def test_example_passes_its_test_final(name):
    from test_examples import FRAMES
    torch.set_num_threads(1)
    module = importlib.import_module(EXAMPLES[name])
    example = module.Example(ViewerNull(), _Args())
    for _ in range(FRAMES.get(name, 8)):
        example.step()
        example.render()
    _finite(example.state)
    example.test_final()


def _frames_through_both(name, frames=1, **kw):
    """One example on the card: ``frames`` frames through the kernels and
    the same from the same state through the plain versions."""
    class Args:
        device = "cuda"
        num_worlds = kw.get("num_worlds", 4)
    module = importlib.import_module(EXAMPLES[name])
    ex = module.Example(ViewerNull(), Args())
    start = ex.state.clone()
    for _ in range(frames):
        ex.step()
    got = ex.state
    ex.state, ex.kernels, ex.time = start, False, 0.0
    for _ in range(frames):
        ex.step()
    return got, ex.state


@gpu
@needs_cuda
def test_robot_example_kernels_match_plain_on_the_card():
    got, ref = _frames_through_both("robot_humanoid_batch", num_worlds=64)
    for name, atol in (("joint_q", 2e-4), ("joint_qd", 5e-3)):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                   getattr(ref, name).cpu().numpy(),
                                   atol=atol, rtol=atol, err_msg=name)


@gpu
@needs_cuda
def test_mpm_example_kernels_match_plain_on_the_card():
    """A frame of 25 steps, at 25 times the one-step tolerances that
    chip_smoke.MPM_TOL holds the transfers' kernel and plain paths to."""
    got, ref = _frames_through_both("mpm_sand")
    for name, atol in (("particle_q", 25e-6), ("particle_qd", 25e-4)):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                   getattr(ref, name).cpu().numpy(),
                                   atol=atol, err_msg=name)
