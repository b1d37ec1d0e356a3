"""Parity: the port's quaternion/transform/spatial math (newton_tpu_torch.math)
against newton_tpu.math on the same random inputs, atol 1e-6 (float32
elementwise arithmetic; only the order of a few sums differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newton_tpu.math as jm
import newton_tpu_torch.math as tm

torch.set_num_threads(1)

ATOL = 1e-6
N = 64


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


_rng = np.random.RandomState(0)
_IN = {
    "q": _unit(_rng.randn(N, 4)).astype(np.float32),
    "q2": _unit(_rng.randn(N, 4)).astype(np.float32),
    "qraw": (0.5 * _rng.randn(N, 4)).astype(np.float32),
    "v": _rng.randn(N, 3).astype(np.float32),
    "axis": _unit(_rng.randn(N, 3)).astype(np.float32),
    "ang": _rng.uniform(-3, 3, N).astype(np.float32),
    "s6": _rng.randn(N, 6).astype(np.float32),
    "s6b": _rng.randn(N, 6).astype(np.float32),
}
_IN["t"] = np.concatenate([_IN["v"], _IN["q"]], -1)
_IN["t2"] = np.concatenate([_rng.randn(N, 3).astype(np.float32), _IN["q2"]],
                           -1)

# name -> (argument keys, extra scalar args)
CASES = {
    "quat_mul": (("q", "q2"), ()),
    "quat_conjugate": (("q",), ()),
    "quat_normalize": (("qraw",), ()),
    "quat_rotate": (("q", "v"), ()),
    "quat_from_axis_angle": (("axis", "ang"), ()),
    "quat_to_matrix": (("q",), ()),
    "quat_integrate": (("q", "v"), (1.0 / 240.0,)),
    "transform_multiply": (("t", "t2"), ()),
    "transform_inverse": (("t",), ()),
    "transform_point": (("t", "v"), ()),
    "spatial_cross": (("s6", "s6b"), ()),
    "spatial_cross_dual": (("s6", "s6b"), ()),
    "velocity_at_point": (("s6", "v"), ()),
    "orthonormal_basis": (("axis",), ()),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_matches_jax(name):
    keys, extra = CASES[name]
    ref = getattr(jm, name)(*[jnp.asarray(_IN[k]) for k in keys], *extra)
    got = getattr(tm, name)(*[torch.as_tensor(_IN[k]) for k in keys], *extra)
    if not isinstance(ref, tuple):
        ref, got = (ref,), (got,)
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL,
                                   rtol=0)


def test_cross_matches_numpy():
    a, b = _IN["v"], _IN["axis"]
    np.testing.assert_allclose(
        tm.cross(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.cross(a, b), atol=ATOL, rtol=0)
