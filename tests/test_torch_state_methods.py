"""The port's ``State.clear_forces``, ``body_count``, ``particle_count``,
``requires_grad`` and ``Control.clear`` against the JAX package's on the
same numpy inputs: a scene of two free boxes, a hinged link and three
particles, every field of the state and control drawn from one seed.
The methods copy or zero tensors, so they are held bit for bit.

The JAX ``requires_grad`` is always True (JAX arrays are always
differentiable); the port's reads whether any floating-point tensor
requires grad, as torch does, so it equals the JAX package's once a
tensor of the state requires grad, and is False before.
"""

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt

torch.set_num_threads(1)
STATE_FIELDS = ("body_q", "body_qd", "body_f", "joint_q", "joint_qd",
                "particle_q", "particle_qd", "particle_f")
CONTROL_FIELDS = ("joint_target_q", "joint_target_qd", "joint_f")


def _scene(lib):
    b = lib.ModelBuilder()
    for i in range(2):
        body = b.add_body(xform=[i, 0, 1, 0, 0, 0, 1])
        b.add_shape_box(body, hx=0.1, hy=0.1, hz=0.1)
        b.add_joint_free(body)
    link = b.add_body(xform=[0.5, 0, 2, 0, 0, 0, 1])
    b.add_shape_capsule(link, radius=0.05, half_height=0.2)
    b.add_joint_revolute(parent=-1, child=link, axis="Y",
                         xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
    for k in range(3):
        b.add_particle((0.1 * k, 0.0, 0.5), mass=0.1)
    return b


@pytest.fixture(scope="module")
def pair():
    """(JAX state, port state, JAX control, port control), every field
    the same random values."""
    import jax.numpy as jnp
    import newton_tpu as jt
    jm = _scene(jt).finalize()
    tm = _scene(nt).finalize("cpu")
    rng = np.random.default_rng(24)
    js, ts = jm.state(), tm.state()
    jc, tc = jm.control(), tm.control()

    def draw(obj, names):
        return {n: rng.standard_normal(np.shape(getattr(obj, n)))
                .astype(np.float32) for n in names}
    sv, cv = draw(ts, STATE_FIELDS), draw(tc, CONTROL_FIELDS)
    js = js.replace(**{n: jnp.asarray(v) for n, v in sv.items()})
    ts = ts.replace(**{n: torch.as_tensor(v) for n, v in sv.items()})
    jc = jc.replace(**{n: jnp.asarray(v) for n, v in cv.items()})
    tc = tc.replace(**{n: torch.as_tensor(v) for n, v in cv.items()})
    return js, ts, jc, tc


def _same(got, ref, names):
    for n in names:
        np.testing.assert_array_equal(getattr(got, n).detach().numpy(),
                                      np.asarray(getattr(ref, n)),
                                      err_msg=n)


def test_clear_forces_matches_jax(pair):
    js, ts, _, _ = pair
    got, ref = ts.clear_forces(), js.clear_forces()
    _same(got, ref, STATE_FIELDS)
    assert not got.body_f.any() and not got.particle_f.any()
    # a new state: the input keeps its forces
    assert ts.body_f.any() and ts.particle_f.any()
    assert got is not ts and got.body_q is ts.body_q


def test_clear_forces_keeps_the_graph():
    """A loss of the cleared state's ``body_q`` still has a gradient to
    the ``body_q`` it was made from, and none flows through the zeroed
    forces."""
    s = _scene(nt).finalize("cpu").state()
    q = s.body_q.clone().requires_grad_(True)
    f = s.body_f.clone().requires_grad_(True)
    out = s.replace(body_q=q * 2.0, body_f=f * 3.0).clear_forces()
    assert out.body_q.grad_fn is not None
    assert not out.body_f.requires_grad
    (out.body_q.sum() + out.body_f.sum()).backward()
    np.testing.assert_array_equal(q.grad.numpy(),
                                  np.full(tuple(q.shape), 2.0, np.float32))
    assert f.grad is None


@pytest.mark.parametrize("name", ["body_count", "particle_count"])
def test_counts_match_jax(pair, name):
    js, ts, _, _ = pair
    assert getattr(ts, name) == getattr(js, name)
    assert isinstance(getattr(ts, name), int)
    assert ts.body_count == 3 and ts.particle_count == 3


@pytest.mark.parametrize("field", ["body_q", "joint_qd", "particle_f",
                                   "custom"])
def test_requires_grad_reads_any_float_tensor(pair, field):
    js, ts, _, _ = pair
    assert js.requires_grad is True
    assert ts.requires_grad is False
    if field == "custom":
        s = ts.replace(custom={"n": torch.zeros(2, dtype=torch.int32),
                               "x": torch.zeros(2).requires_grad_(True)})
    else:
        s = ts.replace(**{field: getattr(ts, field).clone()
                          .requires_grad_(True)})
    assert s.requires_grad == js.requires_grad


def test_control_clear_matches_jax(pair):
    _, _, jc, tc = pair
    got, ref = tc.clear(), jc.clear()
    _same(got, ref, CONTROL_FIELDS)
    assert not got.joint_f.any() and tc.joint_f.any()
    assert got.joint_target_q is tc.joint_target_q
