"""The port's ``basic_*`` examples against the JAX package's own examples
on the CPU, frame by frame from the same start (none of them draws random
numbers): ``basic_pendulum``, ``basic_sphere``, ``basic_conveyor``,
``basic_heightfield``, ``basic_plotting`` (its logged height and energy),
``basic_joints``, ``basic_dzhanibekov``, ``basic_urdf``,
``basic_conveyor_forces`` (its reported normal and drag forces) and
``basic_multi_solver_overlay`` (all three states). ``basic_shapes`` is
in ``test_torch_examples_shapes_parity.py``: the JAX package's jit of its
support-map collide takes minutes, so it runs eagerly there, alone.

Tolerances, atol = rtol: rigid bodies under the generalized solvers
``joint_q``/``body_q`` 2e-4 and ``joint_qd``/``body_qd`` 5e-3
(tests/test_batched_step.py:69-75); the XPBD examples the same 2e-4 and
5e-3 that tests/test_torch_xpbd.py:275-276 holds XPBD steps to. Logged
scalars and reported forces 5e-3, the velocities' tolerance (they are
read from positions and velocities of one frame).

Reference defects that shape these numbers and that the port reproduces:
``basic_heightfield``'s heightfield pairs take the default 4 slots (C.28).
``basic_urdf`` reads its URDF as the JAX importer does (C.20).
"""

import importlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

Q_TOL, QD_TOL, SCALAR_TOL = 2e-4, 5e-3, 5e-3
STATE_TOL = {"joint_q": Q_TOL, "body_q": Q_TOL, "joint_qd": QD_TOL,
             "body_qd": QD_TOL}


class _Args:
    device = "cpu"
    num_worlds = 2
    test = False


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def state_fields(ex, prefix="", state=None):
    """{name: (array, atol)} of a state's rigid fields."""
    s = ex.state if state is None else state
    return {prefix + k: (_np(getattr(s, k)), t) for k, t in
            STATE_TOL.items()}


def scalars(ex):
    """The viewer's logged scalars, each series whole."""
    return {f"scalar {k}": (np.asarray(v), SCALAR_TOL)
            for k, v in ex.viewer.scalars.items()}


def examples(name, num_worlds=2):
    """(JAX example, port example) of one name, on the CPU."""
    from newton_tpu.viewer import ViewerNull as JViewerNull

    from newton_tpu_torch.viewer import ViewerNull

    class Args(_Args):
        pass
    Args.num_worlds = num_worlds
    jmod = importlib.import_module(f"newton_tpu.examples.example_{name}")
    tmod = importlib.import_module(
        f"newton_tpu_torch.examples.example_{name}")
    return jmod.Example(JViewerNull(), Args()), tmod.Example(ViewerNull(),
                                                              Args())


def frame_by_frame(name, frames, read=state_fields, num_worlds=2,
                   jax_step=None, pair=None):
    """Step the JAX and the port example ``frames`` frames from the same
    start, rendering each, and hold every quantity that ``read`` gives
    (``{name: (array, atol)}``, atol = rtol) after every frame. Returns
    the two examples."""
    jex, tex = pair or examples(name, num_worlds)
    for frame in range(frames + 1):
        got, ref = read(tex), read(jex)
        assert got.keys() == ref.keys(), (got.keys(), ref.keys())
        for key, (g, atol) in got.items():
            r = ref[key][0]
            assert g.shape == r.shape, (name, frame, key, g.shape, r.shape)
            np.testing.assert_allclose(g, r, atol=atol, rtol=atol,
                                       err_msg=f"{name} frame {frame} {key}")
        if frame < frames:
            (jax_step or type(jex).step)(jex)
            tex.step()
            jex.render()
            tex.render()
    assert tex.time == pytest.approx(jex.time)
    return jex, tex


def _conveyor_forces(ex):
    return {**state_fields(ex), **scalars(ex),
            "normal_force": (np.asarray(ex.normal_force), SCALAR_TOL),
            "drag_force": (np.asarray(ex.drag_force), SCALAR_TOL)}


def _overlay(ex):
    out = {}
    for (solver, _), s in zip(ex.solvers, ex.states):
        out.update(state_fields(ex, f"{solver} ", s))
    return out


# (frames compared, what is read)
CASES = {
    "basic_pendulum": (8, state_fields),
    "basic_sphere": (8, state_fields),
    "basic_conveyor": (8, state_fields),
    "basic_heightfield": (8, state_fields),
    "basic_plotting": (8, lambda ex: {**state_fields(ex), **scalars(ex)}),
    "basic_joints": (8, state_fields),
    "basic_dzhanibekov": (8, state_fields),
    "basic_urdf": (8, state_fields),
    "basic_conveyor_forces": (8, _conveyor_forces),
    "basic_multi_solver_overlay": (8, _overlay),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_basic_example_matches_jax_frame_by_frame(name):
    frames, read = CASES[name]
    frame_by_frame(name, frames, read)


def test_free_joint_velocity_seeded_from_the_body_twist():
    """``add_body(qd=)`` on a free body seeds its joint's six velocities
    at ``finalize`` (the JAX finalize's rule): the Dzhanibekov handle
    starts spinning, in both packages."""
    jex, tex = examples("basic_dzhanibekov")
    np.testing.assert_array_equal(_np(tex.model.joint_qd0),
                                  _np(jex.model.joint_qd0))
    np.testing.assert_allclose(_np(tex.model.joint_qd0),
                               [0, 0, 0, 0.05, 12.0, 0], rtol=1e-7)
    np.testing.assert_allclose(tex.L0, jex.L0, rtol=1e-6)
