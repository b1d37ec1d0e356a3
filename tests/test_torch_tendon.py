"""Parity: the port's spatial tendons (``sim/tendon.py``: sphere and
cylinder wraps with sidesites, lengths and moment rows), their MJCF import
(``<site>``, ``<spatial>``, tendon actuators) and the tendon finger
(example_tendon_finger.py) against the JAX package's.

Tolerances: lengths and moment rows 1e-5 relative (float32 on both
sides, the same operations up to order); moment rows against a central
finite difference of the length through FK 5e-3 (tests/test_tendon.py's
gate); the finger's 30 frames (120 substeps) joint_q 1e-4, joint_qd 1e-3
of the JAX package's.
"""

import math

import numpy as np
import pytest
import torch

import chip_smoke as cs
import newton_tpu_torch as nt
from newton_tpu_torch.sim.tendon import (SpatialTendonPath,
                                         eval_spatial_tendons,
                                         spatial_tendon_rest_length)
from newton_tpu_torch.solvers.generalized import batched as t_batched

torch.set_num_threads(1)

WRAP_MJCF = """
<mujoco model="wrap">
  <option gravity="0 0 -9.81" timestep="0.002"/>
  <worldbody>
    <site name="anchor" pos="0 0 1"/>
    <body name="arm" pos="0 0 0.5">
      <joint name="hinge" type="hinge" axis="0 1 0" range="-2.5 2.5"
             damping="0.2"/>
      <geom name="rod" type="capsule" fromto="0 0 0 0.4 0 0" size="0.02"/>
      <geom name="wrapcyl" type="cylinder" pos="0.15 0 0.08" zaxis="0 1 0"
            size="0.05 0.1" contype="0" conaffinity="0"/>
      <site name="tip" pos="0.4 0 0"/>
    </body>
  </worldbody>
  <tendon>
    <spatial name="flexor" stiffness="40" damping="0.5">
      <site site="anchor"/>
      <geom geom="wrapcyl"/>
      <site site="tip"/>
    </spatial>
  </tendon>
  <actuator>
    <motor name="pull" tendon="flexor" gear="1" ctrlrange="-5 5"
           ctrllimited="true"/>
  </actuator>
</mujoco>
"""


def _paths():
    """A sphere wrap, a cylinder helix, a sidesite and a site-only path,
    over three bodies and the world."""
    return [
        [("site", -1, (0.3, 0.1, 1.2)), ("sphere", 0, (0.05, 0, 0), 0.15,
                                         None),
         ("site", 1, (0.1, 0.02, -0.05))],
        [("site", 0, (0.2, 0.0, 0.1)),
         ("cylinder", 1, (0.0, 0.0, 0.0), (0.0, 0.6, 0.8), 0.12, None),
         ("site", 2, (0.05, 0.1, 0.0)), ("site", 2, (0.3, 0.0, 0.1))],
        [("site", 0, (0.3, 0.0, 0.0)),
         ("cylinder", 1, (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), 0.2,
          (0.0, -0.5, 0.0)),
         ("site", 2, (-0.3, 0.05, 0.0))],
        [("site", 0, (0.0, 0.0, 0.0)), ("site", 1, (0.1, 0.0, 0.0))],
    ]


def _poses(rng, n):
    q = rng.randn(n, 3, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p = 0.2 * rng.randn(n, 3, 3) + np.array([0.0, 0.0, 1.0])
    return np.concatenate([p, q], -1).astype(np.float32)


def test_eval_matches_jax():
    """Lengths and moment rows of four paths (sphere wrap, cylinder helix,
    sidesite, plain sites) at 16 random pose sets with a random dof
    subspace and ancestry, against the JAX package's
    ``eval_spatial_tendons`` (component tuples, bodies on the leading
    axis)."""
    import jax.numpy as jnp
    from newton_tpu.sim import tendon as jtendon
    rng = np.random.RandomState(0)
    n, D = 16, 5
    bq = _poses(rng, n)                                      # (n, 3, 7)
    v_o = rng.randn(n, D, 3).astype(np.float32)
    w_o = rng.randn(n, D, 3).astype(np.float32)
    anc = (rng.rand(3, D) > 0.4).astype(np.float32)
    tp = [SpatialTendonPath(p) for p in _paths()]
    jp = [jtendon.SpatialTendonPath(p) for p in _paths()]
    L, J = eval_spatial_tendons(tp, torch.as_tensor(bq),
                                torch.as_tensor(v_o), torch.as_tensor(w_o),
                                torch.as_tensor(anc))
    # the JAX package's layout: (B, n) components, the subspace (D, n)
    bp = tuple(jnp.asarray(bq[:, :, k].T) for k in range(3))
    bqq = tuple(jnp.asarray(bq[:, :, 3 + k].T) for k in range(4))
    vo = tuple(jnp.asarray(v_o[:, :, k].T) for k in range(3))
    wo = tuple(jnp.asarray(w_o[:, :, k].T) for k in range(3))
    Lj, Jj = jtendon.eval_spatial_tendons(jp, bp, bqq, vo, wo, anc)
    for k in range(len(tp)):
        np.testing.assert_allclose(L[k].numpy(), np.asarray(Lj[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(J[k].numpy(), np.asarray(Jj[k]).T,
                                   rtol=1e-5, atol=1e-5)


def test_analytic_wraps_and_sidesite():
    """tests/test_tendon.py's cases on the port: the sphere's tangent-arc-
    tangent length, the cylinder's helix sqrt(L2d^2 + dz^2) and the
    sidesite that flips the wrap to the longer side."""
    ident = np.zeros((1, 7))
    ident[:, 6] = 1.0

    def length(elems):
        return spatial_tendon_rest_length(SpatialTendonPath(elems), ident)
    sphere = length([("site", -1, (2.0, 0, 0)),
                     ("sphere", -1, (0, 0, 0), 1.0, None),
                     ("site", -1, (-2.0, 0, 0))])
    assert abs(sphere - (2 * math.sqrt(3.0) + math.pi / 3)) < 1e-6
    r = 0.5
    helix = length([("site", -1, (2.0, 0, 0)),
                    ("cylinder", -1, (0, 0, 0), (0, 0, 1), r, None),
                    ("site", -1, (-2.0, 0, 1.0))])
    L2d = 2 * math.sqrt(4 - r * r) + r * (math.pi - 2 * math.acos(r / 2))
    assert abs(helix - math.sqrt(L2d ** 2 + 1.0)) < 1e-6

    def side(s):
        return length([("site", -1, (2.0, 0, 0)),
                       ("cylinder", -1, (0, 0, 0), (0, 0, 1), r, s),
                       ("site", -1, (-2.0, 0.3, 0))])
    assert side((0.0, -2.0, 0.0)) > side(None) + 0.1


@pytest.fixture(scope="module")
def wrap(tmp_path_factory):
    """WRAP_MJCF (tests/test_tendon.py) on both sides."""
    import newton_tpu as jt
    path = tmp_path_factory.mktemp("wrap") / "wrap.xml"
    path.write_text(WRAP_MJCF)
    jb = jt.ModelBuilder()
    jb.add_mjcf(str(path))
    b = nt.ModelBuilder()
    b.add_mjcf(str(path))
    return jb.finalize(), b.finalize("cpu")


def _port_L_J(m, q):
    solver = nt.SolverMuJoCo(m)
    grp = solver.groups[0]
    t = grp.tables
    s = nt.eval_fk(m, torch.as_tensor([q], dtype=torch.float32),
                   torch.zeros(1, 1), nt.batch_state(m.state(), 1))
    v_o, w_o = t_batched._dof_subspace(t, s.body_q, s.joint_q)
    L, _, J = t_batched._spatial_tendons(t, s.body_q, s.joint_qd, v_o, w_o)
    return float(L[0, 0]), float(J[0, 0, 0])


def test_import_matches_jax(wrap):
    """The MJCF ``<spatial>`` import (tests/test_importers.py:162's
    elements: sites in the world and a body, a cylinder wrap geom): the
    path, the parameters (rest length from the build pose), the tendon
    actuator and the finalized leaves equal the JAX package's; sites take
    no contact slot."""
    jm, tm = wrap
    jst, tst = jm.structure, tm.structure
    assert tst.sten_count == jst.sten_count == 1
    assert tst.sten_key == list(jst.sten_key)
    for te, je in zip(tst.sten_paths[0].elems, jst.sten_paths[0].elems):
        assert te[0] == je[0] and te[1] == je[1]
        for a, b in zip(te[2:], je[2:]):
            np.testing.assert_allclose(np.asarray(a, float),
                                       np.asarray(b, float), atol=1e-12)
    np.testing.assert_allclose(tm.sten_params.numpy(),
                               np.asarray(jm.sten_params), rtol=1e-6)
    for f in ("dof", "coord", "tendon", "sten", "gear", "ctrlrange",
              "ctrllimited", "gaintype", "biastype"):
        np.testing.assert_array_equal(getattr(tst.mjc_actuation, f),
                                      getattr(jst.mjc_actuation, f))
    assert tst.rigid_contact_max == jst.rigid_contact_max
    assert (tm.shape_type.numpy() == int(nt.GeoType.NONE)).sum() == 2


def test_moment_row_matches_finite_difference(wrap):
    """dL/dq through the port's FK against its moment row at four hinge
    angles (through the wrap and clear of it)."""
    _, tm = wrap
    for qv in (-0.9, -0.3, 0.4, 1.1):
        eps = 1e-3
        fd = (_port_L_J(tm, qv + eps)[0] - _port_L_J(tm, qv - eps)[0]) \
            / (2 * eps)
        J = _port_L_J(tm, qv)[1]
        assert abs(J - fd) < 5e-3 * max(1.0, abs(fd)), (qv, J, fd)


def test_finger_trajectory_matches_jax():
    """example_tendon_finger.py: 30 frames of 4 substeps at 1/240 pulled
    at -6, the port's ``step`` against the JAX package's, under euler and
    implicitfast (the tendon's kd J^T J implicit)."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk as j_eval_fk
    from newton_tpu.solvers import SolverMuJoCo as JSolver
    jm = cs.mjcf_scene(jt, cs.FINGER_MJCF, 1).finalize()
    tm = cs.mjcf_scene(nt, cs.FINGER_MJCF, 1).finalize("cpu")
    for integ in ("euler", "implicitfast"):
        js = JSolver(jm, iterations=8, integrator=integ)
        ts = nt.SolverMuJoCo(tm, iterations=8, integrator=integ)
        jc = jm.control()
        jc = jc.replace(custom={**jc.custom,
                                "mjc:ctrl": jnp.asarray([-6.0])})
        frame = jax.jit(lambda s: jax.lax.scan(
            lambda x, _: (js.step(x, None, jc, None, 1 / 240), None), s,
            None, length=4)[0])
        sj = j_eval_fk(jm, jm.joint_q0, jm.joint_qd0, jm.state())
        st = nt.eval_fk(tm, tm.joint_q0, tm.joint_qd0, tm.state())
        tc = tm.control()
        tc.custom["mjc:ctrl"] = torch.tensor([-6.0])
        for _ in range(30):
            sj = frame(sj)
            for _ in range(4):
                st = ts.step(st, None, tc, None, 1 / 240)
        np.testing.assert_allclose(st.joint_q.numpy(),
                                   np.asarray(sj.joint_q), atol=1e-4)
        np.testing.assert_allclose(st.joint_qd.numpy(),
                                   np.asarray(sj.joint_qd), atol=1e-3)
        assert float(st.joint_q[1]) > 0.3          # the pip flexes


def test_replicated_finger_equals_one_world():
    """The finger x 3 through ``replicate`` + ``step`` equals the one-world
    finger's ``step_batched`` exactly (spatial tendons and tendon
    actuators of each world in its own row)."""
    one = cs.mjcf_scene(nt, cs.FINGER_MJCF, 1).finalize("cpu")
    rep = cs.mjcf_scene(nt, cs.FINGER_MJCF, 3).finalize("cpu")
    so, sr = nt.SolverMuJoCo(one, iterations=8), nt.SolverMuJoCo(
        rep, iterations=8)
    rng = np.random.RandomState(2)
    q = rng.uniform(0, 1, (3, 2)).astype(np.float32)
    ctrl = rng.uniform(-8, 0, (3, 1)).astype(np.float32)
    sb = nt.eval_fk(one, torch.as_tensor(q), torch.zeros(3, 2),
                    nt.batch_state(one.state(), 3))
    sf = nt.eval_fk(rep, torch.as_tensor(q.reshape(-1)), torch.zeros(6),
                    rep.state())
    c = one.control()
    cb = nt.Control(joint_target_q=c.joint_target_q.expand(3, -1).clone(),
                    joint_target_qd=torch.zeros(3, 2),
                    joint_f=torch.zeros(3, 2),
                    custom={"mjc:ctrl": torch.as_tensor(ctrl)})
    cf = rep.control()
    cf.custom["mjc:ctrl"] = torch.as_tensor(ctrl.reshape(-1))
    for _ in range(4):
        sb = so.step_batched(sb, None, cb, None, 1 / 240)
        sf = sr.step(sf, None, cf, None, 1 / 240)
    assert torch.equal(sf.joint_q, sb.joint_q.reshape(-1))
    assert torch.equal(sf.joint_qd, sb.joint_qd.reshape(-1))
