"""The port's ``add_urdf`` against the JAX package on the CPU:
tests/test_importers.py:65, 81 and 92 on the port (the two-link robot
fixed and floating, collapse_fixed_joints); the double pendulum of
example_basic_urdf.py (its leaves and 40 substeps against the JAX
package, its test_final on the port); a ``<mimic>`` joint (the JOINT
equality row, against the JAX package); and where the port differs on
purpose: planar joints, self-collision filtering, a mimic declared
before its source, collision meshes (raise: mesh files are ROADMAP A
item 14).

Tolerances: leaves 1e-6; joint_q and body_q atol 2e-4, joint_qd 5e-3
(tests/test_batched_step.py:69-75).
"""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the URDF robots of phase 31)
from test_importers import URDF  # noqa: E402

torch.set_num_threads(1)

DT = 1.0 / 480.0
LEAVES = ("body_q", "body_com", "body_mass", "body_inertia", "joint_X_p",
          "joint_X_c", "joint_axis", "joint_target_kd", "joint_limit_lower",
          "joint_limit_upper", "joint_effort_limit", "joint_velocity_limit",
          "joint_q0", "shape_transform", "shape_scale", "shape_type",
          "shape_body", "eq_obj1", "eq_obj2", "eq_polycoef")


def test_urdf_import():
    """tests/test_importers.py:65 on the port."""
    b = nt.ModelBuilder()
    info = b.add_urdf(URDF, floating=False)
    m = b.finalize("cpu")
    assert m.body_count == 2
    assert m.structure.joint_count == 2
    assert "shoulder" in info["joints"]
    assert float(m.joint_target_kd[-1]) == pytest.approx(0.1)
    np.testing.assert_allclose(m.joint_limit_lower[-1].item(), -1.57,
                               atol=1e-6)
    np.testing.assert_allclose(m.body_mass.numpy(), [1.0, 0.5], atol=1e-6)


def test_urdf_floating_and_fk():
    """tests/test_importers.py:81 on the port."""
    b = nt.ModelBuilder()
    b.add_urdf(URDF, floating=True)
    m = b.finalize("cpu")
    assert m.joint_dof_count == 6 + 1
    s = nt.eval_fk(m, m.joint_q0, m.joint_qd0, m.state())
    assert torch.isfinite(s.body_q).all()


def test_collapse_fixed_joints():
    """tests/test_importers.py:92 on the port."""
    b = nt.ModelBuilder()
    root = b.add_body()
    b.add_shape_box(root, hx=0.2, hy=0.2, hz=0.2)
    b.add_joint_free(root)
    child = b.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1])
    b.add_shape_sphere(child, radius=0.1)
    b.add_joint_fixed(root, child, xform_p=[0.5, 0, 0, 0, 0, 0, 1])
    total = sum(b.body_mass)
    b.collapse_fixed_joints()
    assert b.body_count == 1
    assert b.joint_count == 1
    assert sum(b.body_mass) == pytest.approx(total)
    m = b.finalize("cpu")
    assert np.asarray(m.structure.shape_body).tolist() == [0, 0]


@pytest.mark.parametrize("floating", [False, True])
def test_collapse_matches_jax(floating):
    """The two-link robot with a fixed tool link, collapsed in both
    packages: masses, COMs and inertias (1e-6)."""
    import newton_tpu as jt
    urdf = URDF.replace("</robot>", """
  <link name="tool"><inertial><mass value="0.2"/><origin xyz="0.1 0 0"/>
    <inertia ixx="0.001" iyy="0.002" izz="0.003" ixy="0" ixz="0" iyz="0"/>
  </inertial></link>
  <joint name="mount" type="fixed"><parent link="arm"/><child link="tool"/>
    <origin xyz="0.5 0 0" rpy="0 0.3 0"/></joint>
</robot>""")
    ms = []
    for lib, dev in ((jt, None), (nt, "cpu")):
        b = lib.ModelBuilder()
        b.add_urdf(urdf, floating=floating)
        b.collapse_fixed_joints()
        ms.append(b.finalize() if dev is None else b.finalize(dev))
    jm, pm = ms
    assert pm.body_count == jm.body_count
    for n in ("body_mass", "body_com", "body_inertia", "shape_transform",
              "joint_X_p"):
        np.testing.assert_allclose(getattr(pm, n).numpy(),
                                   np.asarray(getattr(jm, n)), atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("mimic", [False, True])
def test_double_pendulum_matches_jax(mimic):
    """example_basic_urdf.py's double pendulum (and its mimic variant)
    x 2 worlds, self-collisions on in both packages (the JAX importer
    reads no enable_self_collisions): leaves, then 40 substeps from the
    shoulder at pi / 2."""
    import jax
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sim.articulation import eval_fk
    src = cs.DOUBLE_PENDULUM_URDF.replace("{mimic}",
                                          cs.MIMIC_TAG if mimic else "")
    models = []
    for lib, dev in ((jt, None), (nt, "cpu")):
        w = lib.ModelBuilder()
        kw = {} if lib is jt else dict(enable_self_collisions=True)
        w.add_urdf(src, **kw)
        b = lib.ModelBuilder()
        b.replicate(w, 2)
        models.append(b.finalize() if dev is None else b.finalize(dev))
    jm, pm = models
    for n in LEAVES:
        np.testing.assert_allclose(getattr(pm, n).numpy(),
                                   np.asarray(getattr(jm, n)), atol=1e-6,
                                   err_msg=n)
    q0 = np.asarray(pm.joint_q0).copy().reshape(2, 2)
    q0[:, 0] = np.pi / 2
    if mimic:
        q0[:, 1] = -np.pi / 2
    q0 = q0.reshape(-1)
    js = jt.solvers.SolverFeatherstone(jm)
    ps = nt.SolverFeatherstone(pm)
    a = eval_fk(jm, jnp.asarray(q0), jm.joint_qd0, jm.state())
    b = nt.eval_fk(pm, torch.as_tensor(q0), pm.joint_qd0, pm.state())
    jc, pc = jm.control(), pm.control()

    @jax.jit
    def run(s):
        def sub(s, _):
            return js.step(s, None, jc, None, DT), None
        return jax.lax.scan(sub, s, None, length=40)[0]
    a = run(a)
    for _ in range(40):
        b = ps.step(b, None, pc, None, DT)
    for name, tol in (("joint_q", 2e-4), ("body_q", 2e-4),
                      ("joint_qd", 5e-3)):
        np.testing.assert_allclose(getattr(b, name).numpy(),
                                   np.asarray(getattr(a, name)), atol=tol,
                                   rtol=tol, err_msg=name)


def test_basic_urdf_example_gates():
    """example_basic_urdf.py's test_final on the port (its 15 frames of
    8 substeps at dt 1/480)."""
    m = cs.urdf_scene(nt, 1).finalize("cpu")
    q0 = m.joint_q0.clone()
    q0[0] = np.pi / 2
    s = nt.eval_fk(m, q0, m.joint_qd0, m.state())
    solver = nt.SolverFeatherstone(m)
    ctl = m.control()
    for _ in range(15 * 8):
        s = solver.step(s, None, ctl, None, DT)
    q, jq = s.body_q.numpy(), s.joint_q.numpy()
    assert np.isfinite(q).all() and np.isfinite(jq).all()
    assert abs(jq[0] - np.pi / 2) > 0.01
    assert q[:, 2].max() < 1.3


def test_mimic_holds_in_the_port():
    m = cs.urdf_scene(nt, 1, mimic=True).finalize("cpu")
    assert m.structure.eq_count == 1
    q0 = m.joint_q0.clone()
    q0[0], q0[1] = np.pi / 2, -np.pi / 2
    s = nt.eval_fk(m, q0, m.joint_qd0, m.state())
    solver = nt.SolverFeatherstone(m)
    for _ in range(15 * 8):
        s = solver.step(s, None, m.control(), None, DT)
    assert abs(float(s.joint_q[1] + s.joint_q[0])) < 2e-2


PLANAR = """<robot name="slider">
  <link name="base"/>
  <link name="puck"><inertial><mass value="1"/>
    <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
  </inertial></link>
  <joint name="plane" type="planar"><parent link="base"/>
    <child link="puck"/><axis xyz="0 0 1"/>
    <dynamics damping="0.5"/></joint>
</robot>"""


def test_planar_joint_is_a_d6_joint():
    """A planar joint: two linear axes spanning the plane normal to its
    axis and one angular axis about it (the JAX importer makes it fixed);
    under gravity along -z the puck stays in its plane while it slides
    and spins."""
    b = nt.ModelBuilder()
    b.add_urdf(PLANAR)
    m = b.finalize("cpu")
    assert m.structure.joint_dof_dim.tolist()[-1] == [2, 1]
    ax = m.joint_axis.numpy()
    np.testing.assert_allclose(ax, [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
                               atol=1e-12)
    np.testing.assert_allclose(m.joint_target_kd.numpy(), 0.5)
    qd = torch.tensor([0.3, -0.2, 1.0])
    s = nt.eval_fk(m, m.joint_q0, qd, m.state())
    solver = nt.SolverFeatherstone(m)
    for _ in range(50):
        s = solver.step(s, None, m.control(), None, DT)
    assert abs(float(s.body_q[1, 2])) < 1e-6
    assert float(s.joint_q[0]) > 0.01 and float(s.joint_q[2]) > 0.01


def test_self_collisions_filtered_unless_enabled():
    """enable_self_collisions=False (the default) filters every pair of
    the robot's links (base-lower too); True keeps only the joints'
    parent-child filters (the JAX importer reads neither flag)."""
    def filtered(**kw):
        w = nt.ModelBuilder()
        w.add_urdf(cs.DOUBLE_PENDULUM_URDF.replace("{mimic}", ""), **kw)
        return w._body_filter_pairs
    assert filtered() == {(0, 1), (0, 2), (1, 2)}
    assert filtered(enable_self_collisions=True) == {(0, 1), (1, 2)}


def test_mimic_before_its_source_and_meshes():
    """A mimic tag may name a joint declared after it; a collision mesh
    file that cannot be read raises naming the file, a visual mesh is
    skipped."""
    src = cs.DOUBLE_PENDULUM_URDF.replace("{mimic}", "")
    src = src.replace('<joint name="shoulder" type="revolute">',
                      '<joint name="shoulder" type="revolute">'
                      '<mimic joint="elbow" multiplier="2"/>')
    b = nt.ModelBuilder()
    info = b.add_urdf(src)
    assert b.eq_obj1 == [info["joints"]["shoulder"]]
    assert b.eq_obj2 == [info["joints"]["elbow"]]
    mesh = src.replace('<geometry><cylinder radius="0.03" length="0.5"/>'
                       '</geometry>', '<geometry><mesh filename="a.stl"/>'
                       '</geometry>', 1)
    with pytest.raises(ValueError, match="a.stl"):
        nt.ModelBuilder().add_urdf(mesh)
    visual = src.replace("<collision>", "<visual>", 1).replace(
        "</collision>", "</visual>", 1)
    visual = visual.replace('<geometry><cylinder radius="0.03" length="0.5"'
                            '/></geometry>', '<geometry><mesh filename='
                            '"a.stl"/></geometry>', 1)
    b = nt.ModelBuilder()
    b.add_urdf(visual)
    assert b.shape_count == 1
