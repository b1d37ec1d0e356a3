"""Mesh-file geoms in the port's MJCF and URDF importers against the JAX
package's: binary STL and OBJ files written here, read through
``<asset><mesh>`` (meshdir, the mesh's scale and the importer's), a mesh
geom with ``mass``, a URDF collision mesh with ``package://`` and
``scale``. Vertices and indices bit for bit; body mass and inertia to
1e-6 relative where the scales keep volumes (the JAX importer takes a
scaled mesh's mass properties from its unscaled vertices, the port from
its vertices: ROADMAP C.42, pinned at scale 2). A file that cannot be
read raises in the port and is dropped by the JAX importer; the JAX
importer ignores a ``<default>`` mesh scale, which the port applies
(ROADMAP C.39). The gymnasium-robotics
Franka arm, Adroit pen and kitchen, where installed: counts against the
JAX importer's and ``test_importers.py``'s."""

import os
import struct

import numpy as np
import pytest

import newton_tpu_torch as nt

ASSETS = ("/opt/venv/lib/python3.12/site-packages/gymnasium_robotics/envs/"
          "assets")
FRANKA_DIR = ASSETS + "/kitchen_franka/franka_assets"


def _write_stl(path, tris):
    with open(path, "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", len(tris)))
        for t in tris:
            f.write(struct.pack("<3f", 0, 0, 0))
            f.write(np.asarray(t, np.float32).tobytes() + b"\0\0")


def _box_tris(h=(0.1, 0.2, 0.3), c=(0.0, 0.0, 0.0)):
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                  for z in (-1, 1)], np.float64) * h + c
    f = [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]]
    return v[np.array(f)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A mesh directory with a binary STL box, an OBJ wedge (a quad face:
    a fan of two triangles), an ASCII STL and a truncated binary STL."""
    d = tmp_path_factory.mktemp("meshes")
    _write_stl(d / "box.stl", _box_tris())
    _write_stl(d / "off.stl", _box_tris((0.05, 0.05, 0.05), (0.1, 0, 0.2)))
    (d / "wedge.obj").write_text(
        "# wedge\nv 0 0 0\nv 0.4 0 0\nv 0 0.3 0\nv 0 0 0.2\nv 0.4 0 0.2\n"
        "v 0 0.3 0.2\nf 1 3 2\nf 4 5 6\nf 1 2 5 4\nf 1 4 6 3\n"
        "f 2/1 3/1 6/1 5/1\n")
    (d / "ascii.stl").write_text("solid x\nfacet normal 0 0 1\nendsolid x\n")
    with open(d / "short.stl", "wb") as f:
        f.write(b"\0" * 80 + struct.pack("<I", 12) + b"\0" * 100)
    return d


def _mjcf(mesh_dir, body_geoms, defaults="", assets="", box="1 2 0.5"):
    return f"""<mujoco model="m">
  <compiler angle="radian" meshdir="{mesh_dir}"/>
  <default>{defaults}</default>
  <asset>
    <mesh name="box" file="box.stl" scale="{box}"/>
    <mesh file="wedge.obj"/>
    <mesh name="off" file="off.stl"/>
    {assets}
  </asset>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body name="a" pos="0 0 1">
      <freejoint/>
      {body_geoms}
    </body>
  </worldbody>
</mujoco>"""


GEOMS = """<geom name="g0" type="mesh" mesh="box" density="300"/>
      <geom name="g1" type="mesh" mesh="wedge" pos="0.2 0 0" mass="2.5"/>
      <geom name="g2" type="mesh" mesh="off" euler="0.3 0 0.2"/>
      <geom type="sphere" size="0.05" pos="0 0 -0.3"/>"""


def _import(lib, src, path, **kw):
    with open(path, "w") as f:
        f.write(src)
    b = lib.ModelBuilder()
    b.add_mjcf(str(path), **kw)
    return b


def _meshes_equal(tb, jb):
    assert tb.shape_count == jb.shape_count
    n = 0
    for ts, js in zip(tb.shape_source, jb.shape_source):
        assert (ts is None) == (js is None)
        if ts is not None:
            np.testing.assert_array_equal(ts.vertices, js.vertices)
            np.testing.assert_array_equal(ts.indices, js.indices)
            n += 1
    return n


@pytest.mark.parametrize("scale,box", [(1.0, "1 1 1"), (1.0, "1 2 0.5"),
                                       (2.0, "1 1 1")])
def test_mjcf_mesh_geoms_match_jax(files, tmp_path, scale, box):
    import newton_tpu as jt
    src = _mjcf(str(files), GEOMS, box=box)
    tb = _import(nt, src, tmp_path / "m.xml", scale=scale)
    jb = _import(jt, src, tmp_path / "m.xml", scale=scale)
    assert _meshes_equal(tb, jb) == 3
    # the OBJ's quads became fans: 2 triangles + 2 quads x 2 + one more
    wedge = tb.shape_source[2]
    assert len(wedge.indices) == 3 * 8 and len(wedge.vertices) == 6
    tm, jm = tb.finalize("cpu"), jb.finalize()
    unscaled = scale == 1.0 and box == "1 1 1"
    for f in ("body_mass", "body_com", "body_inertia", "shape_scale",
              "shape_transform"):
        if f.startswith("body_") and not unscaled:
            continue
        np.testing.assert_allclose(getattr(tm, f).numpy(),
                                   np.asarray(getattr(jm, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    # the body's mass: the box at density 300, the wedge's mass attribute,
    # the offset box and the sphere at the default density 1000
    from newton_tpu_torch.geometry.inertia import compute_mesh_inertia
    mbox, _, off = tb.shape_source[1:4]

    def vol(s):
        return compute_mesh_inertia(1.0, s.vertices, s.indices)[0]
    expect = (300 * vol(mbox) + 2.5 + 1000 * vol(off)
              + 1000 * 4 / 3 * np.pi * (0.05 * scale) ** 3)
    np.testing.assert_allclose(float(tm.body_mass[0]), expect, rtol=1e-6)
    if not unscaled:
        # C.42: the JAX body takes the meshes' unscaled mass properties
        assert not np.allclose(tm.body_inertia.numpy(),
                               np.asarray(jm.body_inertia), rtol=1e-3)


def test_default_mesh_scale_and_unreadable_files(files, tmp_path):
    """A ``<default><mesh scale>`` scales the port's mesh (as MuJoCo's
    compiler does) and not the JAX importer's (C.39); an ASCII STL, a
    truncated STL, a missing file and an unknown mesh name raise in the
    port, and the JAX importer drops the geom."""
    import newton_tpu as jt
    src = _mjcf(str(files), GEOMS, defaults='<mesh scale="2 2 2"/>')
    tb = _import(nt, src, tmp_path / "d.xml")
    jb = _import(jt, src, tmp_path / "d.xml")
    box_t, box_j = tb.shape_source[1], jb.shape_source[1]
    np.testing.assert_array_equal(box_t.vertices, box_j.vertices)  # own
    wedge_t, wedge_j = tb.shape_source[2], jb.shape_source[2]
    np.testing.assert_array_equal(wedge_t.vertices, 2 * wedge_j.vertices)
    for bad in ("ascii.stl", "short.stl", "missing.stl"):
        src = _mjcf(str(files), GEOMS + '<geom type="mesh" mesh="bad"/>',
                    assets=f'<mesh name="bad" file="{bad}"/>')
        jb = _import(jt, src, tmp_path / "b.xml")
        assert jb.shape_count == 5                     # the geom dropped
        with pytest.raises((ValueError, FileNotFoundError), match=bad):
            _import(nt, src, tmp_path / "b.xml")
    src = _mjcf(str(files), GEOMS + '<geom type="mesh" mesh="nope"/>')
    with pytest.raises(ValueError, match="nope"):
        _import(nt, src, tmp_path / "n.xml")


URDF = """<robot name="r">
  <link name="base">
    <inertial><mass value="1.0"/><origin xyz="0 0 0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><origin xyz="0 0 0.1"/>
      <geometry><mesh filename="package://meshes/box.stl" scale="2 0.5 1"/>
      </geometry></collision>
    <visual><geometry><mesh filename="package://meshes/none.stl"/>
      </geometry></visual>
  </link>
  <link name="arm">
    <inertial><mass value="0.5"/><origin xyz="0 0 0"/>
      <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/>
    </inertial>
    <collision><geometry><mesh filename="meshes/{arm}"/></geometry>
    </collision>
  </link>
  <joint name="j" type="revolute"><parent link="base"/><child link="arm"/>
    <origin xyz="0 0 0.5"/><axis xyz="0 1 0"/>
    <limit lower="-1" upper="1" effort="10" velocity="1"/></joint>
</robot>"""


def test_urdf_collision_meshes_match_jax(files, tmp_path):
    import shutil
    import newton_tpu as jt
    root = tmp_path / "pkg"
    shutil.copytree(files, root / "meshes")
    path = root / "r.urdf"
    path.write_text(URDF.format(arm="wedge.obj"))
    for scale in (1.0, 1.5):
        tb, jb = nt.ModelBuilder(), jt.ModelBuilder()
        tb.add_urdf(str(path), scale=scale)
        jb.add_urdf(str(path), scale=scale)
        assert _meshes_equal(tb, jb) == 2
        if scale != 1.0:
            continue                       # C.42: other mass properties
        tm, jm = tb.finalize("cpu"), jb.finalize()
        for f in ("body_mass", "body_inertia", "shape_transform"):
            np.testing.assert_allclose(getattr(tm, f).numpy(),
                                       np.asarray(getattr(jm, f)),
                                       rtol=1e-6, atol=1e-7, err_msg=f)
    path.write_text(URDF.format(arm="ascii.stl"))
    jb = jt.ModelBuilder()
    jb.add_urdf(str(path))
    assert jb.shape_count == 1                         # JAX drops it
    with pytest.raises(ValueError, match="ascii.stl"):
        nt.ModelBuilder().add_urdf(str(path))


FRANKA_XML = f"""
<mujoco model="panda">
  <compiler angle="radian" meshdir="{FRANKA_DIR}/meshes"
            inertiafromgeom="auto"/>
  <include file="{FRANKA_DIR}/assets.xml"/>
  <worldbody>
    <include file="{FRANKA_DIR}/chain.xml"/>
  </worldbody>
  <include file="{FRANKA_DIR}/actuator.xml"/>
</mujoco>
"""


@pytest.mark.skipif(not os.path.isdir(FRANKA_DIR),
                    reason="gymnasium-robotics' Franka assets are not "
                           "installed")
def test_franka_adroit_kitchen_counts():
    """The Franka arm (example_ik_franka.py's wrapper: includes, classes,
    20 STL meshes) against the JAX importer, builder counts and meshes;
    the Adroit pen finalized to test_importers.py's counts; the kitchen's
    bodies and dofs (its 41 mesh geoms resolve under the last compiler's
    meshdir, which the JAX importer does not read: it drops them)."""
    import newton_tpu as jt
    tb, jb = nt.ModelBuilder(gravity=0.0), jt.ModelBuilder(gravity=0.0)
    tb.add_mjcf(FRANKA_XML)
    jb.add_mjcf(FRANKA_XML)
    assert (tb.body_count, tb.joint_dof_count, tb.joint_coord_count) == (
        jb.body_count, jb.joint_dof_count, jb.joint_coord_count) == (
        10, 9, 9)
    assert _meshes_equal(tb, jb) == 20
    b = nt.ModelBuilder()
    with pytest.warns(UserWarning, match="fixed tendons"):
        b.add_mjcf(ASSETS + "/adroit_hand/adroit_pen.xml")
    m = b.finalize("cpu")
    assert m.structure.body_count == 29 and m.joint_dof_count == 30
    assert m.structure.shape_count > 60
    b = nt.ModelBuilder()
    b.add_mjcf(ASSETS + "/kitchen_franka/kitchen_assets/"
               "kitchen_env_model.xml")
    assert (b.body_count, b.joint_dof_count) == (43, 29)
    assert b.shape_count > 150
    assert sum(isinstance(s, nt.Mesh) for s in b.shape_source) == 41
