"""The port's USD layer against the JAX package on the CPU: ``parse_usda``
(prim trees), the crate codec (``usd/usdc.py``: the integer and LZ4 codecs,
``write_usdc`` byte for byte, each package reading the other's file) and
``ModelBuilder.add_usd`` from ``.usda`` and ``.usdc`` (every model array
through ``utils/bridge.py``: integers exact, floats 1e-6) on
tests/test_usdc.py's physics stage, tests/test_importers.py's cloth
surface and cable stages, tests/test_usdc.py's tet volume and
``assets/ant.usda``; the USD ant against the MJCF ant; the USD ant x 4
stepped 2 frames in both packages (joint_q/body_q 2e-4, joint_qd 5e-3,
tests/test_batched_step.py:69-75); the free root's joint last in the joint
order (FK, a flat step of two worlds, a masked reset and
ArticulationView, against the JAX package); and the reference defects
C.48 (``mjc:damping``/``mjc:stiffness`` dropped) and C.49
(ArticulationView's root is an articulation's first joint).
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import newton_tpu as jt
from newton_tpu.parallel import batch_state as j_batch_state
from newton_tpu.sim.articulation import eval_fk as j_eval_fk
from newton_tpu.sim.collide import CollisionPipeline as JPipe
from newton_tpu.solvers import SolverMuJoCo as JSolver
from newton_tpu.usd import usdc as j_usdc
from newton_tpu.utils import selection as j_selection
from newton_tpu.utils.usda_parser import parse_usda as j_parse_usda

import newton_tpu_torch as nt
from newton_tpu_torch.sim.model import (MODEL_BOOL_FIELDS, MODEL_FLOAT_FIELDS,
                                        MODEL_INT_FIELDS)
from newton_tpu_torch.usd import usdc as t_usdc
from newton_tpu_torch.utils import ArticulationView, bridge
from newton_tpu_torch.utils.import_usd import SchemaResolverManager
from newton_tpu_torch.utils.usda_parser import parse_usda as t_parse_usda

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (phase 59's scene and forces)
from test_usdc import USDA_SCENE  # noqa: E402

torch.set_num_threads(1)

W = 4
DT = 1.0 / 240.0
Q_TOL, QD_TOL = 2e-4, 5e-3
ANT_USDA = os.path.join(nt.ASSET_DIR, "ant.usda")
ANT_XML = os.path.join(nt.ASSET_DIR, "ant.xml")

# tests/test_importers.py:214-226 (the cloth surface) and :254-293 (the
# cables and attachments); tests/test_usdc.py:102-108 (the tet volume)
CLOTH = '''#usda 1.0
def Xform "World"
{
    def Mesh "flag" (
        prepend apiSchemas = ["PhysxDeformableSurfaceAPI"]
    )
    {
        point3f[] points = [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
        int[] faceVertexIndices = [0, 1, 2, 3]
        int[] faceVertexCounts = [4]
        float physxDeformable:density = 0.5
    }
}
'''
CABLE = '''#usda 1.0
def Xform "World"
{
    def Cube "anchor" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI", "PhysicsCollisionAPI"]
    )
    {
        double size = 0.2
        float physics:mass = 5.0
    }
    def BasisCurves "cable_a" (
        prepend apiSchemas = ["PhysxDeformableBodyAPI"]
    )
    {
        point3f[] points = [(0, 0, 1), (0.2, 0, 1), (0.4, 0, 1)]
        int[] curveVertexCounts = [3]
        float[] widths = [0.04]
    }
    def BasisCurves "cable_b" (
        prepend apiSchemas = ["PhysxDeformableBodyAPI"]
    )
    {
        point3f[] points = [(0.4, 0, 1), (0.6, 0, 1), (0.8, 0, 1)]
        int[] curveVertexCounts = [3]
        float[] widths = [0.04]
    }
    def PhysicsAttachment "weld"
    {
        rel physics:src0 = </World/cable_a>
        rel physics:src1 = </World/cable_b>
        int[] physics:indices0 = [2]
        int[] physics:indices1 = [0]
    }
    def PhysicsAttachment "pin"
    {
        rel physics:src0 = </World/cable_a>
        rel physics:src1 = </World/anchor>
        int[] physics:indices0 = [0]
    }
}
'''
TET = """#usda 1.0
def TetMesh "Blob" {
    point3f[] points = [(0,0,0), (1,0,0), (0,1,0), (0,0,1), (1,1,1)]
    int[] tetVertexIndices = [0, 1, 2, 3, 4, 2, 1, 3]
    float physxDeformable:youngsModulus = 50000
}
"""
# every collider class under rigid bodies (a scaled cube, a cylinder
# under an offset Xform, a mesh; the plane outside every body is not
# imported), mass, inertia and COM overrides, scene gravity
COLLIDERS = """#usda 1.0
def PhysicsScene "scene" {
    vector3f gravity = (0, 0, -9.0)
}
def Xform "World" {
    def Plane "floor" (
        prepend apiSchemas = ["PhysicsCollisionAPI"]
    ) {
    }
    def Xform "Box" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI", "PhysicsMassAPI"]
    ) {
        double3 xformOp:translate = (0, 0, 0.5)
        quatf xformOp:orient = (0.9238795, 0, 0, 0.3826834)
        float physics:mass = 3.0
        float3 physics:diagonalInertia = (0.5, 0.25, 0.125)
        point3f physics:centerOfMass = (0, 0, 0.125)
        def Cube "Col" (
            prepend apiSchemas = ["PhysicsCollisionAPI"]
        ) {
            double size = 0.5
            float3 xformOp:scale = (1, 2, 0.5)
        }
    }
    def Xform "Can" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI"]
    ) {
        double3 xformOp:translate = (1, 0, 0.5)
        def Xform "Offset" {
            double3 xformOp:translate = (0, 0.25, 0)
            def Cylinder "Col" (
                prepend apiSchemas = ["PhysicsCollisionAPI"]
            ) {
                double radius = 0.125
                double height = 0.5
                uniform token axis = "Y"
            }
        }
    }
    def Xform "Rock" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI"]
    ) {
        double3 xformOp:translate = (-1, 0, 0.5)
        def Mesh "Col" (
            prepend apiSchemas = ["PhysicsCollisionAPI"]
        ) {
            point3f[] points = [(0, 0, 0), (0.5, 0, 0), (0, 0.5, 0), (0, 0, 0.5)]
            int[] faceVertexIndices = [0, 2, 1, 0, 1, 3, 0, 3, 2, 1, 2, 3]
            int[] faceVertexCounts = [3, 3, 3, 3]
        }
    }
}
"""
# every joint kind: fixed to the world, prismatic with limits and Newton
# armature and friction, spherical, fixed with local rotations, a generic
# PhysicsJoint (a D6 joint without dofs) with PhysX armature
JOINTS = """#usda 1.0
def Xform "World" {
    def Xform "Base" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI"]
    ) {
        double3 xformOp:translate = (0, 0, 1)
        def Cube "Col" (
            prepend apiSchemas = ["PhysicsCollisionAPI"]
        ) {
            double size = 0.25
        }
    }
    def Xform "Slider" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI"]
    ) {
        double3 xformOp:translate = (0.5, 0, 1)
        def Sphere "Col" (
            prepend apiSchemas = ["PhysicsCollisionAPI"]
        ) {
            double radius = 0.125
        }
    }
    def Xform "Ball" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI"]
    ) {
        double3 xformOp:translate = (1, 0, 1)
        def Sphere "Col" (
            prepend apiSchemas = ["PhysicsCollisionAPI"]
        ) {
            double radius = 0.125
        }
    }
    def Xform "Weld" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI"]
    ) {
        double3 xformOp:translate = (1.5, 0, 1)
        def Sphere "Col" (
            prepend apiSchemas = ["PhysicsCollisionAPI"]
        ) {
            double radius = 0.125
        }
    }
    def Xform "Free6" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI"]
    ) {
        double3 xformOp:translate = (2, 0, 1)
        def Sphere "Col" (
            prepend apiSchemas = ["PhysicsCollisionAPI"]
        ) {
            double radius = 0.125
        }
    }
    def PhysicsFixedJoint "root" {
        rel physics:body1 = </World/Base>
        point3f physics:localPos0 = (0, 0, 1)
    }
    def PhysicsPrismaticJoint "slide" {
        rel physics:body0 = </World/Base>
        rel physics:body1 = </World/Slider>
        point3f physics:localPos0 = (0.5, 0, 0)
        token physics:axis = "Z"
        float physics:lowerLimit = -0.25
        float physics:upperLimit = 0.5
        float newton:armature = 0.5
        float newton:jointFriction = 0.25
    }
    def PhysicsSphericalJoint "shoulder" {
        rel physics:body0 = </World/Slider>
        rel physics:body1 = </World/Ball>
        point3f physics:localPos0 = (0.5, 0, 0)
    }
    def PhysicsFixedJoint "weld" {
        rel physics:body0 = </World/Ball>
        rel physics:body1 = </World/Weld>
        point3f physics:localPos0 = (0.25, 0, 0)
        point3f physics:localPos1 = (-0.25, 0, 0)
        quatf physics:localRot0 = (0.7071068, 0.7071068, 0, 0)
        quatf physics:localRot1 = (0.7071068, 0.7071068, 0, 0)
    }
    def PhysicsJoint "d6" {
        rel physics:body0 = </World/Weld>
        rel physics:body1 = </World/Free6>
        point3f physics:localPos0 = (0.5, 0, 0)
        float physxJoint:armature = 0.125
    }
}
"""
# C.48: a hinge whose MJC damping and stiffness the importer resolves
# and drops
HINGE = """#usda 1.0
def Xform "World" {
    def Xform "Torso" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI"]
    ) {
        double3 xformOp:translate = (0, 0, 0.75)
        def Sphere "Col" (
            prepend apiSchemas = ["PhysicsCollisionAPI"]
        ) {
            double radius = 0.25
        }
    }
    def Xform "Leg" (
        prepend apiSchemas = ["PhysicsRigidBodyAPI"]
    ) {
        double3 xformOp:translate = (0.5, 0, 0.75)
        def Capsule "Col" (
            prepend apiSchemas = ["PhysicsCollisionAPI"]
        ) {
            double radius = 0.05
            double height = 0.4
            uniform token axis = "X"
        }
    }
    def PhysicsRevoluteJoint "Hip" {
        rel physics:body0 = </World/Torso>
        rel physics:body1 = </World/Leg>
        point3f physics:localPos0 = (0.25, 0, 0)
        point3f physics:localPos1 = (-0.25, 0, 0)
        token physics:axis = "Y"
        float physics:lowerLimit = -45
        float physics:upperLimit = 45
        float mjc:armature = 1
        float mjc:damping = 1
        float mjc:stiffness = 5
    }
}
"""


def _ant_text():
    with open(ANT_USDA) as f:
        return f.read()


STAGES = {"physics": USDA_SCENE, "colliders": COLLIDERS, "joints": JOINTS,
          "cloth": CLOTH, "cable": CABLE, "tet": TET, "hinge": HINGE,
          "ant": None}
# stages whose .usdc the JAX importer cannot read (C.50)
C50 = ("colliders", "cable", "tet")


def stage_text(name):
    return _ant_text() if name == "ant" else STAGES[name]


_DECIMAL = re.compile(r"-?\d+\.\d*(?:[eE]-?\d+)?")


def f32_text(text):
    """``text`` with every decimal inside a vector or an array rounded to
    float32: the numbers a .usdc of it holds (the crate writes vectors
    and arrays as float32, scalars that float32 cannot hold as doubles)."""
    out = []
    for line in text.split("\n"):
        head, eq, value = line.partition("=")
        if eq and value.strip()[:1] in ("(", "["):
            value = _DECIMAL.sub(
                lambda m: repr(float(np.float32(float(m.group())))), value)
        out.append(head + eq + value)
    return "\n".join(out)


def same_value(x, y):
    """Equal values: numpy arrays of one dtype and equal elements, or
    equal Python values, element by element in lists, tuples and dicts."""
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return (type(x) is type(y) and x.dtype == y.dtype
                and np.array_equal(x, y))
    if isinstance(x, (list, tuple)):
        return (type(x) is type(y) and len(x) == len(y)
                and all(same_value(p, q) for p, q in zip(x, y)))
    if isinstance(x, dict):
        return (isinstance(y, dict) and x.keys() == y.keys()
                and all(same_value(x[k], y[k]) for k in x))
    return type(x) is type(y) and x == y


def assert_trees_equal(a, b):
    assert (a.name, a.type_name, a.path) == (b.name, b.type_name, b.path)
    assert same_value(a.attrs, b.attrs), a.path
    assert same_value(a.metadata, b.metadata), a.path
    assert a.api_schemas == b.api_schemas, a.path
    assert len(a.children) == len(b.children), a.path
    for x, y in zip(a.children, b.children):
        assert_trees_equal(x, y)


def jax_model_numpy(jm):
    leaves = {n: np.asarray(getattr(jm, n))
              for n in MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS
              + MODEL_BOOL_FIELDS}
    leaves["custom"] = {k: np.asarray(v) for k, v in jm.custom.items()}
    st = jm.structure
    structure = {n: getattr(st, n) for n in bridge.STRUCTURE_FIELDS}
    au = st.mjc_actuation
    structure["mjc_actuation"] = None if au is None else {
        n: getattr(au, n) for n in bridge.ACTUATION_FIELDS}
    structure["custom_specs"] = {
        k: dict(frequency=s.frequency.value, assignment=s.assignment.value,
                shape=s.shape, default=s.default)
        for k, s in st.custom_specs.items()}
    return leaves, structure


def assert_models_match(tm, jm):
    """Every model array of the port's model against the JAX model's
    carried through the bridge: integers and booleans exact, floats 1e-6;
    the structure's fields equal."""
    ref = bridge.model_from_numpy(*jax_model_numpy(jm), "cpu")
    for name in MODEL_FLOAT_FIELDS:
        a, b = getattr(tm, name), getattr(ref, name)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-6, err_msg=name)
    for name in MODEL_INT_FIELDS + MODEL_BOOL_FIELDS:
        assert torch.equal(getattr(tm, name), getattr(ref, name)), name
    for name in bridge.STRUCTURE_FIELDS:
        a, b = getattr(tm.structure, name), getattr(ref.structure, name)
        if isinstance(a, (np.ndarray, list, tuple)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize("name", list(STAGES))
def test_parse_usda_matches_jax(name):
    text = stage_text(name)
    assert_trees_equal(t_parse_usda(text), j_parse_usda(text))


def test_int_codec_roundtrip_and_bytes():
    """tests/test_usdc.py:41 on the port, and the same bytes as the JAX
    package's encoder."""
    for vals in ([0, 1, 2, 5, -1, 100000, 3], [], [0xFFFFFFFF - 1, 7],
                 list(range(300)), list(np.arange(0, 5000, 7) * -3)):
        enc = t_usdc._encode_ints(vals)
        assert enc == j_usdc._encode_ints(vals)
        got = list(t_usdc._decode_ints(enc, len(vals)))
        assert got == [t_usdc._wrap32(int(v)) for v in vals]


def test_lz4_roundtrip_and_bytes():
    """tests/test_usdc.py:48 on the port, on a repeating, a random and an
    empty buffer, and the same bytes as the JAX package's compressor."""
    rng = np.random.RandomState(0)
    for data in (bytes(range(256)) * 20, rng.bytes(3000), b"",
                 _ant_text().encode()):
        enc = t_usdc._lz4_compress(data)
        assert enc == j_usdc._lz4_compress(data)
        assert t_usdc._lz4_decompress(enc, len(data) + 16) == data
        assert t_usdc._fast_decompress(t_usdc._fast_compress(data),
                                       len(data)) == data


@pytest.mark.parametrize("name", list(STAGES))
def test_write_usdc_matches_jax(name, tmp_path):
    """The same tree gives the same bytes in both packages, twice; each
    package reads the other's file into an equal tree."""
    text = stage_text(name)
    tp, jp = str(tmp_path / "t.usdc"), str(tmp_path / "j.usdc")
    t_usdc.write_usdc(t_parse_usda(text), tp)
    j_usdc.write_usdc(j_parse_usda(text), jp)
    with open(tp, "rb") as f:
        tb = f.read()
    with open(jp, "rb") as f:
        assert tb == f.read()
    t_usdc.write_usdc(t_parse_usda(text), tp)
    with open(tp, "rb") as f:
        assert f.read() == tb
    assert t_usdc.is_usdc(tp)
    assert_trees_equal(t_usdc.read_usdc(jp), j_usdc.read_usdc(jp))
    assert_trees_equal(j_usdc.read_usdc(tp), t_usdc.read_usdc(tp))


@pytest.mark.parametrize("fmt", ["usda", "usdc"])
@pytest.mark.parametrize("name", list(STAGES))
def test_add_usd_matches_jax(name, fmt, tmp_path):
    """add_usd from the text and from a .usdc of it builds the JAX
    package's model from the same file (from the text where the JAX
    importer cannot read the .usdc, C.50), and the same name -> index
    maps."""
    text = stage_text(name)
    src = text
    if fmt == "usdc":
        src = str(tmp_path / "stage.usdc")
        t_usdc.write_usdc(t_parse_usda(text), src)
    tb, jb = nt.ModelBuilder(), jt.ModelBuilder()
    t_info = tb.add_usd(src)
    j_info = jb.add_usd(f32_text(text) if fmt == "usdc" and name in C50
                        else src)
    assert t_info == j_info
    assert_models_match(tb.finalize("cpu"), jb.finalize())


@pytest.mark.parametrize("name", C50)
def test_reference_defect_c50_usdc_arrays(name, tmp_path):
    """C.50: the JAX importer tests stage values for truth
    (newton_tpu/utils/import_usd.py:201, :383-385, :436, :454, :471-472,
    :536), and the crate reader returns arrays as numpy arrays, so a mesh
    collider, a TetMesh or a cable read from a .usdc raises ValueError
    there. The port imports each as it imports the text of the same
    numbers (``f32_text``), bit for bit."""
    text = stage_text(name)
    src = str(tmp_path / "stage.usdc")
    t_usdc.write_usdc(t_parse_usda(text), src)
    with pytest.raises(ValueError, match="truth value of an array"):
        jt.ModelBuilder().add_usd(src)
    a, b = nt.ModelBuilder(), nt.ModelBuilder()
    assert a.add_usd(src) == b.add_usd(f32_text(text))
    assert cs.model_diff(a.finalize("cpu"), b.finalize("cpu")) == []


def test_usdc_ant_equals_usda_ant(tmp_path):
    """The USD ant through a .usdc round trip: every model tensor equal
    to the .usda import's bit for bit (phase 59's import gate)."""
    src = str(tmp_path / "ant.usdc")
    t_usdc.write_usdc(t_parse_usda(_ant_text()), src)
    a = cs.usd_ant_scene(nt, ANT_USDA).finalize("cpu")
    b = cs.usd_ant_scene(nt, src).finalize("cpu")
    assert cs.model_diff(a, b) == []


def test_ant_usda_is_up_to_date():
    """assets/ant.usda is what tools/ant_usda.py writes from ant.xml."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import ant_usda
    assert ant_usda.ant_usda(ANT_XML) == _ant_text()


def _world_axes(b, joints):
    from newton_tpu_torch.core.host_math import np_quat_rotate
    return np.stack([np_quat_rotate(b.joint_X_p[j][3:7],
                                    b.joint_axis[b.joint_qd_start[j]])
                     for j in joints])


def test_usd_ant_against_mjcf_ant():
    """13 bodies, 13 joints, 14 dofs, 15 coordinates; the hinges' world
    axes, limits and armature are the MJCF ant's; masses and inertias are
    the MJCF ant's times 1000 / 5 (the USD ant keeps the importer's
    default density, the MJCF ant declares 5); the shapes sit where the
    MJCF ant's do (its floor aside)."""
    u, m = nt.ModelBuilder(), nt.ModelBuilder()
    u.add_usd(ANT_USDA)
    m.add_mjcf(ANT_XML)
    assert (u.body_count, u.joint_count, u.joint_dof_count,
            u.joint_coord_count) == (13, 13, 14, 15)
    assert (m.body_count, m.joint_count, m.joint_dof_count) == (13, 13, 14)
    assert [k.split(".")[-1] for k in u.body_key] == m.body_key
    np.testing.assert_allclose(np.asarray(u.body_mass),
                               200.0 * np.asarray(m.body_mass), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(u.body_inertia),
                               200.0 * np.asarray(m.body_inertia),
                               rtol=1e-6, atol=1e-6)
    rev = int(nt.JointType.REVOLUTE)
    uj = [j for j in range(u.joint_count) if u.joint_type[j] == rev]
    mj = [j for j in range(m.joint_count) if m.joint_type[j] == rev]
    assert [u.joint_key[j].split(".")[-1] for j in uj] \
        == [m.joint_key[j] for j in mj]
    np.testing.assert_allclose(_world_axes(u, uj), _world_axes(m, mj),
                               atol=1e-6)
    ud = [u.joint_qd_start[j] for j in uj]
    md = [m.joint_qd_start[j] for j in mj]
    for name in ("joint_limit_lower", "joint_limit_upper",
                 "joint_armature"):
        np.testing.assert_allclose(np.asarray(getattr(u, name))[ud],
                                   np.asarray(getattr(m, name))[md],
                                   atol=1e-6, err_msg=name)
    keep = [s for s in range(m.shape_count) if m.shape_body[s] >= 0]
    np.testing.assert_allclose(np.asarray(u.shape_transform),
                               np.asarray(m.shape_transform)[keep],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(u.shape_scale),
                               np.asarray(m.shape_scale)[keep], atol=1e-6)


def test_reference_defect_c48_damping_and_stiffness_dropped():
    """C.48: the Mjc resolver maps mjc:damping and mjc:stiffness
    (import_usd.py:77-78) but only armature and friction reach the joint
    (:336-343). Both packages import the hinge with armature 1 and zero
    drive gains."""
    hip = next(p for p in t_parse_usda(HINGE).walk() if p.name == "Hip")
    rm = SchemaResolverManager()
    assert (rm.resolve(hip, "damping"), rm.resolve(hip, "stiffness")) \
        == (1, 5)
    tb, jb = nt.ModelBuilder(), jt.ModelBuilder()
    tb.add_usd(HINGE)
    jb.add_usd(HINGE)
    for b in (tb, jb):
        d = b.joint_qd_start[0]
        assert b.joint_type[0] == int(nt.JointType.REVOLUTE)
        assert b.joint_armature[d] == 1.0
        assert b.joint_target_kd[d] == 0.0 and b.joint_target_ke[d] == 0.0


# -- the USD ant stepped in both packages ---------------------------------

@pytest.fixture(scope="module")
def ant():
    jm = cs.usd_ant_scene(jt, ANT_USDA).finalize()
    tm = cs.usd_ant_scene(nt, ANT_USDA).finalize("cpu")
    js = JSolver(jm, iterations=8, integrator="euler")
    jpipe = JPipe(jm)

    class NS:
        pass
    ns = NS()
    ns.jm, ns.tm = jm, tm
    ns.j_step = jax.jit(lambda s, c, k: js.step_batched(s, None, c, k, DT))
    ns.j_collide = jax.jit(jax.vmap(jpipe.collide))
    ns.ts = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    ns.tpipe = nt.CollisionPipeline(tm)
    return ns


def _close(got, ref, names=("joint_q", "joint_qd", "body_q")):
    for name in names:
        tol = QD_TOL if name == "joint_qd" else Q_TOL
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=tol, rtol=tol, err_msg=name)


def test_usd_ant_steps_match_jax(ant):
    """Phase 59's loop at W = 4 for 2 frames: joint_f = 150 u on the
    hinges from torch.Generator seed 0, static collide + step_batched, in
    both packages from the same model; the hinge dofs sit first, the
    free root's last."""
    jf = cs.usd_hinge_forces(ant.tm, W, 2, torch.device("cpu"))
    assert bool((jf[:, :, 8:] == 0).all()) and bool((jf[:, :, :8] != 0)
                                                   .all())
    ctls = cs.usd_controls(ant.tm, jf)
    j0 = ant.jm.control()
    ts = nt.batch_state(nt.eval_fk(ant.tm, ant.tm.joint_q0,
                                   ant.tm.joint_qd0, ant.tm.state()), W)
    js = j_batch_state(j_eval_fk(ant.jm, ant.jm.joint_q0, ant.jm.joint_qd0,
                                 ant.jm.state()), W)
    for f in range(2):
        jc = jax.vmap(lambda x: j0.replace(joint_f=x))(
            jnp.asarray(jf[f].numpy()))
        for _ in range(4):
            js = ant.j_step(js, jc, ant.j_collide(js))
        ts = cs.usd_frame(ant.tpipe, ant.ts, ts, ctls[f])
        _close(ts, js)
    assert bool(torch.isfinite(ts.joint_q).all())


def _moved_coords(q0, seed):
    """One USD ant's joint_q0 with its hinges and its free root moved."""
    rng = np.random.RandomState(seed)
    q = np.asarray(q0, dtype=np.float32).copy()
    q[:8] += rng.uniform(-0.4, 0.4, 8)            # the hinges
    q[8:11] += np.array([0.3, -0.2, 0.05])        # the free root, last
    return q


def test_free_root_last_fk_matches_jax(ant):
    """FK from coordinates whose hinges and root both moved: the free
    root's 7 coordinates are the last of joint_q."""
    q = _moved_coords(ant.tm.joint_q0.numpy(), 1)
    qd = np.random.RandomState(2).randn(14).astype(np.float32)
    t = nt.eval_fk(ant.tm, torch.as_tensor(q), torch.as_tensor(qd),
                   ant.tm.state())
    j = j_eval_fk(ant.jm, jnp.asarray(q), jnp.asarray(qd), ant.jm.state())
    np.testing.assert_allclose(t.body_q.numpy(), np.asarray(j.body_q),
                               atol=1e-6)
    np.testing.assert_allclose(t.body_qd.numpy(), np.asarray(j.body_qd),
                               atol=1e-5)
    np.testing.assert_allclose(t.body_q[0, :3].numpy(), q[8:11], atol=1e-6)


@pytest.fixture(scope="module")
def two_ants():
    """replicate(USD ant, 2): the flat multi-world state and step."""
    def build(lib):
        b = lib.ModelBuilder()
        b.replicate(cs.usd_ant_scene(lib, ANT_USDA), 2)
        return b
    jm = build(jt).finalize()
    tm = build(nt).finalize("cpu")
    return jm, tm


def test_free_root_last_flat_step_and_reset_match_jax(two_ants):
    """Two replicated USD ants through the flat ``step`` (4 substeps, one
    world's hinges pushed by joint_f), then a reset of world 1 only,
    against the JAX package."""
    jm, tm = two_ants
    js = JSolver(jm, iterations=8, integrator="euler")
    jpipe = JPipe(jm)
    ts = nt.SolverMuJoCo(tm, iterations=8, integrator="euler")
    tpipe = nt.CollisionPipeline(tm)
    q = np.concatenate([_moved_coords(tm.joint_q0[:15].numpy(), 3 + w)
                        for w in range(2)])
    qd = np.zeros(28, np.float32)
    f = np.zeros(28, np.float32)
    f[:8] = 150.0 * np.random.RandomState(5).uniform(-1, 1, 8)
    t_s = nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd), tm.state())
    j_s = j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state())
    t_c = tm.control().replace(joint_f=torch.as_tensor(f))
    j_c = jm.control().replace(joint_f=jnp.asarray(f))
    j_step = jax.jit(lambda s: js.step(s, None, j_c, jpipe.collide(s), DT))
    for _ in range(4):
        t_s = ts.step(t_s, None, t_c, tpipe.collide(t_s), DT)
        j_s = j_step(j_s)
    _close(t_s, j_s)
    mask = np.array([False, True])
    t_r = ts.reset(t_s, mask)
    j_r = js.reset(j_s, mask)
    _close(t_r, j_r)
    init = tm.state()
    for name, n in (("joint_q", 15), ("joint_qd", 14), ("body_q", 13),
                    ("body_qd", 13)):
        a, b = getattr(t_r, name), getattr(t_s, name)
        assert torch.equal(a[n:], getattr(init, name)[n:]), name
        assert torch.equal(a[:n], b[:n]), name
        np.testing.assert_array_equal(np.asarray(getattr(j_r, name))[n:],
                                      np.asarray(getattr(jm.state(),
                                                         name))[n:])


def test_reference_defect_c49_view_root_is_the_first_joint(two_ants):
    """C.49: ArticulationView takes an articulation's first joint as its
    root (newton_tpu/utils/selection.py:97-98). The USD ant's free joint
    comes last, so both packages' views root at the first leg's fixed
    joint: root_is_free is False and the root transforms and velocities
    are that leg's body's, not the free joint's coordinates."""
    jm, tm = two_ants
    tv, jv = ArticulationView(tm, "*"), j_selection.ArticulationView(jm, "*")
    assert tv.root_is_free is False and jv.root_is_free is False
    np.testing.assert_array_equal(tv.root_joint.numpy(), jv.root_joint)
    np.testing.assert_array_equal(tv.root_body.numpy(), jv.root_body)
    np.testing.assert_array_equal(tv.dof_idx.numpy(), jv.dof_idx)
    np.testing.assert_array_equal(tv.coord_idx.numpy(), jv.coord_idx)
    q = np.concatenate([_moved_coords(tm.joint_q0[:15].numpy(), 7 + w)
                        for w in range(2)])
    qd = np.random.RandomState(9).randn(28).astype(np.float32)
    t_s = nt.eval_fk(tm, torch.as_tensor(q), torch.as_tensor(qd), tm.state())
    j_s = j_eval_fk(jm, jnp.asarray(q), jnp.asarray(qd), jm.state())
    np.testing.assert_allclose(tv.get_root_transforms(t_s).numpy(),
                               np.asarray(jv.get_root_transforms(j_s)),
                               atol=1e-6)
    np.testing.assert_allclose(tv.get_root_velocities(t_s).numpy(),
                               np.asarray(jv.get_root_velocities(j_s)),
                               atol=1e-5)
    # the leg's body, not the free joint's coordinates: the leg's COM
    # velocity is not the torso's
    legs = tv.root_body.numpy()
    np.testing.assert_array_equal(tv.get_root_velocities(t_s).numpy(),
                                  t_s.body_qd[legs].numpy())
