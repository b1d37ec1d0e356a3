"""MJCF (MuJoCo XML) importer: the subset the gymnasium ant, humanoid,
inverted pendulum (the reference's KPI cartpole), half_cheetah, hopper and
walker2d drive.

Port of ``newton_tpu/utils/import_mjcf.py`` (``parse_mjcf``): compiler
angle units and ``settotalmass``, ``<option>`` (captured into
``builder.mjc_options``; fluid forces raise), default classes,
``<custom><numeric name="init_qpos">`` (MuJoCo's wxyz free- and ball-joint
quaternions converted to xyzw), bodies with a free joint, one ball joint
(armature, damping, stiffness: the damping and stiffness on its three
dofs' drive gains), or slide and hinge joints (limits, armature, damping,
stiffness): one slide is a
prismatic joint, one hinge a revolute joint, and slides followed by hinges
one D6 joint that translates along the slides, then rotates about the
hinges' common ``pos``. A slide's ``ref`` shifts its limits into
displacement space and is kept in the ``mjc:qpos_ref`` coordinate
attribute at that slide's coordinate. Plane/sphere/box/capsule/cylinder/
ellipsoid geoms with contype/conaffinity, ``<site>`` in bodies and the worldbody
(massless, never colliding), ``<tendon><fixed>`` couplings of hinges and
``<spatial>`` tendons through sites and sphere/cylinder wrap geoms (with
``sidesite``; a one- or two-value ``springlength`` whose first value is the
rest length), ``<equality>`` connect, weld and joint rows, and
motor/position/velocity/general/intvelocity/damper/cylinder/muscle
actuators on hinges, slides and tendons into the ``MJCActuation`` tables
(a muscle's ``lengthrange`` from its joint's range, or from its spatial
tendon's build-pose length placed mid-``range``). Actuators and tendons
address each joint's own dof and coordinate. A ``<pulley>`` raises (the
JAX importer drops the tendon with a warning).

Visual-only elements (lights, cameras, textures, materials, ``<visual>``,
``<size>``) are skipped by name. Every other element raises
``NotImplementedError`` naming it: the importer never drops physics in
silence.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

from ..core.host_math import (
    np_quat_between_axes,
    np_quat_from_axis_angle,
    np_quat_identity,
    np_quat_mul,
    np_quat_rotate,
    np_quat_rotate_inv,
    np_transform,
    np_transform_identity,
    np_transform_multiply,
)
from ..core.types import MAXVAL
from ..sim.builder import JointDofConfig
from ..sim.enums import EqType, JointType
from ..sim.model import AttributeAssignment, AttributeFrequency
from ..geometry.types import GeoType
from ..sim.tendon import spatial_tendon_rest_length
from ..solvers.generalized.actuation import (
    BIAS_AFFINE,
    BIAS_MUSCLE,
    BIAS_NONE,
    DYN_FILTER,
    DYN_FILTEREXACT,
    DYN_INTEGRATOR,
    DYN_MUSCLE,
    DYN_NONE,
    GAIN_AFFINE,
    GAIN_FIXED,
    GAIN_MUSCLE,
    MJCActuation,
)

__all__ = ["parse_mjcf"]

_TOP_LEVEL = {"compiler", "option", "custom", "default", "asset",
              "worldbody", "actuator", "tendon", "equality"}
_VISUAL_ONLY = {"visual", "size", "light", "camera", "texture", "material"}
_BODY_CHILDREN = {"body", "geom", "joint", "freejoint", "site"}


def _unsupported(tag: str, where: str):
    raise NotImplementedError(
        f"MJCF <{tag}> in <{where}> is not supported by the port yet")


def _parse_vec(s: Optional[str], default=None, n=None):
    if s is None:
        return None if default is None else np.asarray(default,
                                                       dtype=np.float64)
    v = np.array(s.split(), dtype=np.float64)
    if n is not None and len(v) < n:
        v = np.concatenate([v, np.zeros(n - len(v))])
    return v


def _parse_float(s, default):
    return float(s) if s is not None else default


def _parse_bool(s, default):
    if s is None:
        return default
    return s.lower() in ("true", "1")


class _Defaults:
    """MuJoCo default-class tree: per-element-type attribute dicts."""

    def __init__(self, parent: Optional["_Defaults"] = None):
        self.parent = parent
        self.attrs: Dict[str, Dict[str, str]] = {}
        self.children: Dict[str, "_Defaults"] = {}

    def resolve(self, element_type: str) -> Dict[str, str]:
        out = dict(self.parent.resolve(element_type)) if self.parent else {}
        out.update(self.attrs.get(element_type, {}))
        return out

    def find(self, class_name: str) -> Optional["_Defaults"]:
        """The default class ``class_name`` anywhere below this node."""
        if class_name in self.children:
            return self.children[class_name]
        for ch in self.children.values():
            found = ch.find(class_name)
            if found is not None:
                return found
        return None


def _load_defaults(elem: ET.Element, parent=None) -> _Defaults:
    d = _Defaults(parent)
    for child in elem:
        if child.tag == "default":
            sub = _load_defaults(child, d)
            if child.get("class"):
                d.children[child.get("class")] = sub
        else:
            d.attrs[child.tag] = dict(child.attrib)
    return d


def parse_mjcf(builder, source: str):
    """Parse an MJCF file into ``builder``. Returns name -> index maps."""
    root = ET.parse(source).getroot()
    for child in root:
        if child.tag not in _TOP_LEVEL | _VISUAL_ONLY:
            _unsupported(child.tag, root.tag)
        if child.tag in _TOP_LEVEL and len(root.findall(child.tag)) > 1:
            raise NotImplementedError(
                f"repeated MJCF <{child.tag}> sections are not supported by "
                "the port yet")

    compiler = root.find("compiler")
    angle_deg = True
    autolimits = True
    total_mass = -1.0
    if compiler is not None:
        angle_deg = compiler.get("angle", "degree") == "degree"
        autolimits = compiler.get("autolimits", "true") == "true"
        if compiler.get("inertiafromgeom", "auto") not in ("true", "auto"):
            raise NotImplementedError(
                "MJCF compiler inertiafromgeom=false (explicit <inertial>) "
                "is not supported by the port yet")
        total_mass = _parse_float(compiler.get("settotalmass"), -1.0)

    def to_rad(x):
        return math.radians(x) if angle_deg else x

    option = root.find("option")
    if option is not None:
        for ch in option:
            _unsupported(ch.tag, "option")
        for attr in ("viscosity", "density"):
            if _parse_float(option.get(attr), 0.0) != 0.0:
                raise NotImplementedError(
                    f"MJCF <option {attr}=...> (fluid forces) is not "
                    "supported by the port yet")
        wind = _parse_vec(option.get("wind"))
        if wind is not None and wind.any():
            raise NotImplementedError(
                "MJCF <option wind=...> (fluid forces) is not supported by "
                "the port yet")
        g = _parse_vec(option.get("gravity"))
        if g is not None:
            builder.gravity = float(np.linalg.norm(g)) * \
                (-1.0 if g[2] <= 0 else 1.0)
        if option.get("integrator") is not None:
            builder.mjc_options["integrator"] = \
                option.get("integrator").strip().lower()
        if option.get("timestep") is not None:
            builder.mjc_options["timestep"] = float(option.get("timestep"))

    defaults_elem = root.find("default")
    defaults = _load_defaults(defaults_elem) if defaults_elem is not None \
        else _Defaults()

    asset = root.find("asset")
    if asset is not None:
        for ch in asset:
            if ch.tag not in _VISUAL_ONLY:
                _unsupported(ch.tag, "asset")

    name_to_body: Dict[str, int] = {"world": -1}
    eq_joint: Dict[str, tuple] = {}           # hinge, slide -> (joint, axis)
    joint_dof_start: Dict[str, int] = {}
    joint_coord_start: Dict[str, int] = {}
    coord_refs: Dict[int, float] = {}         # slide coordinate -> ref
    name_to_site: Dict[str, int] = {}
    name_to_shape: Dict[str, int] = {}

    def local_xform(attrib) -> np.ndarray:
        pos = _parse_vec(attrib.get("pos"), default=[0, 0, 0], n=3)
        if "quat" in attrib:
            q_wxyz = _parse_vec(attrib["quat"], n=4)
            q = np.array([q_wxyz[1], q_wxyz[2], q_wxyz[3], q_wxyz[0]])
            n = np.linalg.norm(q)
            q = q / n if n > 0 else np_quat_identity()
        elif "euler" in attrib:
            q = np_quat_identity()
            for ax, ang in zip(np.eye(3), _parse_vec(attrib["euler"], n=3)):
                q = np_quat_mul(q, np_quat_from_axis_angle(ax, to_rad(ang)))
        elif "axisangle" in attrib:
            aa = _parse_vec(attrib["axisangle"], n=4)
            q = np_quat_from_axis_angle(aa[:3], to_rad(aa[3]))
        elif "zaxis" in attrib:
            z = _parse_vec(attrib["zaxis"], n=3)
            q = np_quat_between_axes([0, 0, 1], z / np.linalg.norm(z))
        elif "xyaxes" in attrib:
            raise NotImplementedError(
                "MJCF xyaxes frames are not supported by the port yet")
        else:
            q = np_quat_identity()
        return np_transform(pos, q)

    def resolve_attrs(elem, etype, body_class) -> Dict[str, str]:
        cls = elem.get("class") or body_class
        d = defaults.find(cls) if cls else defaults
        if d is None:
            raise ValueError(f"MJCF default class {cls!r} is not defined")
        out = d.resolve(etype)
        out.update(elem.attrib)
        return out

    def add_geom(geom: ET.Element, body_idx: int, body_class):
        a = resolve_attrs(geom, "geom", body_class)
        gtype = a.get("type", "sphere")
        if gtype not in ("plane", "sphere", "box", "capsule", "cylinder",
                         "ellipsoid"):
            raise NotImplementedError(
                f"MJCF geom type {gtype!r} is not supported by the port yet")
        contype = int(_parse_float(a.get("contype"), 1))
        conaffinity = int(_parse_float(a.get("conaffinity"), 1))
        collides = (contype != 0) or (conaffinity != 0)
        cfg = builder.default_shape_cfg.copy()
        cfg.density = _parse_float(a.get("density"), 1000.0)
        cfg.mu = float(_parse_vec(a.get("friction"),
                                  default=[1.0, 0.005, 0.0001], n=3)[0])
        cfg.has_shape_collision = collides
        cfg.has_particle_collision = collides
        cfg.collision_group = 1 if collides else 0
        cfg.contype = contype
        cfg.conaffinity = conaffinity
        size = _parse_vec(a.get("size"), default=[0.01, 0, 0], n=3)
        xf = local_xform(a)
        half_h = None
        if "fromto" in a:
            ft = _parse_vec(a["fromto"], n=6)
            d = ft[3:] - ft[:3]
            length = np.linalg.norm(d)
            xf = np_transform(0.5 * (ft[:3] + ft[3:]),
                              np_quat_between_axes([0, 0, 1],
                                                   d / max(length, 1e-12)))
            half_h = 0.5 * length
        hh = half_h if half_h is not None else float(size[1])
        if a.get("mass") is not None:
            # geom mass overrides density (as MuJoCo: density = mass / vol)
            m_val, r = float(a["mass"]), float(size[0])
            vol = {"sphere": 4.0 / 3.0 * math.pi * r ** 3,
                   "capsule": math.pi * r * r * (2.0 * hh)
                   + 4.0 / 3.0 * math.pi * r ** 3,
                   "cylinder": math.pi * r * r * (2.0 * hh),
                   "box": 8.0 * float(size[0]) * float(size[1])
                   * float(size[2]),
                   "ellipsoid": 4.0 / 3.0 * math.pi * float(size[0])
                   * float(size[1]) * float(size[2])}.get(gtype, 0.0)
            if vol > 1e-12 and m_val > 0.0:
                cfg.density = m_val / vol
        key = a.get("name")
        if gtype == "plane":
            sidx = builder.add_shape_plane(body_idx, xform=xf, cfg=cfg,
                                           key=key)
        elif gtype == "sphere":
            sidx = builder.add_shape_sphere(body_idx, xform=xf,
                                            radius=float(size[0]), cfg=cfg,
                                            key=key)
        elif gtype == "box":
            sidx = builder.add_shape_box(body_idx, xform=xf,
                                         hx=float(size[0]),
                                         hy=float(size[1]),
                                         hz=float(size[2]), cfg=cfg, key=key)
        elif gtype == "capsule":
            sidx = builder.add_shape_capsule(body_idx, xform=xf,
                                             radius=float(size[0]),
                                             half_height=hh, axis="Z",
                                             cfg=cfg, key=key)
        elif gtype == "ellipsoid":
            sidx = builder.add_shape_ellipsoid(body_idx, xform=xf,
                                               rx=float(size[0]),
                                               ry=float(size[1]),
                                               rz=float(size[2]), cfg=cfg,
                                               key=key)
        else:
            sidx = builder.add_shape_cylinder(body_idx, xform=xf,
                                              radius=float(size[0]),
                                              half_height=hh, axis="Z",
                                              cfg=cfg, key=key)
        if key:
            name_to_shape[key] = sidx

    def add_site(site: ET.Element, body_idx: int, body_class):
        a = resolve_attrs(site, "site", body_class)
        sidx = builder.add_site(body_idx, xform=local_xform(a),
                                key=a.get("name",
                                          f"site_{builder.shape_count}"))
        if a.get("name"):
            name_to_site[a["name"]] = sidx

    def parse_joint(j: ET.Element, body_class):
        a = resolve_attrs(j, "joint", body_class)
        jtype = a.get("type", "hinge")
        if jtype not in ("hinge", "slide", "free", "ball"):
            raise NotImplementedError(
                f"MJCF joint type {jtype!r} is not supported by the port yet")
        ref = _parse_float(a.get("ref"), 0.0)
        if ref != 0.0 and jtype != "slide":
            raise NotImplementedError(
                f"MJCF ref on a {jtype} joint is not supported by the port "
                "yet")
        axis = _parse_vec(a.get("axis"), default=[0, 0, 1], n=3)
        nrm = np.linalg.norm(axis)
        axis = axis / nrm if nrm > 0 else np.array([0.0, 0, 1])
        rng = _parse_vec(a.get("range"), default=[0, 0], n=2)
        limited = _parse_bool(a.get("limited"), None)
        if limited is None:
            limited = autolimits and (rng[0] != 0.0 or rng[1] != 0.0)
        return dict(type=jtype, name=a.get("name"),
                    pos=_parse_vec(a.get("pos"), default=[0, 0, 0], n=3),
                    axis=axis, limited=limited, range=rng,
                    damping=_parse_float(a.get("damping"), 0.0),
                    armature=_parse_float(a.get("armature"), 0.0),
                    stiffness=_parse_float(a.get("stiffness"), 0.0),
                    ref=ref)

    def dof_cfg(j) -> JointDofConfig:
        """A hinge's limits in radians; a slide's in metres, shifted by its
        ``ref`` (MuJoCo qpos = Newton displacement + ref)."""
        if j["type"] == "slide":
            lo, hi = j["range"][0] - j["ref"], j["range"][1] - j["ref"]
        else:
            lo, hi = to_rad(j["range"][0]), to_rad(j["range"][1])
        return JointDofConfig(
            axis=j["axis"],
            limit_lower=lo if j["limited"] else -MAXVAL,
            limit_upper=hi if j["limited"] else MAXVAL,
            armature=j["armature"],
            target_kd=j["damping"],    # joint damping: drive to qd = 0
            target_ke=j["stiffness"])

    def parse_body(elem: ET.Element, parent_idx: int, X_parent_world,
                   body_class):
        for ch in elem:
            if ch.tag not in _BODY_CHILDREN | _VISUAL_ONLY:
                _unsupported(ch.tag, "body")
        childclass = elem.get("childclass") or body_class
        name = elem.get("name", f"body_{builder.body_count}")
        X_rel = local_xform(elem.attrib)
        X_world = np_transform_multiply(X_parent_world, X_rel)
        joints = [parse_joint(j, childclass) for j in elem.findall("joint")]
        if elem.find("freejoint") is not None:
            joints = [dict(type="free",
                           name=elem.find("freejoint").get("name"))]
        body_idx = builder.add_body(xform=X_world, key=name)
        name_to_body[name] = body_idx

        jd_start = builder.joint_dof_count
        jq_start = builder.joint_coord_count
        if not joints:
            jidx = builder.add_joint_fixed(parent_idx, body_idx,
                                           xform_p=X_rel, key=name + "_fixed")
        elif any(j["type"] == "free" for j in joints):
            if len(joints) > 1:
                raise NotImplementedError(
                    f"MJCF body {name!r} combines a free joint with others; "
                    "not supported by the port yet")
            jidx = builder.add_joint_free(body_idx, parent=parent_idx,
                                          key=joints[0]["name"])
        elif any(j["type"] == "ball" for j in joints):
            j = joints[0]
            if len(joints) > 1:
                raise NotImplementedError(
                    f"MJCF body {name!r} combines a ball joint with others; "
                    "not supported by the port yet")
            if j["limited"]:
                raise NotImplementedError(
                    f"MJCF ball joint {j['name']!r}: a limited ball joint "
                    "(a cone limit) is not supported by the port yet")
            # rotates about its pos; damping and stiffness act on its three
            # dofs as the drive gains (a spring to the identity quaternion)
            anchor = np_transform(j["pos"])
            jidx = builder.add_joint_ball(
                parent_idx, body_idx,
                xform_p=np_transform_multiply(X_rel, anchor),
                xform_c=anchor, armature=j["armature"], key=j["name"])
            d0 = builder.joint_qd_start[jidx]
            builder.joint_target_kd[d0:d0 + 3] = [j["damping"]] * 3
            builder.joint_target_ke[d0:d0 + 3] = [j["stiffness"]] * 3
        else:
            # slides then hinges: one joint that translates, then rotates
            # (a D6 joint's linear axes come first, as the MJCF order here)
            lin = [j for j in joints if j["type"] == "slide"]
            ang = joints[len(lin):]
            if any(j["type"] == "slide" for j in ang):
                raise NotImplementedError(
                    f"MJCF body {name!r}: a slide joint after a hinge (a "
                    "translation along a rotated axis) is not supported by "
                    "the port yet")
            if any(not np.array_equal(j["pos"], ang[0]["pos"])
                   for j in ang):
                raise NotImplementedError(
                    f"MJCF body {name!r}: hinges at different positions in "
                    "one body are not supported by the port yet")
            # a hinge rotates about its own pos; a slide's pos moves nothing
            # (MuJoCo), so the hinges' pos is the anchor whatever the
            # slides' (the JAX importer takes the first joint's: ROADMAP C)
            anchor = np_transform((ang or lin)[0]["pos"])
            jtype = (JointType.REVOLUTE if not lin and len(ang) == 1 else
                     JointType.PRISMATIC if not ang and len(lin) == 1 else
                     JointType.D6)
            jidx = builder.add_joint(
                jtype, parent_idx, body_idx,
                linear_axes=[dof_cfg(j) for j in lin],
                angular_axes=[dof_cfg(j) for j in ang],
                xform_p=np_transform_multiply(X_rel, anchor),
                xform_c=anchor, key=joints[0]["name"])
            for k, j in enumerate(lin):
                if j["ref"] != 0.0:
                    coord_refs[jq_start + k] = j["ref"]
        # each MJCF hinge's own dof and coordinate, for actuators and
        # tendons (a free joint takes 6 dofs and 7 coordinates)
        for k, j in enumerate(joints):
            if j["name"] and j["type"] != "ball":
                joint_dof_start[j["name"]] = jd_start + k
                joint_coord_start[j["name"]] = jq_start + k
                if j["type"] in ("hinge", "slide"):
                    eq_joint[j["name"]] = (jidx, k)
        for g in elem.findall("geom"):
            add_geom(g, body_idx, childclass)
        for st_ in elem.findall("site"):
            add_site(st_, body_idx, childclass)
        for child in elem.findall("body"):
            parse_body(child, body_idx, X_world, childclass)

    worldbody = root.find("worldbody")
    if worldbody is None:
        raise ValueError("MJCF has no <worldbody>")
    for ch in worldbody:
        if ch.tag not in {"body", "geom", "site"} | _VISUAL_ONLY:
            _unsupported(ch.tag, "worldbody")
    builder.add_articulation(key=root.get("model") or "mjcf")
    b0 = builder.body_count
    for g in worldbody.findall("geom"):
        add_geom(g, -1, None)
    for st_ in worldbody.findall("site"):
        add_site(st_, -1, None)
    for body in worldbody.findall("body"):
        parse_body(body, -1, np_transform_identity(), None)
    if total_mass > 0.0:
        # <compiler settotalmass>: every body's mass and inertia scale by
        # one factor to the total, as MuJoCo's compiler does (the JAX
        # importer ignores it: ROADMAP C)
        scale = total_mass / sum(builder.body_mass[b0:])
        for b in range(b0, builder.body_count):
            builder.body_mass[b] *= scale
            builder.body_inertia[b] = builder.body_inertia[b] * scale
    if coord_refs:
        builder.add_custom_attribute("mjc:qpos_ref",
                                     AttributeFrequency.JOINT_COORD)
        builder.add_custom_values("mjc:qpos_ref", coord_refs)

    tendon_root = root.find("tendon")
    name_to_tendon: Dict[str, int] = {}
    name_to_sten: Dict[str, int] = {}
    if tendon_root is not None:
        _parse_tendons(builder, tendon_root, resolve_attrs, eq_joint,
                       name_to_site, name_to_shape, name_to_tendon,
                       name_to_sten)

    eq_root = root.find("equality")
    if eq_root is not None:
        _parse_equality(builder, eq_root, name_to_body, eq_joint)

    act_root = root.find("actuator")
    if act_root is not None:
        _parse_actuators(builder, act_root, resolve_attrs, joint_dof_start,
                         joint_coord_start, name_to_tendon, name_to_sten)

    custom_elem = root.find("custom")
    if custom_elem is not None:
        for num in custom_elem:
            if num.tag != "numeric" or num.get("name") != "init_qpos":
                _unsupported(num.tag, "custom")
            qpos = _parse_vec(num.get("data"))
            if qpos is not None and len(qpos) <= builder.joint_coord_count:
                qpos = _mjc_qpos_to_newton(builder, qpos)
                builder.joint_q[:len(qpos)] = list(qpos)

    return dict(bodies=name_to_body, joint_dof_start=joint_dof_start,
                joint_coord_start=joint_coord_start)


def _parse_tendons(builder, tendon_root, resolve_attrs, name_to_joint,
                   name_to_site, name_to_shape, name_to_tendon, name_to_sten):
    """``<fixed>`` tendons over named hinges and slides, each entry at its
    joint's own axis of the Newton joint, and ``<spatial>`` tendons through
    sites and wrap geoms."""
    for fx in tendon_root:
        if fx.tag not in ("fixed", "spatial"):
            _unsupported(fx.tag, "tendon")
        a = resolve_attrs(fx, "tendon", None)
        for attr in ("limited", "range", "frictionloss") + (
                ("springlength",) if fx.tag == "fixed" else ()):
            if attr in a:
                raise NotImplementedError(
                    f"MJCF <{fx.tag}> tendon attribute {attr!r} is not "
                    "supported by the port yet")
        if fx.tag == "spatial":
            _parse_spatial(builder, fx, a, name_to_site, name_to_shape,
                           name_to_sten)
            continue
        joints, axes, coefs = [], [], []
        for jel in fx:
            if jel.tag != "joint":
                _unsupported(jel.tag, "fixed")
            jn = jel.get("joint", "")
            if jn not in name_to_joint:
                raise ValueError(f"MJCF <fixed> tendon {fx.get('name')!r} "
                                 f"names {jn!r}, which is not a hinge or "
                                 "a slide")
            joints.append(name_to_joint[jn][0])
            axes.append(name_to_joint[jn][1])
            coefs.append(float(jel.get("coef", "1")))
        if joints:
            tid = builder.add_tendon_fixed(
                joints, coefs, axes=axes,
                stiffness=_parse_float(a.get("stiffness"), 0.0),
                damping=_parse_float(a.get("damping"), 0.0),
                key=fx.get("name"))
            if fx.get("name"):
                name_to_tendon[fx.get("name")] = tid


def _site_world(builder, sidx):
    """A site's world position at the build pose."""
    sb = int(builder.shape_body[sidx])
    p = np.asarray(builder.shape_transform[sidx][:3])
    if sb < 0:
        return p
    bx = np.asarray(builder.body_q[sb])
    return bx[:3] + np_quat_rotate(bx[3:7], p)


def _parse_spatial(builder, sp, a, name_to_site, name_to_shape,
                   name_to_sten):
    """One ``<spatial>`` tendon: sites (body-frame points) and sphere or
    cylinder wrap geoms, a sidesite in the wrap body's frame."""
    name = sp.get("name")
    elems = []
    for ch in sp:
        if ch.tag == "site":
            sname = ch.get("site", "")
            if sname not in name_to_site:
                raise ValueError(f"MJCF <spatial> {name!r} names site "
                                 f"{sname!r}, which is not defined")
            sidx = name_to_site[sname]
            elems.append(("site", int(builder.shape_body[sidx]),
                          tuple(np.asarray(builder.shape_transform[sidx][:3]))
                          ))
        elif ch.tag == "geom":
            gname = ch.get("geom", "")
            if gname not in name_to_shape:
                raise ValueError(f"MJCF <spatial> {name!r} names geom "
                                 f"{gname!r}, which is not defined")
            gidx = name_to_shape[gname]
            gb = int(builder.shape_body[gidx])
            gx = np.asarray(builder.shape_transform[gidx])
            gt = int(builder.shape_type[gidx])
            side = None
            ssname = ch.get("sidesite")
            if ssname:
                if ssname not in name_to_site:
                    raise ValueError(f"MJCF <spatial> {name!r} names "
                                     f"sidesite {ssname!r}, which is not "
                                     "defined")
                # the sidesite in the wrap body's frame (exact on the wrap
                # body, a build-pose approximation elsewhere)
                sw = _site_world(builder, name_to_site[ssname])
                if gb >= 0:
                    bx = np.asarray(builder.body_q[gb])
                    side = tuple(np_quat_rotate_inv(bx[3:7], sw - bx[:3]))
                else:
                    side = tuple(sw)
            r = float(builder.shape_scale[gidx][0])
            if gt == int(GeoType.SPHERE):
                elems.append(("sphere", gb, tuple(gx[:3]), r, side))
            elif gt == int(GeoType.CYLINDER):
                ax = np_quat_rotate(gx[3:7], np.array([0.0, 0.0, 1.0]))
                elems.append(("cylinder", gb, tuple(gx[:3]), tuple(ax), r,
                              side))
            else:
                raise NotImplementedError(
                    f"MJCF <spatial> {name!r}: a wrap geom of type "
                    f"{GeoType(gt).name} is not supported (sphere and "
                    "cylinder only)")
        elif ch.tag == "pulley":
            raise NotImplementedError(
                f"MJCF <spatial> {name!r}: <pulley> is not supported by the "
                "port (the JAX importer skips the tendon with a warning)")
        else:
            _unsupported(ch.tag, "spatial")
    # springlength takes one or two values (a dead band); the first is the
    # rest length, -1 (the default) the build-pose length
    slen = float(_parse_vec(a.get("springlength"), default=[-1.0])[0])
    tid = builder.add_tendon_spatial(
        elems, stiffness=_parse_float(a.get("stiffness"), 0.0),
        damping=_parse_float(a.get("damping"), 0.0),
        rest_length=None if slen < 0 else slen, key=name)
    if name:
        name_to_sten[name] = tid


def _parse_equality(builder, eq_root, name_to_body, eq_joint):
    """``<connect>`` (anchor in body1's frame), ``<weld>`` (body1 held at
    body2's orientation and at its initial offset) and ``<joint>`` (q1 =
    polycoef(q2)) as the JAX importer reads them; a missing body2 or
    joint2 is the world or a constant. ``solref``/``solimp`` are not read
    (the solver's rows are hard, as the JAX package's). Attributes that
    would change the constraint and are not ported raise."""
    def body(eq, attr):
        name = eq.get(attr)
        if name is None:
            return -1
        if name not in name_to_body:
            raise ValueError(f"MJCF <{eq.tag}> {attr}={name!r} names no body")
        return name_to_body[name]

    def joint(eq, attr):
        name = eq.get(attr)
        if name is None:
            return -1
        if name not in eq_joint:
            raise ValueError(f"MJCF <joint> equality {attr}={name!r} names "
                             "no hinge or slide")
        j, k = eq_joint[name]
        if k:
            raise NotImplementedError(
                f"MJCF <joint> equality on {name!r}, the axis {k} of a "
                "multi-axis joint, is not supported by the port yet")
        return j

    for eq in eq_root:
        if eq.tag not in ("connect", "weld", "joint"):
            _unsupported(eq.tag, "equality")
        if eq.get("active", "true") != "true":
            raise NotImplementedError(
                "MJCF inactive equality constraints are not supported by "
                "the port yet")
        if eq.tag == "weld":
            for attr in ("relpose", "anchor", "torquescale"):
                if attr in eq.attrib:
                    raise NotImplementedError(
                        f"MJCF <weld> attribute {attr!r} is not supported "
                        "by the port yet")
        if eq.tag == "connect":
            builder.add_equality_constraint(
                EqType.CONNECT, body1=body(eq, "body1"),
                body2=body(eq, "body2"),
                anchor=_parse_vec(eq.get("anchor"), default=[0, 0, 0], n=3),
                key=eq.get("name"))
        elif eq.tag == "weld":
            builder.add_equality_constraint(
                EqType.WELD, body1=body(eq, "body1"), body2=body(eq, "body2"),
                key=eq.get("name"))
        else:
            builder.add_equality_constraint(
                EqType.JOINT, joint1=joint(eq, "joint1"),
                joint2=joint(eq, "joint2"),
                polycoef=_parse_vec(eq.get("polycoef"),
                                    default=[0, 1, 0, 0, 0], n=5),
                key=eq.get("name"))


_DYN = {"none": DYN_NONE, "integrator": DYN_INTEGRATOR,
        "filter": DYN_FILTER, "filterexact": DYN_FILTEREXACT,
        "muscle": DYN_MUSCLE}
_GAIN = {"fixed": GAIN_FIXED, "affine": GAIN_AFFINE, "muscle": GAIN_MUSCLE}
_BIAS = {"none": BIAS_NONE, "affine": BIAS_AFFINE, "muscle": BIAS_MUSCLE}
_ACTUATORS = ("motor", "position", "velocity", "general", "intvelocity",
              "damper", "cylinder", "muscle")


def _lowered(tag, a, r):
    """An actuator shortcut lowered to the canonical gain/bias/dyntype
    form (MuJoCo's, as the JAX importer lowers it) into ``r``."""
    if tag == "general":
        for key, table, default in (("dyntype", _DYN, "none"),
                                    ("gaintype", _GAIN, "fixed"),
                                    ("biastype", _BIAS, "none")):
            v = a.get(key, default)
            if v not in table:
                raise NotImplementedError(
                    f"MJCF <general {key}={v!r}> is not supported by the "
                    "port yet")
            r[key] = table[v]
        for key, n in (("dynprm", 3), ("gainprm", 9), ("biasprm", 9)):
            v = _parse_vec(a.get(key))
            if v is not None:
                r[key] = list(v[:n]) + [0.0] * max(0, n - len(v))
    elif tag == "position":
        kp = _parse_float(a.get("kp"), 1.0)
        kv = _parse_float(a.get("kv"), 0.0)
        r["gainprm"] = [kp] + [0.0] * 8
        r["biastype"] = BIAS_AFFINE
        r["biasprm"] = [0.0, -kp, -kv] + [0.0] * 6
        tc = _parse_float(a.get("timeconst"), 0.0)
        if tc > 0.0:
            r["dyntype"] = DYN_FILTEREXACT
            r["dynprm"] = [tc, 0.0, 0.0]
    elif tag == "velocity":
        kv = _parse_float(a.get("kv"), 1.0)
        r["gainprm"] = [kv] + [0.0] * 8
        r["biastype"] = BIAS_AFFINE
        r["biasprm"] = [0.0, 0.0, -kv] + [0.0] * 6
    elif tag == "intvelocity":
        kp = _parse_float(a.get("kp"), 1.0)
        kv = _parse_float(a.get("kv"), 0.0)
        r["dyntype"] = DYN_INTEGRATOR
        r["gainprm"] = [kp] + [0.0] * 8
        r["biastype"] = BIAS_AFFINE
        r["biasprm"] = [0.0, -kp, -kv] + [0.0] * 6
        if r["actrange"] is None:
            r["actrange"] = r["ctrlrange"]
    elif tag == "damper":
        kv = _parse_float(a.get("kv"), 1.0)
        r["gaintype"] = GAIN_AFFINE
        r["gainprm"] = [0.0, 0.0, -kv] + [0.0] * 6
    elif tag == "cylinder":
        area = _parse_float(a.get("area"), 1.0)
        if a.get("diameter") is not None:
            area = math.pi * float(a["diameter"]) ** 2 / 4.0
        r["dyntype"] = DYN_FILTER
        r["dynprm"] = [_parse_float(a.get("timeconst"), 1.0), 0.0, 0.0]
        r["gainprm"] = [area] + [0.0] * 8
        bias = _parse_vec(a.get("bias"), default=[0, 0, 0], n=3)
        if np.any(bias != 0):
            r["biastype"] = BIAS_AFFINE
            r["biasprm"] = list(bias) + [0.0] * 6
    elif tag == "muscle":
        tc = _parse_vec(a.get("timeconst"), default=[0.01, 0.04], n=2)
        r["dyntype"] = DYN_MUSCLE
        r["dynprm"] = [tc[0], tc[1], _parse_float(a.get("tausmooth"), 0.0)]
        rg = _parse_vec(a.get("range"), default=[0.75, 1.05], n=2)
        prm = [rg[0], rg[1], _parse_float(a.get("force"), -1.0),
               _parse_float(a.get("scale"), 200.0),
               _parse_float(a.get("lmin"), 0.5),
               _parse_float(a.get("lmax"), 1.6),
               _parse_float(a.get("vmax"), 1.5),
               _parse_float(a.get("fpmax"), 1.3),
               _parse_float(a.get("fvmax"), 1.2)]
        r["gaintype"] = GAIN_MUSCLE
        r["biastype"] = BIAS_MUSCLE
        r["gainprm"] = list(prm)
        r["biasprm"] = list(prm)
        if r["ctrlrange"] is None:
            r["ctrlrange"] = np.array([0.0, 1.0])


def _parse_actuators(builder, act_root, resolve_attrs, joint_dof_start,
                     joint_coord_start, name_to_tendon, name_to_sten):
    """Actuators on hinge and slide joints and on fixed and spatial tendons
    -> MJCActuation (and ``mjc:act``, the activation state, where an
    actuator has activation dynamics)."""
    builder.add_custom_attribute("mjc:actuator_gear",
                                 AttributeFrequency.JOINT_DOF, default=0.0)
    builder.add_custom_attribute("mjc:actuator_ctrlrange_lo",
                                 AttributeFrequency.JOINT_DOF,
                                 default=-MAXVAL)
    builder.add_custom_attribute("mjc:actuator_ctrlrange_hi",
                                 AttributeFrequency.JOINT_DOF, default=MAXVAL)
    recs = []
    for act in act_root:
        if act.tag not in _ACTUATORS:
            _unsupported(act.tag, "actuator")
        a = resolve_attrs(act, act.tag, None)
        for trn in ("site", "body", "jointinparent", "cranksite"):
            if trn in a:
                _unsupported(f"{act.tag} {trn}=...", "actuator")
        jname, tname = a.get("joint"), a.get("tendon")
        r = dict(dof=-1, coord=-1, tendon=-1, sten=-1,
                 gear=float(a["gear"].split()[0]) if a.get("gear") else 1.0,
                 ctrlrange=_parse_vec(a.get("ctrlrange"), n=2),
                 forcerange=_parse_vec(a.get("forcerange"), n=2),
                 actrange=_parse_vec(a.get("actrange"), n=2),
                 dyntype=DYN_NONE, dynprm=[1.0, 0.0, 0.0],
                 gaintype=GAIN_FIXED, gainprm=[1.0] + [0.0] * 8,
                 biastype=BIAS_NONE, biasprm=[0.0] * 9)
        if tname is not None and tname in name_to_tendon:
            r["tendon"] = name_to_tendon[tname]
        elif tname is not None and tname in name_to_sten:
            r["sten"] = name_to_sten[tname]
        elif jname is not None and jname in joint_dof_start:
            r["dof"] = joint_dof_start[jname]
            r["coord"] = joint_coord_start[jname]
        else:
            raise NotImplementedError(
                f"MJCF <{act.tag}> without a hinge, slide or tendon "
                "transmission is not supported by the port yet")
        _lowered(act.tag, a, r)
        recs.append(r)
        if r["dof"] >= 0:
            crv = r["ctrlrange"] if r["ctrlrange"] is not None \
                else np.array([-MAXVAL, MAXVAL])
            dof = r["dof"]
            builder.add_custom_values("mjc:actuator_gear", {dof: r["gear"]})
            builder.add_custom_values("mjc:actuator_ctrlrange_lo",
                                      {dof: float(crv[0])})
            builder.add_custom_values("mjc:actuator_ctrlrange_hi",
                                      {dof: float(crv[1])})
    if not recs:
        return
    au = MJCActuation(len(recs))
    for i, r in enumerate(recs):
        for key in ("dof", "coord", "tendon", "sten", "gear", "dyntype",
                    "gaintype", "biastype"):
            getattr(au, key)[i] = r[key]
        au.dynprm[i] = r["dynprm"]
        au.gainprm[i] = r["gainprm"]
        au.biasprm[i] = r["biasprm"]
        for key, rng, lim in (("ctrlrange", au.ctrlrange, au.ctrllimited),
                              ("forcerange", au.forcerange, au.forcelimited),
                              ("actrange", au.actrange, au.actlimited)):
            v = r[key]
            if v is not None and (v[0] != 0.0 or v[1] != 0.0):
                rng[i] = v
                lim[i] = True
        if r["dof"] >= 0:
            # the joint's range in transmission length (MuJoCo's compiled
            # lengthrange of a joint transmission)
            lo = builder.joint_limit_lower[r["dof"]]
            hi = builder.joint_limit_upper[r["dof"]]
            au.lengthrange[i] = sorted([r["gear"] * lo, r["gear"] * hi])
        elif r["sten"] >= 0 and r["gaintype"] == GAIN_MUSCLE:
            # MuJoCo finds a tendon muscle's lengthrange by a simulation;
            # the JAX importer (and so the port) places the build-pose
            # length at the middle of the muscle's operating range
            Lb = spatial_tendon_rest_length(builder.sten_paths[r["sten"]],
                                            builder.body_q)
            rg = r["gainprm"][:2]
            lopt = Lb / max(0.5 * (rg[0] + rg[1]), 1e-9)
            au.lengthrange[i] = sorted([r["gear"] * rg[0] * lopt,
                                        r["gear"] * rg[1] * lopt])
    builder.mjc_actuation = au.finish()
    builder.add_custom_attribute("mjc:ctrl", AttributeFrequency.ONCE,
                                 shape=(len(recs),),
                                 assignment=AttributeAssignment.CONTROL)
    if au.has_act:
        builder.add_custom_attribute("mjc:act", AttributeFrequency.ONCE,
                                     shape=(len(recs),),
                                     assignment=AttributeAssignment.STATE)


def _mjc_qpos_to_newton(builder, qpos: np.ndarray) -> np.ndarray:
    """MuJoCo qpos (free joint: pos + wxyz quat; ball joint: wxyz) -> the
    builder's layout (pos + xyzw; xyzw)."""
    out = np.array(qpos, dtype=np.float64)
    i = 0
    for j, t in enumerate(builder.joint_type):
        nq = builder.joint_q_start[j + 1] - builder.joint_q_start[j]
        if i + nq > len(out):
            break
        if JointType(t) == JointType.FREE:
            w = out[i + 3]
            out[i + 3:i + 6] = out[i + 4:i + 7]
            out[i + 6] = w
        elif JointType(t) == JointType.BALL:
            w = out[i]
            out[i:i + 3] = out[i + 1:i + 4]
            out[i + 3] = w
        i += nq
    return out
