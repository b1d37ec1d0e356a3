"""URDF importer (port of ``newton_tpu/utils/import_urdf.py``).

Links become bodies (``<inertial>`` mass, COM and inertia; collision and
visual geometry: box, sphere, cylinder and capsule along Z, visual shapes
without collision and without mass), joints become revolute, continuous
(revolute without limits), prismatic, fixed, floating (free) and planar
joints (a D6 joint with two linear axes spanning the plane and one
angular axis about its normal), each with its ``<limit>`` and
``<dynamics>`` damping (a drive's target_kd) and friction, and a
``<mimic>`` tag a mimic constraint (q = offset + multiplier q_source,
``add_constraint_mimic``), resolved after every joint exists. The root
link is fixed to the world at ``xform`` or, with ``floating``, takes a
free joint.

Where the port differs from the JAX importer, on purpose: a planar joint
is a planar joint (the JAX importer makes it fixed), a ``<mimic>`` may
name a joint declared after it (the JAX importer drops it),
``enable_self_collisions=False`` filters every pair of this robot's
links and ``collapse_fixed_joints=True`` merges fixed-jointed links (the
JAX importer reads neither). A collision mesh is read from its binary
STL or OBJ file (``package://`` stripped, relative to the URDF's
directory, times its ``scale`` and the importer's) into
``add_shape_mesh``; a file that cannot be read raises naming it (the JAX
importer drops the shape). Visual meshes are skipped, as in the JAX
importer.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

from ..core.host_math import (
    np_quat_from_axis_angle,
    np_quat_mul,
    np_transform,
    np_transform_multiply,
)
from ..core.types import MAXVAL
from ..geometry.types import Mesh
from .import_mjcf import _load_mesh_file

__all__ = ["parse_urdf"]


def _origin_xform(elem: Optional[ET.Element], scale: float) -> np.ndarray:
    if elem is None:
        return np_transform()
    xyz = np.array(elem.get("xyz", "0 0 0").split(), dtype=np.float64) * scale
    rpy = np.array(elem.get("rpy", "0 0 0").split(), dtype=np.float64)
    # URDF rpy is extrinsic XYZ = intrinsic ZYX
    qz = np_quat_from_axis_angle([0, 0, 1], rpy[2])
    qy = np_quat_from_axis_angle([0, 1, 0], rpy[1])
    qx = np_quat_from_axis_angle([1, 0, 0], rpy[0])
    return np_transform(xyz, np_quat_mul(qz, np_quat_mul(qy, qx)))


def _plane_axes(normal: np.ndarray):
    """Two orthonormal axes spanning the plane normal to ``normal``."""
    t = np.array([1.0, 0, 0]) if abs(normal[0]) < 0.9 else np.array(
        [0.0, 1, 0])
    u = t - normal * (normal @ t)
    u = u / np.linalg.norm(u)
    return u, np.cross(normal, u)


def parse_urdf(builder, source: str, xform=None, floating: bool = False,
               scale: float = 1.0, density: float = 1000.0,
               collapse_fixed_joints: bool = False,
               enable_self_collisions: bool = False,
               key_prefix: Optional[str] = None):
    """Parse a URDF file or XML string into ``builder``. Returns
    ``dict(bodies=..., joints=...)``, name -> index maps."""
    if os.path.exists(source):
        root = ET.parse(source).getroot()
        base_dir = os.path.dirname(os.path.abspath(source))
    else:
        root = ET.fromstring(source)
        base_dir = "."
    pre = (key_prefix + "/") if key_prefix else ""
    links = {link.get("name"): link for link in root.findall("link")}
    joints = root.findall("joint")
    child_joints: Dict[str, ET.Element] = {}
    parent_of: Dict[str, str] = {}
    for j in joints:
        child = j.find("child").get("link")
        child_joints[child] = j
        parent_of[child] = j.find("parent").get("link")
    roots = [name for name in links if name not in parent_of]
    name_to_body: Dict[str, int] = {}
    name_to_joint: Dict[str, int] = {}
    mimics = []
    base_xform = (np.asarray(xform, dtype=np.float64) if xform is not None
                  else np_transform())
    b0 = builder.body_count
    builder.add_articulation(key=pre + (root.get("name") or "urdf"))

    def add_link_shapes(link: ET.Element, body_idx: int, has_inertial: bool):
        for col in link.findall("collision") + link.findall("visual"):
            is_visual = col.tag == "visual"
            cfg = builder.default_shape_cfg.copy()
            # URDF <inertial> is authoritative: geometry adds no mass then
            cfg.density = 0.0 if (is_visual or has_inertial) else density
            if is_visual:
                cfg.has_shape_collision = False
                cfg.has_particle_collision = False
                cfg.collision_group = 0
            xf = _origin_xform(col.find("origin"), scale)
            geom = col.find("geometry")
            if geom is None:
                continue
            key = pre + (col.get("name") or f"{link.get('name')}_shape")
            box, sph = geom.find("box"), geom.find("sphere")
            cyl, cap = geom.find("cylinder"), geom.find("capsule")
            if box is not None:
                size = np.array(box.get("size").split(),
                                dtype=np.float64) * scale
                builder.add_shape_box(body_idx, xform=xf, hx=size[0] / 2,
                                      hy=size[1] / 2, hz=size[2] / 2,
                                      cfg=cfg, key=key)
            elif sph is not None:
                builder.add_shape_sphere(
                    body_idx, xform=xf,
                    radius=float(sph.get("radius")) * scale, cfg=cfg, key=key)
            elif cyl is not None or cap is not None:
                el = cyl if cyl is not None else cap
                add = (builder.add_shape_cylinder if cyl is not None
                       else builder.add_shape_capsule)
                add(body_idx, xform=xf,
                    radius=float(el.get("radius")) * scale,
                    half_height=float(el.get("length")) * scale / 2,
                    axis="Z", cfg=cfg, key=key)
            elif geom.find("mesh") is not None:
                if is_visual:
                    continue
                # a collision mesh: its file (package:// stripped) under
                # the URDF's directory, times its scale and the importer's
                mel = geom.find("mesh")
                fname = mel.get("filename", "").replace("package://", "")
                m = _load_mesh_file(os.path.join(base_dir, fname))
                msc = np.array(mel.get("scale", "1 1 1").split(),
                               dtype=np.float64)
                # mass properties of the scaled vertices (ROADMAP C.42)
                builder.add_shape_mesh(body_idx, xform=xf, mesh=Mesh(
                    m.vertices * msc * scale, m.indices), cfg=cfg, key=key)
            else:
                raise NotImplementedError(
                    f"URDF geometry {[c.tag for c in geom]} of link "
                    f"{link.get('name')!r} is not supported by the port")

    def add_link(name: str, X_world: np.ndarray) -> int:
        link = links[name]
        inertial = link.find("inertial")
        mass, com, I_m = 0.0, None, None
        if inertial is not None:
            mass_el = inertial.find("mass")
            mass = float(mass_el.get("value")) if mass_el is not None else 0.0
            com = _origin_xform(inertial.find("origin"), scale)[:3]
            el = inertial.find("inertia")
            if el is not None:
                v = {k: float(el.get(k, 0)) for k in
                     ("ixx", "iyy", "izz", "ixy", "ixz", "iyz")}
                I_m = np.array([[v["ixx"], v["ixy"], v["ixz"]],
                                [v["ixy"], v["iyy"], v["iyz"]],
                                [v["ixz"], v["iyz"], v["izz"]]])
        body_idx = builder.add_body(xform=X_world, mass=mass, com=com,
                                    I_m=I_m, key=pre + name)
        name_to_body[name] = body_idx
        add_link_shapes(link, body_idx, inertial is not None)
        return body_idx

    def add_joint(j: ET.Element, parent_idx: int, body_idx: int,
                  X_rel: np.ndarray, jname: str) -> int:
        jtype = j.get("type")
        axis_el = j.find("axis")
        axis = (np.array(axis_el.get("xyz").split(), dtype=np.float64)
                if axis_el is not None else np.array([1.0, 0, 0]))
        nrm = np.linalg.norm(axis)
        axis = axis / nrm if nrm > 0 else np.array([1.0, 0, 0])
        lim, dyn = j.find("limit"), j.find("dynamics")

        def lget(attr, default):
            return float(lim.get(attr, default)) if lim is not None \
                else default
        lo, hi = lget("lower", -MAXVAL), lget("upper", MAXVAL)
        effort, vel = lget("effort", MAXVAL), lget("velocity", MAXVAL)
        damping = float(dyn.get("damping", 0)) if dyn is not None else 0.0
        friction = float(dyn.get("friction", 0)) if dyn is not None else 0.0
        common = dict(xform_p=X_rel, xform_c=None, key=jname)
        dof = dict(effort_limit=effort, velocity_limit=vel,
                   target_kd=damping, friction=friction)
        if jtype == "revolute":
            return builder.add_joint_revolute(
                parent_idx, body_idx, axis=axis, limit_lower=lo,
                limit_upper=hi, **dof, **common)
        if jtype == "continuous":
            return builder.add_joint_revolute(parent_idx, body_idx,
                                              axis=axis, **dof, **common)
        if jtype == "prismatic":
            return builder.add_joint_prismatic(
                parent_idx, body_idx, axis=axis, limit_lower=lo * scale,
                limit_upper=hi * scale, **dof, **common)
        if jtype == "floating":
            return builder.add_joint_free(body_idx, parent=parent_idx,
                                          **common)
        if jtype == "planar":
            u, v = _plane_axes(axis)

            def cfg(a):
                c = builder.default_joint_cfg.copy()
                c.axis = a
                for k, x in dof.items():
                    setattr(c, k, x)
                return c
            return builder.add_joint_d6(
                parent_idx, body_idx, linear_axes=[cfg(u), cfg(v)],
                angular_axes=[cfg(axis)], **common)
        if jtype == "fixed":
            return builder.add_joint_fixed(parent_idx, body_idx, **common)
        raise NotImplementedError(f"URDF joint type {jtype!r} of joint "
                                  f"{j.get('name')!r} is not supported")

    def recurse(name: str, parent_idx: int, X_parent: np.ndarray):
        j = child_joints.get(name)
        if j is None:                       # a root link
            X_here = base_xform
            body_idx = add_link(name, X_here)
            if floating:
                builder.add_joint_free(body_idx, key=pre + name + "_free")
            else:
                builder.add_joint_fixed(-1, body_idx, xform_p=X_here,
                                        key=pre + name + "_fixed")
        else:
            X_rel = _origin_xform(j.find("origin"), scale)
            X_here = np_transform_multiply(X_parent, X_rel)
            body_idx = add_link(name, X_here)
            jname = pre + (j.get("name") or f"joint_{name}")
            jidx = add_joint(j, parent_idx, body_idx, X_rel, jname)
            name_to_joint[j.get("name") or jname] = jidx
            mimic = j.find("mimic")
            if mimic is not None:
                mimics.append((jidx, mimic))
        for cname, pname in parent_of.items():
            if pname == name:
                recurse(cname, name_to_body[name], X_here)

    for r in roots:
        recurse(r, -1, base_xform)
    for jidx, mimic in mimics:
        src = mimic.get("joint")
        if src not in name_to_joint:
            raise ValueError(f"URDF <mimic> names {src!r}, which is not a "
                             "joint of this robot")
        builder.add_constraint_mimic(
            jidx, name_to_joint[src],
            multiplier=float(mimic.get("multiplier", 1.0)),
            offset=float(mimic.get("offset", 0.0)))
    if not enable_self_collisions:
        for a in range(b0, builder.body_count):
            for b in range(a + 1, builder.body_count):
                builder._filter_body_pair(a, b)
    if collapse_fixed_joints:
        builder.collapse_fixed_joints()
    return dict(bodies=name_to_body, joints=name_to_joint)
