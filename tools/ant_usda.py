#!/usr/bin/env python3
"""Write ``newton_tpu_torch/assets/ant.usda``: a UsdPhysics transcription
of gymnasium's ``ant.xml`` (the copy in ``newton_tpu_torch/assets``).

    python3 tools/ant_usda.py [--out PATH] [--check]

The stage holds the MJCF ant's 13 bodies as sibling rigid bodies at their
world poses (the torso at z = 0.75; each leg's upper body on a
PhysicsFixedJoint to the torso, as the MJCF importer fixes a body without
a joint), its sphere and capsule geoms as colliders (a ``fromto`` capsule
becomes a Capsule along Z at the segment's midpoint, oriented onto the
segment, with the segment's length as its height), and its 8 hinges as
PhysicsRevoluteJoints about X in joint frames rotated onto the MJCF axis,
limits in degrees. Every hinge carries ``mjc:armature = 1`` and
``mjc:damping = 1`` (the MJCF default class). The torso has no joint: the
importer gives it a free joint after the authored ones. No density is
authored, so masses come from the geoms at the importer's default of
1000 kg/m^3, and no actuator: a caller drives ``control.joint_f``.

Every vector's components are rounded to float32, so that a ``.usdc`` written from
the parsed stage (whose vectors the crate stores as float32) reads back
to the same numbers as the text. ``--check`` compares the file on disk
with what the script would write and exits 1 if they differ.
"""

import argparse
import os
import sys
import xml.etree.ElementTree as ET

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from newton_tpu_torch.core.host_math import np_quat_between_axes  # noqa: E402

ASSETS = os.path.join(ROOT, "newton_tpu_torch", "assets")


def num(x) -> str:
    """A scalar, written so that float() reads it back exactly (the crate
    keeps a scalar that float32 cannot hold as a double)."""
    v = float(x)
    return str(int(v)) if v == int(v) else repr(v)


def vec(v) -> str:
    """A vector, each component rounded to float32."""
    return "(" + ", ".join(num(np.float32(x)) for x in v) + ")"


def quat_wxyz(q_xyzw) -> str:
    x, y, z, w = q_xyzw
    return vec((w, x, y, z))


def vec3(s: str) -> np.ndarray:
    return np.array([float(t) for t in s.split()])


def collect(body, parent_pos, parent_name, out, counter):
    """Bodies in MJCF order: (name, world pos, parent name, geoms, joint)."""
    pos = parent_pos + vec3(body.get("pos", "0 0 0"))
    counter[0] += 1
    name = body.get("name") or f"body_{counter[0] - 1}"
    joints = body.findall("joint")
    out.append(dict(name=name, pos=pos, parent=parent_name,
                    rel=vec3(body.get("pos", "0 0 0")),
                    geoms=body.findall("geom"),
                    joint=joints[0] if joints else None))
    for child in body.findall("body"):
        collect(child, pos, name, out, counter)


def geom_usda(g, ind: str) -> list:
    name = g.get("name")
    api = 'prepend apiSchemas = ["PhysicsCollisionAPI"]'
    if g.get("type") == "sphere":
        return [f'{ind}def Sphere "{name}" (', f"{ind}    {api}",
                f"{ind})", f"{ind}{{",
                f"{ind}    double radius = {num(float(g.get('size')))}",
                f"{ind}}}"]
    a, b = np.split(vec3(g.get("fromto")), 2)
    d = b - a
    q = np_quat_between_axes(np.array([0.0, 0.0, 1.0]), d / np.linalg.norm(d))
    return [f'{ind}def Capsule "{name}" (', f"{ind}    {api}", f"{ind})",
            f"{ind}{{",
            f"{ind}    double radius = {num(float(g.get('size')))}",
            f"{ind}    double height = {num(np.linalg.norm(d))}",
            f'{ind}    uniform token axis = "Z"',
            f"{ind}    double3 xformOp:translate = {vec(0.5 * (a + b))}",
            f"{ind}    quatf xformOp:orient = {quat_wxyz(q)}",
            f'{ind}    uniform token[] xformOpOrder = ["xformOp:translate", '
            f'"xformOp:orient"]',
            f"{ind}}}"]


def ant_usda(xml_path: str) -> str:
    root = ET.parse(xml_path).getroot()
    bodies = []
    for top in root.find("worldbody").findall("body"):
        collect(top, np.zeros(3), None, bodies, [0])
    lines = ["#usda 1.0", "(", '    defaultPrim = "ant"',
             "    metersPerUnit = 1", '    upAxis = "Z"', ")", "",
             'def PhysicsScene "physicsScene"', "{",
             "    vector3f physics:gravityDirection = (0, 0, -1)",
             "    float physics:gravityMagnitude = 9.81", "}", "",
             'def Xform "ant" (',
             '    prepend apiSchemas = ["PhysicsArticulationRootAPI"]',
             ")", "{"]
    for bd in bodies:
        lines += [f'    def Xform "{bd["name"]}" (',
                  '        prepend apiSchemas = ["PhysicsRigidBodyAPI", '
                  '"PhysicsMassAPI"]', "    )", "    {",
                  f"        double3 xformOp:translate = {vec(bd['pos'])}",
                  '        uniform token[] xformOpOrder = '
                  '["xformOp:translate"]']
        for g in bd["geoms"]:
            lines += geom_usda(g, "        ")
        lines += ["    }"]
    for bd in bodies:
        if bd["parent"] is None:
            continue
        j = bd["joint"]
        common = [f"        rel physics:body0 = </ant/{bd['parent']}>",
                  f"        rel physics:body1 = </ant/{bd['name']}>",
                  f"        point3f physics:localPos0 = {vec(bd['rel'])}",
                  "        point3f physics:localPos1 = (0, 0, 0)"]
        if j is None:
            lines += [f'    def PhysicsFixedJoint "{bd["name"]}_fixed"',
                      "    {"] + common + ["    }"]
            continue
        axis = vec3(j.get("axis"))
        q = quat_wxyz(np_quat_between_axes(np.array([1.0, 0.0, 0.0]),
                                           axis / np.linalg.norm(axis)))
        lo, hi = vec3(j.get("range"))
        lines += [f'    def PhysicsRevoluteJoint "{j.get("name")}"', "    {"]
        lines += common + [f"        quatf physics:localRot0 = {q}",
                           f"        quatf physics:localRot1 = {q}",
                           '        uniform token physics:axis = "X"',
                           f"        float physics:lowerLimit = {num(lo)}",
                           f"        float physics:upperLimit = {num(hi)}",
                           "        float mjc:armature = 1",
                           "        float mjc:damping = 1", "    }"]
    lines += ["}", ""]
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ASSETS, "ant.usda"))
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    text = ant_usda(os.path.join(ASSETS, "ant.xml"))
    if args.check:
        with open(args.out) as f:
            same = f.read() == text
        print("up to date" if same else f"{args.out} differs")
        sys.exit(0 if same else 1)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
