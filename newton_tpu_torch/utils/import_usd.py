"""USD importer over the self-contained USDA parser and crate reader
(port of ``newton_tpu/utils/import_usd.py``, which imports no JAX; the
port keeps its own copy so that it never imports the JAX package).

Parses UsdPhysics from `.usda` text, or from a binary `.usdc` crate file
recognised by its magic (``usd/usdc.py``), with no pxr dependency:
PhysicsScene gravity, PhysicsRigidBodyAPI bodies, PhysicsCollisionAPI
colliders (Cube/Sphere/Capsule/Cylinder/Mesh/Plane), PhysicsMassAPI
overrides, Physics{Revolute,Prismatic,Fixed,Spherical} joints and generic
PhysicsJoint (D6) with body0/body1 relationships and local anchors, a free
joint for every body no joint holds (added after every authored joint, so
a free root comes last in the joint order), deformable surfaces (cloth),
TetMesh volumes (soft bodies), BasisCurves cables and PhysicsAttachment
welds and pins. Vendor attributes (PhysX/Newton/Mjc) resolve through
pluggable schema resolvers.

Reference defect kept for parity (ROADMAP C.48): the Mjc resolver maps
``mjc:damping`` and ``mjc:stiffness``, but only armature and friction
reach the joint, so both are dropped. Where the port differs on purpose
(C.50): the JAX importer tests stage values for truth, so a mesh
collider, a TetMesh, a cable or an attachment read from a ``.usdc`` (whose
arrays come back as numpy arrays) raises there; the port tests whether
the value is there and imports them as from the ``.usda``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..core.host_math import (
    np_quat_rotate,
    np_transform,
    np_transform_identity,
    np_transform_multiply,
)
from ..geometry.types import Mesh
from ..sim.enums import EqType
from .usda_parser import UsdaPrim, parse_usda

__all__ = ["parse_usd", "SchemaResolver", "SchemaResolverManager",
           "NewtonSchemaResolver", "PhysxSchemaResolver", "MjcSchemaResolver"]


class SchemaResolver:
    """Maps vendor USD attribute names to unified names
    (reference: usd/schema_resolver.py:46)."""

    prefix = ""
    mapping: Dict[str, str] = {}

    def resolve(self, prim: UsdaPrim, unified: str, default=None):
        for vendor, uni in self.mapping.items():
            if uni == unified and prim.get(vendor) is not None:
                return prim.get(vendor)
        return default


class PhysxSchemaResolver(SchemaResolver):
    """PhysxSchema attributes (reference: usd/schemas.py:301)."""

    prefix = "physx"
    mapping = {
        "physxJoint:armature": "armature",
        "physxRigidBody:linearDamping": "linear_damping",
        "physxRigidBody:angularDamping": "angular_damping",
        "physxScene:timeStepsPerSecond": "substeps",
    }


class NewtonSchemaResolver(SchemaResolver):
    """NewtonPhysics attributes (reference: usd/schemas.py:115)."""

    prefix = "newton"
    mapping = {
        "newton:armature": "armature",
        "newton:jointFriction": "friction",
    }


class MjcSchemaResolver(SchemaResolver):
    """MjcPhysics attributes written by MuJoCo's USD exporter
    (reference: usd/schemas.py:482 MjcSchemaResolver)."""

    prefix = "mjc"
    mapping = {
        "mjc:armature": "armature",
        "mjc:damping": "damping",
        "mjc:stiffness": "stiffness",
        "mjc:frictionloss": "friction",
        "mjc:actuatorfrcrange:min": "effort_limit_lo",
        "mjc:actuatorfrcrange:max": "effort_limit_hi",
        "mjc:option:timestep": "timestep",
        "mjc:solimp": "solimp",
        "mjc:solref": "solref",
        "mjc:condim": "condim",
        "mjc:margin": "contact_margin",
        "mjc:gap": "contact_gap",
    }


class SchemaResolverManager:
    """Ordered resolver chain (reference: usd/schema_resolver.py:192)."""

    def __init__(self, resolvers: Optional[List[SchemaResolver]] = None):
        self.resolvers = resolvers or [NewtonSchemaResolver(),
                                       PhysxSchemaResolver(),
                                       MjcSchemaResolver()]

    def resolve(self, prim: UsdaPrim, unified: str, default=None):
        for r in self.resolvers:
            v = r.resolve(prim, unified)
            if v is not None:
                return v
        return default


def _given(v) -> bool:
    """Whether a stage value is there: not None and, for a list or an
    array (the crate reader returns numpy arrays), not empty. The JAX
    importer tests values for truth, which raises on an array (ROADMAP
    C.50)."""
    return v is not None and (not hasattr(v, "__len__") or len(v) > 0)


def _first_given(*values):
    return next((v for v in values if _given(v)), None)


def _xform_of(prim: UsdaPrim) -> np.ndarray:
    """Compose xformOp:translate/orient/rotate/scale (scale returned apart)."""
    t = np.zeros(3)
    q = np.array([0.0, 0.0, 0.0, 1.0])
    tr = prim.get("xformOp:translate")
    if tr is not None:
        t = np.asarray(tr, dtype=np.float64)
    ori = prim.get("xformOp:orient")
    if ori is not None:  # quatf stored (w, x, y, z)
        w, x, y, z = ori
        q = np.array([x, y, z, w], dtype=np.float64)
        nq = np.linalg.norm(q)
        q = q / nq if nq > 0 else np.array([0.0, 0, 0, 1])
    return np_transform(t, q)


def _scale_of(prim: UsdaPrim) -> np.ndarray:
    sc = prim.get("xformOp:scale")
    return (np.asarray(sc, dtype=np.float64) if sc is not None
            else np.ones(3))


def parse_usd(builder, source: str, xform=None, floating: bool = False,
              scale: float = 1.0, key_prefix: Optional[str] = None,
              resolvers: Optional[SchemaResolverManager] = None):
    """Parse a .usda file or string, or a .usdc file, into ``builder``.

    Returns a dict of name -> index maps: ``bodies``, ``joints``, ``soft``
    (a TetMesh's particles), ``cables`` (a curve's rod bodies) and
    ``attachments`` (the attachments lowered to CONNECT constraints).
    ``floating`` is accepted and ignored, as in the JAX importer: a body
    no joint holds always gets a free joint.
    """
    root = None
    if os.path.exists(source):
        with open(source, "rb") as f:
            magic = f.read(8)
        if magic == b"PXR-USDC":
            # binary crate stage: own dependency-free reader (usd/usdc.py)
            from ..usd.usdc import read_usdc
            root = read_usdc(source)
        else:
            with open(source) as f:
                text = f.read()
    else:
        text = source
    if root is None:
        root = parse_usda(text)
    rm = resolvers or SchemaResolverManager()
    pre = (key_prefix + "/") if key_prefix else ""
    base = np.asarray(xform, dtype=np.float64) if xform is not None \
        else np_transform_identity()

    name_to_body: Dict[str, int] = {}
    name_to_joint: Dict[str, int] = {}

    # gravity from PhysicsScene
    for prim in root.walk():
        if prim.type_name == "PhysicsScene":
            g = _first_given(prim.get("gravity"),
                             prim.get("physics:gravityDirection"))
            if g is not None:
                gv = np.asarray(g, dtype=np.float64)
                mag = prim.get("physics:gravityMagnitude")
                if mag is not None:
                    gv = gv * float(mag)
                builder.gravity = -float(np.linalg.norm(gv))

    builder.add_articulation(key=pre + "usd")

    def add_collider(prim: UsdaPrim, body_idx: int, X_parent: np.ndarray,
                     parent_scale: np.ndarray):
        X_local = _xform_of(prim)
        sc = _scale_of(prim) * parent_scale * scale
        xf = np_transform_multiply(X_parent, X_local)
        cfg = builder.default_shape_cfg.copy()
        key = pre + prim.path.strip("/").replace("/", ".")
        if prim.type_name == "Cube":
            size = float(prim.get("size", 2.0))
            h = 0.5 * size * sc
            builder.add_shape_box(body_idx, xform=xf, hx=h[0], hy=h[1],
                                  hz=h[2], cfg=cfg, key=key)
        elif prim.type_name == "Sphere":
            r = float(prim.get("radius", 1.0)) * float(np.max(sc))
            builder.add_shape_sphere(body_idx, xform=xf, radius=r, cfg=cfg,
                                     key=key)
        elif prim.type_name in ("Capsule", "Cylinder"):
            r = float(prim.get("radius", 0.5)) * float(np.max(sc[:2]))
            h = 0.5 * float(prim.get("height", 1.0)) * float(sc[2])
            axis = str(prim.get("axis", "Z")).strip('"')
            fn = (builder.add_shape_capsule if prim.type_name == "Capsule"
                  else builder.add_shape_cylinder)
            fn(body_idx, xform=xf, radius=r, half_height=h, axis=axis,
               cfg=cfg, key=key)
        elif prim.type_name == "Mesh":
            pts = prim.get("points")
            idx = prim.get("faceVertexIndices")
            counts = prim.get("faceVertexCounts")
            if _given(pts) and _given(idx):
                verts = np.asarray(pts, dtype=np.float64) * sc
                tris = []
                k = 0
                for c in (counts if _given(counts)
                          else [3] * (len(idx) // 3)):
                    for j in range(1, c - 1):
                        tris.append([idx[k], idx[k + j], idx[k + j + 1]])
                    k += c
                mesh = Mesh(verts, np.asarray(tris, dtype=np.int32).reshape(-1))
                builder.add_shape_mesh(body_idx, xform=xf, mesh=mesh, cfg=cfg,
                                       key=key)
        elif prim.type_name == "Plane":
            builder.add_shape_plane(body_idx, xform=xf, cfg=cfg, key=key)

    def add_deformable(prim: UsdaPrim, X_here: np.ndarray,
                       sc_here: np.ndarray):
        """Deformable surface prim -> cloth particles/triangles
        (reference: import_usd_deformable_cloth.py; PhysxSchema
        PhysxDeformableSurfaceAPI / Newton deformable schema)."""
        pts = prim.get("points")
        idx = prim.get("faceVertexIndices")
        counts = prim.get("faceVertexCounts")
        if pts is None or idx is None:
            return
        verts = np.asarray(pts, dtype=np.float64) * sc_here
        tris = []
        k = 0
        for c in (counts if counts is not None
                  else [3] * (len(idx) // 3)):
            c = int(c)
            for t in range(1, c - 1):
                tris.append([idx[k], idx[k + t], idx[k + t + 1]])
            k += c
        dens = prim.get("physxDeformable:density")
        builder.add_cloth_mesh(
            pos=np.asarray(X_here[:3]), rot=np.asarray(X_here[3:7]),
            vel=(0, 0, 0), vertices=verts,
            indices=np.asarray(tris, dtype=np.int64),
            density=float(dens) if dens is not None else 1.0)

    def walk_body(prim: UsdaPrim, X_parent: np.ndarray,
                  parent_scale: np.ndarray):
        X_here = np_transform_multiply(X_parent, _xform_of(prim))
        sc_here = _scale_of(prim) * parent_scale
        if (prim.has_api("PhysxDeformableSurfaceAPI")
                or prim.has_api("NewtonDeformableSurfaceAPI")):
            add_deformable(prim, X_here, sc_here)
            return
        if prim.has_api("PhysicsRigidBodyAPI"):
            mass = prim.get("physics:mass")
            diag = prim.get("physics:diagonalInertia")
            com = prim.get("physics:centerOfMass")
            body_idx = builder.add_body(
                xform=X_here,
                mass=float(mass) if mass is not None else 0.0,
                I_m=np.diag(np.asarray(diag, dtype=np.float64))
                if diag is not None else None,
                com=np.asarray(com, dtype=np.float64)
                if com is not None else None,
                key=pre + prim.path.strip("/").replace("/", "."))
            name_to_body[prim.path] = body_idx
            for child in prim.walk():
                if child.has_api("PhysicsCollisionAPI"):
                    X_rel, sc_rel = _relative_xform(root, prim, child)
                    add_collider(child, body_idx, X_rel, sc_rel * sc_here)
            return
        for child in prim.children:
            walk_body(child, X_here, sc_here)

    def _parent_of(root_prim, target):
        for p in root_prim.walk():
            if target in p.children:
                return p
        return None

    def _relative_xform(root_prim, ancestor, target):
        """(transform, scale) of target relative to ancestor (exclusive)."""
        chain = []
        node = target
        while node is not ancestor and node is not None:
            chain.append(node)
            node = _parent_of(root_prim, node)
        X = np_transform_identity()
        sc = np.ones(3)
        # intermediate prims between ancestor and target (exclusive of target:
        # the collider's own xform is composed by add_collider)
        for nd in reversed(chain[1:]):
            X = np_transform_multiply(X, _xform_of(nd))
            sc = sc * _scale_of(nd)
        return X, sc

    for prim in root.children:
        walk_body(prim, base, np.ones(3))

    # joints
    JOINT_TYPES = {"PhysicsRevoluteJoint": "revolute",
                   "PhysicsPrismaticJoint": "prismatic",
                   "PhysicsFixedJoint": "fixed",
                   "PhysicsSphericalJoint": "ball",
                   "PhysicsJoint": "d6"}
    for prim in root.walk():
        if prim.type_name not in JOINT_TYPES:
            continue
        kind = JOINT_TYPES[prim.type_name]
        b0_path = prim.get("physics:body0")
        b1_path = prim.get("physics:body1")
        b0 = _lookup_body(name_to_body, b0_path)
        b1 = _lookup_body(name_to_body, b1_path)
        if b1 is None and b0 is not None:
            b0, b1 = None, b0
        if b1 is None:
            continue
        lp0 = np.asarray(prim.get("physics:localPos0", (0, 0, 0)),
                         dtype=np.float64) * scale
        lp1 = np.asarray(prim.get("physics:localPos1", (0, 0, 0)),
                         dtype=np.float64) * scale
        lr0 = prim.get("physics:localRot0")
        lr1 = prim.get("physics:localRot1")

        def quat_of(lr):
            if lr is None:
                return np.array([0.0, 0, 0, 1])
            w, x, y, z = lr
            q = np.array([x, y, z, w], dtype=np.float64)
            n = np.linalg.norm(q)
            return q / n if n > 0 else np.array([0.0, 0, 0, 1])

        X_p = np_transform(lp0, quat_of(lr0))
        X_c = np_transform(lp1, quat_of(lr1))
        axis = str(prim.get("physics:axis", "X")).strip('"')
        lo = prim.get("physics:lowerLimit")
        hi = prim.get("physics:upperLimit")
        deg2rad = np.pi / 180.0
        key = pre + prim.path.strip("/").replace("/", ".")
        kwargs = dict(xform_p=X_p, xform_c=X_c, key=key)
        # vendor attributes via the resolver chain (newton/physx/mjc);
        # damping and stiffness resolve but are not applied (C.48)
        dof_kw = dict(kwargs)
        arm = rm.resolve(prim, "armature")
        fric = rm.resolve(prim, "friction")
        if arm is not None:
            dof_kw["armature"] = float(arm)
        if fric is not None:
            dof_kw["friction"] = float(fric)
        parent = b0 if b0 is not None else -1
        if kind == "revolute":
            j = builder.add_joint_revolute(
                parent, b1, axis=axis,
                limit_lower=float(lo) * deg2rad if lo is not None else None,
                limit_upper=float(hi) * deg2rad if hi is not None else None,
                **dof_kw)
        elif kind == "prismatic":
            j = builder.add_joint_prismatic(
                parent, b1, axis=axis,
                limit_lower=float(lo) * scale if lo is not None else None,
                limit_upper=float(hi) * scale if hi is not None else None,
                **dof_kw)
        elif kind == "ball":
            j = builder.add_joint_ball(parent, b1, **kwargs)
        elif kind == "fixed":
            j = builder.add_joint_fixed(parent, b1, **kwargs)
        else:
            j = builder.add_joint_d6(parent, b1, **kwargs)
        name_to_joint[prim.path] = j

    # free joints for unjointed roots
    jointed = {builder.joint_child[j] for j in range(builder.joint_count)}
    for path, b_idx in name_to_body.items():
        if b_idx not in jointed:
            builder.add_joint_free(b_idx, key=pre + path.strip("/") + ".free")
            jointed.add(b_idx)

    # deformable VOLUME prims -> FEM tet soft bodies (reference:
    # utils/import_usd_deformable_volume.py): TetMesh prims, or Mesh prims
    # carrying a DeformableBodyAPI with simulation tet indices
    soft_particles: Dict[str, List[int]] = {}
    for prim in root.walk():
        is_tet = prim.type_name == "TetMesh"
        has_api = (prim.has_api("DeformableBodyAPI")
                   or prim.has_api("PhysxDeformableBodyAPI"))
        if not (is_tet or has_api):
            continue
        pts = prim.get("points")
        tets = _first_given(prim.get("tetVertexIndices"),
                            prim.get("physxDeformable:simulationIndices"),
                            prim.get("newton:simulationIndices"))
        if pts is None or tets is None:
            continue
        X_local = _xform_of(prim)
        sc = _scale_of(prim) * scale
        xf = np_transform_multiply(base, X_local)
        verts = np.asarray(pts, dtype=np.float64) * sc[None, :]
        density = float(prim.get("physics:density",
                                 prim.get("physxDeformable:density", 100.0)))
        young = float(prim.get("physxDeformable:youngsModulus", 1.0e4))
        poisson = float(prim.get("physxDeformable:poissonsRatio", 0.3))
        k_mu = young / (2 * (1 + poisson))
        k_lambda = young * poisson / ((1 + poisson) * (1 - 2 * poisson))
        ids = builder.add_soft_mesh(
            pos=xf[0:3], rot=xf[3:7], vel=(0, 0, 0), vertices=verts,
            indices=np.asarray(tets, dtype=np.int64).reshape(-1, 4),
            density=density, k_mu=k_mu, k_lambda=k_lambda)
        soft_particles[prim.path] = ids

    # deformable CABLE prims: linear BasisCurves -> capsule-chain rod
    # graphs (reference: import_usd_deformable_cable.py). Hard coincident
    # point-point curve-to-curve PhysicsAttachments weld curves into one
    # shared rod graph; remaining attachments lower onto the rod bodies as
    # CONNECT equality constraints to rigid bodies / the world
    # (reference: import_usd_deformable_attachments.py lowers them as
    # joints; equality rows keep the rod topology a tree here).
    cables: Dict[str, List[int]] = {}
    attachments: List[str] = []
    curve_prims = [p for p in root.walk() if p.type_name == "BasisCurves"
                   and (any(("Deformable" in s) or ("Cable" in s)
                            for s in p.api_schemas)
                        or p.get("physics:cable") is True)]
    attach_prims = [p for p in root.walk()
                    if p.type_name == "PhysicsAttachment"]

    def _first_target(rel):
        if rel is None:
            return None
        if isinstance(rel, list):
            rel = rel[0] if rel else None
        return str(rel) if rel is not None else None

    if curve_prims:
        pts_all: List[np.ndarray] = []
        edges_all: List[tuple] = []
        curve_range: Dict[str, tuple] = {}
        radius_by_curve: Dict[str, float] = {}
        for prim in curve_prims:
            pts = prim.get("points")
            counts = prim.get("curveVertexCounts")
            if not (_given(pts) and _given(counts)):
                continue
            sc = _scale_of(prim) * scale
            xf = np_transform_multiply(base, _xform_of(prim))
            P = np.asarray(pts, dtype=np.float64) * sc
            Pw = xf[0:3] + np.stack([np_quat_rotate(xf[3:7], p) for p in P])
            off = len(pts_all)
            k = 0
            for c in counts:
                c = int(c)
                for t in range(c - 1):
                    edges_all.append((off + k + t, off + k + t + 1))
                k += c
            pts_all.extend(Pw)
            curve_range[prim.path] = (off, off + len(P))
            widths = prim.get("widths")
            radius_by_curve[prim.path] = (
                0.5 * float(np.mean(np.asarray(widths, dtype=np.float64)))
                if _given(widths) else 0.02)
        P_all = np.asarray(pts_all)

        # union-find node welding over hard coincident junctions
        uf = list(range(len(P_all)))

        def find(a):
            while uf[a] != a:
                uf[a] = uf[uf[a]]
                a = uf[a]
            return a

        consumed = set()
        for ap in attach_prims:
            s0 = _first_target(ap.get("physics:src0"))
            s1 = _first_target(ap.get("physics:src1"))
            if s0 in curve_range and s1 in curve_range:
                i0s = _first_given(ap.get("physics:indices0"), [])
                i1s = _first_given(ap.get("physics:indices1"), [])
                stiff = ap.get("physics:stiffness")
                hard = stiff is None or stiff == float("inf")
                for a_i, b_i in zip(i0s, i1s):
                    g0 = curve_range[s0][0] + int(a_i)
                    g1 = curve_range[s1][0] + int(b_i)
                    if hard and np.linalg.norm(P_all[g0] - P_all[g1]) < 1e-5:
                        uf[find(g0)] = find(g1)
                        consumed.add(ap.path)

        rep = np.asarray([find(i) for i in range(len(P_all))])
        # BFS-order edges so every non-root edge extends a visited point
        # (add_rod_graph welds shared endpoints by first-visit registration)
        adj: Dict[int, List[tuple]] = {}
        for (a, b) in edges_all:
            ra, rb = int(rep[a]), int(rep[b])
            adj.setdefault(ra, []).append((ra, rb))
            adj.setdefault(rb, []).append((rb, ra))
        visited_pts, emitted, ordered = set(), set(), []
        for start in sorted(adj):
            if start in visited_pts:
                continue
            stack = [start]
            visited_pts.add(start)
            while stack:
                p0 = stack.pop()
                for (i, j) in adj.get(p0, ()):
                    ekey = (min(i, j), max(i, j))
                    if ekey in emitted:
                        continue
                    emitted.add(ekey)
                    ordered.append((i, j))
                    if j not in visited_pts:
                        visited_pts.add(j)
                        stack.append(j)
        r_med = float(np.median(list(radius_by_curve.values()))) \
            if radius_by_curve else 0.02
        rod_bodies = builder.add_rod_graph(P_all, ordered, radius=r_med,
                                           key=pre + "usd_cable")
        for path, (o0, o1) in curve_range.items():
            cables[path] = rod_bodies
        # point -> (body, local anchor) map mirroring add_rod_graph's
        # registration (z-aligned capsules, endpoints at +/- L/2)
        point_body: Dict[int, tuple] = {}
        for ei, (i, j) in enumerate(ordered):
            b = rod_bodies[ei]
            L = float(np.linalg.norm(P_all[j] - P_all[i]))
            if i not in point_body:
                point_body[i] = (b, np.array([0.0, 0, -L / 2]))
            point_body[j] = (b, np.array([0.0, 0, L / 2]))

        # remaining attachments: cable point -> rigid body / world
        for ap in attach_prims:
            if ap.path in consumed:
                continue
            s0 = _first_target(ap.get("physics:src0"))
            s1 = _first_target(ap.get("physics:src1"))
            if s0 not in curve_range and s1 in curve_range:
                s0, s1 = s1, s0
            if s0 not in curve_range:
                continue
            if ap.get("physics:attachmentEnabled") is False:
                continue
            i0s = _first_given(ap.get("physics:indices0"), [0])
            gpt = int(rep[curve_range[s0][0] + int(i0s[0])])
            if gpt not in point_body:
                continue
            cb, local = point_body[gpt]
            target = _lookup_body(name_to_body, s1) if s1 else None
            builder.add_equality_constraint(
                EqType.CONNECT, body1=int(cb),
                body2=int(target) if target is not None else -1,
                anchor=local, key=pre + ap.path.strip("/").replace("/", "."))
            attachments.append(ap.path)

    return dict(bodies=name_to_body, joints=name_to_joint,
                soft=soft_particles, cables=cables,
                attachments=attachments)


def _lookup_body(name_to_body: Dict[str, int], rel) -> Optional[int]:
    if rel is None:
        return None
    if isinstance(rel, list):
        rel = rel[0] if rel else None
    if rel is None:
        return None
    path = str(rel)
    if path in name_to_body:
        return name_to_body[path]
    for p, idx in name_to_body.items():
        if p.endswith(path) or path.endswith(p):
            return idx
    return None
