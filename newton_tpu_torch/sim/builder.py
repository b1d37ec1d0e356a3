"""Scene authoring: host-side ``ModelBuilder`` -> ``Model`` on a device.

Port of the subset of ``newton_tpu/sim/builder.py`` that the gymnasium
robots, the reference's replicated-world KPI scenes, rods and the MPM path
drive: bodies, articulations, free/revolute/prismatic/fixed/ball joints and
D6 joints with linear and angular axes, ball-jointed rods (``add_rod``),
fixed tendons, plane/sphere/box/capsule/cylinder/cone/ellipsoid shapes with
density-driven mass, triangle-mesh, convex-hull, heightfield and SDF shapes
(their samples, hulls and SDF bakes prepared at ``finalize`` by
``sim/mesh_prep.py``), particles, cloth and soft topology (springs and
seams, membrane triangles, bending edges, tetrahedra, the cloth grid and
mesh, the soft grid and mesh), world contexts (``begin_world``,
``add_world``, ``add_builder`` and the vectorized ``replicate``) with
per-world gravity, MJCF-style collision filtering, the static candidate
contact pairs with their slot layout, the particle-shape candidates, and
``finalize`` onto a device (the card unless the caller names another).
Host storage is float64 numpy, like the JAX builder; the
candidate-pair order and slot offsets are the JAX builder's exactly,
because the solvers' contact rows follow them. Host work that grows with
the number of worlds is vectorized, so that a model of 8192 humanoid
worlds finalizes in seconds.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

import math

import numpy as np
import torch

from ..core.host_math import (
    np_quat_between_axes,
    np_quat_identity,
    np_quat_mul,
    np_quat_rotate,
    np_transform,
    np_transform_identity,
    np_transform_inverse,
    np_transform_multiply,
    np_transform_point,
    np_transform_vector,
)
from ..core.types import MAXVAL, Axis, AxisType, axis_to_vec3
from ..geometry.inertia import (
    compute_box_inertia,
    compute_capsule_inertia,
    compute_cone_inertia,
    compute_cylinder_inertia,
    compute_ellipsoid_inertia,
    compute_sphere_inertia,
    transform_inertia,
)
from ..geometry.narrow_phase import pair_slot_count
from ..geometry.types import SDF, GeoType, Heightfield, Mesh, ShapeFlags
from ..solvers.generalized.actuation import MJCActuation
from .enums import BodyFlags, EqType, JointType, ParticleFlags
from .mesh_prep import (MESH_KINDS, _convex_hull_mesh,
                        mesh_collision_radius, mesh_mass,
                        prepare_mesh_data)
from .tendon import SpatialTendonPath, spatial_tendon_rest_lengths
from .model import (
    AttributeAssignment,
    AttributeFrequency,
    AttributeSpec,
    Model,
    ModelStructure,
)

__all__ = ["ModelBuilder", "ShapeConfig", "JointDofConfig"]

_JOINT_TYPES = (JointType.FREE, JointType.REVOLUTE, JointType.PRISMATIC,
                JointType.FIXED, JointType.D6, JointType.BALL,
                JointType.DISTANCE, JointType.CABLE)
# each shape type the port builds, with its mass properties from
# (density, scale)
_SHAPE_MASS = {
    GeoType.PLANE: None,
    GeoType.SPHERE: lambda rho, s: compute_sphere_inertia(rho, s[0]),
    GeoType.BOX: lambda rho, s: compute_box_inertia(rho, s[0], s[1], s[2]),
    GeoType.CAPSULE: lambda rho, s: compute_capsule_inertia(rho, s[0], s[1]),
    GeoType.CYLINDER: lambda rho, s: compute_cylinder_inertia(rho, s[0],
                                                              s[1]),
    GeoType.CONE: lambda rho, s: compute_cone_inertia(rho, s[0], s[1]),
    GeoType.ELLIPSOID: lambda rho, s: compute_ellipsoid_inertia(
        rho, s[0], s[1], s[2]),
    GeoType.NONE: None,                 # sites: massless frame markers
    # mesh kinds: a mesh or hull's mass comes from its source (mesh_mass)
    GeoType.MESH: None, GeoType.CONVEX: None, GeoType.HFIELD: None,
    GeoType.SDF: None,
}
# per-dof lists of the builder (one entry per dof, in dof order)
_DOF_LISTS = ("joint_armature", "joint_target_ke", "joint_target_kd",
              "joint_limit_lower", "joint_limit_upper", "joint_limit_ke",
              "joint_limit_kd", "joint_friction", "joint_effort_limit",
              "joint_velocity_limit", "joint_qd")
# per-actuator tables of MJCActuation that carry no index
_ACTUATION_TABLES = ("gear", "dyntype", "dynprm", "gaintype", "gainprm",
                     "biastype", "biasprm", "ctrlrange", "forcerange",
                     "actrange", "ctrllimited", "forcelimited",
                     "actlimited", "lengthrange", "acc0")


def _as_transform(xform) -> np.ndarray:
    if xform is None:
        return np_transform_identity()
    t = np.asarray(xform, dtype=np.float64).reshape(-1)
    if t.shape[0] != 7:
        raise ValueError(f"Transform must have 7 components [p, q_xyzw], "
                         f"got {t.shape}")
    return t.copy()


def _axis_shape_xform(xform, axis: AxisType) -> np.ndarray:
    """``xform`` with the shape's +Z turned onto ``axis``."""
    q = np_quat_between_axes(np.array([0.0, 0.0, 1.0]), axis_to_vec3(axis))
    return np_transform_multiply(_as_transform(xform), np_transform(q=q))


@dataclass
class ShapeConfig:
    """Shape defaults (same fields and defaults as the JAX builder's)."""

    density: float = 1000.0
    mu: float = 0.5
    restitution: float = 0.0
    # hydroelastic modulus (Pa/m): pressure = kh * penetration, read by a
    # CollisionPipeline(hydroelastic=True)
    kh: float = 1.0e6
    thickness: float = 1.0e-5
    collision_group: int = 1
    has_shape_collision: bool = True
    has_particle_collision: bool = True
    is_visible: bool = True
    is_site: bool = False
    contype: int = 1
    conaffinity: int = 1
    # > 0: the resolution of a mesh shape's SDF bake (24 by default; 48 and
    # above bake a sparse texture)
    sdf_max_resolution: int = 0

    @property
    def flags(self) -> int:
        f = 0
        if self.is_visible:
            f |= int(ShapeFlags.VISIBLE)
        if self.has_shape_collision and not self.is_site:
            f |= int(ShapeFlags.COLLIDE_SHAPES)
        if self.has_particle_collision and not self.is_site:
            f |= int(ShapeFlags.COLLIDE_PARTICLES)
        if self.is_site:
            f |= int(ShapeFlags.SITE)
        return f

    def copy(self) -> "ShapeConfig":
        return dc_replace(self)

    def mark_as_site(self) -> "ShapeConfig":
        """A massless, non-colliding copy (the site configuration)."""
        cfg = dc_replace(self)
        cfg.is_site = True
        cfg.density = 0.0
        cfg.has_shape_collision = False
        cfg.has_particle_collision = False
        cfg.collision_group = 0
        return cfg


@dataclass
class JointDofConfig:
    """Per-dof joint configuration (same defaults as the JAX builder's)."""

    axis: AxisType = Axis.X
    limit_lower: float = -MAXVAL
    limit_upper: float = MAXVAL
    limit_ke: float = 1.0e4
    limit_kd: float = 1.0e1
    target: float = 0.0
    target_ke: float = 0.0
    target_kd: float = 0.0
    armature: float = 1.0e-2
    effort_limit: float = MAXVAL
    velocity_limit: float = MAXVAL
    friction: float = 0.0

    def copy(self) -> "JointDofConfig":
        return dc_replace(self)


class ModelBuilder:
    """Host-side scene construction.

        builder = ModelBuilder()
        builder.add_mjcf("ant.xml")
        model = builder.finalize(device="cuda")
    """

    def __init__(self, gravity: float = -9.81):
        self.gravity = float(gravity)      # along +Z (the port is Z-up)
        # worlds: entities added outside a world context are global (-1)
        self.world_count = 0
        self._current_world = -1
        self.world_key: List[str] = []
        self.world_gravity: List[np.ndarray] = []
        self.body_world: List[int] = []
        self.shape_world: List[int] = []
        self.joint_world: List[int] = []
        self.articulation_world: List[int] = []
        self.default_shape_cfg = ShapeConfig()
        self.default_site_cfg = ShapeConfig().mark_as_site()
        self.default_joint_cfg = JointDofConfig()
        self.mjc_options: Dict[str, object] = {}
        self.mjc_actuation = None

        self.body_q: List[np.ndarray] = []
        self.body_qd: List[np.ndarray] = []
        self.body_com: List[np.ndarray] = []
        self.body_mass: List[float] = []
        self.body_inertia: List[np.ndarray] = []
        self.body_flags: List[int] = []
        self.body_key: List[str] = []

        self.shape_transform: List[np.ndarray] = []
        self.shape_body: List[int] = []
        self.shape_type: List[int] = []
        self.shape_scale: List[np.ndarray] = []
        self.shape_flags: List[int] = []
        self.shape_thickness: List[float] = []
        self.shape_material_mu: List[float] = []
        self.shape_material_restitution: List[float] = []
        self.shape_collision_group: List[int] = []
        self.shape_contype: List[int] = []
        self.shape_conaffinity: List[int] = []
        self.shape_material_kh: List[float] = []
        self.shape_sdf_resolution: List[int] = []
        # Mesh, Heightfield or SDF sources of mesh-kind shapes (None else)
        self.shape_source: List[object] = []
        self.shape_key: List[str] = []
        self.shape_collision_filter_pairs: Set[Tuple[int, int]] = set()
        self._body_filter_pairs: Set[Tuple[int, int]] = set()

        self.joint_type: List[int] = []
        self.joint_parent: List[int] = []
        self.joint_child: List[int] = []
        self.joint_X_p: List[np.ndarray] = []
        self.joint_X_c: List[np.ndarray] = []
        self.joint_key: List[str] = []
        self.joint_q_start: List[int] = [0]
        self.joint_qd_start: List[int] = [0]
        self.joint_dof_dim: List[Tuple[int, int]] = []
        self.joint_axis: List[np.ndarray] = []
        self.joint_armature: List[float] = []
        self.joint_target_ke: List[float] = []
        self.joint_target_kd: List[float] = []
        self.joint_limit_lower: List[float] = []
        self.joint_limit_upper: List[float] = []
        self.joint_limit_ke: List[float] = []
        self.joint_limit_kd: List[float] = []
        self.joint_friction: List[float] = []
        self.joint_effort_limit: List[float] = []
        self.joint_velocity_limit: List[float] = []
        self.joint_qd: List[float] = []
        self.joint_q: List[float] = []
        self.joint_target_q: List[float] = []

        self.articulation_start: List[int] = []
        self.articulation_key: List[str] = []

        # fixed tendons: per entry a joint and the axis within it
        self.tendon_joints: List[List[int]] = []
        self.tendon_axes: List[List[int]] = []
        self.tendon_coefs: List[List[float]] = []
        self.tendon_params: List[Tuple[float, float, float]] = []  # ke,kd,L0
        self.tendon_key: List[str] = []
        # spatial tendons: site-routed paths with sphere/cylinder wraps
        # (ke, kd, L0; L0 NaN: the build-pose length at finalize)
        self.sten_paths: List[SpatialTendonPath] = []
        self.sten_params: List[Tuple[float, float, float]] = []
        self.sten_key: List[str] = []
        # waypoint muscles (SolverSemiImplicit): per muscle its first
        # waypoint and (f0, lm, lt, lmax, pen, passive_ke, passive_kd)
        self.muscle_start: List[int] = []
        self.muscle_params: List[Tuple[float, ...]] = []
        self.muscle_bodies: List[int] = []
        self.muscle_points: List[np.ndarray] = []

        # equality constraints: bodies (CONNECT, WELD) or joints (JOINT)
        self.eq_type: List[int] = []
        self.eq_obj1: List[int] = []
        self.eq_obj2: List[int] = []
        self.eq_anchor: List[np.ndarray] = []
        self.eq_relpose: List[np.ndarray] = []
        self.eq_polycoef: List[np.ndarray] = []
        self.eq_enabled: List[bool] = []
        self.eq_torquescale: List[float] = []
        self.eq_world: List[int] = []
        self.eq_key: List[str] = []

        # particles
        self.particle_q: List[np.ndarray] = []
        self.particle_qd: List[np.ndarray] = []
        self.particle_mass: List[float] = []
        self.particle_radius: List[float] = []
        self.particle_flags: List[int] = []
        self.particle_world: List[int] = []
        # particle and soft-contact materials carried onto the Model (the
        # JAX builder's defaults)
        self.soft_contact_ke = 1.0e3
        self.soft_contact_kd = 10.0
        self.soft_contact_kf = 1.0e3
        self.soft_contact_mu = 0.5
        self.soft_contact_margin = 0.2
        self.particle_ke = 1.0e3
        self.particle_kd = 1.0e2
        self.particle_kf = 1.0e2
        self.particle_mu = 0.5
        self.particle_max_velocity = 1.0e5
        # cloth and soft topology
        self.spring_indices: List[Tuple[int, int]] = []
        self.spring_rest_length: List[float] = []
        self.spring_stiffness: List[float] = []
        self.spring_damping: List[float] = []
        self.tri_indices: List[Tuple[int, int, int]] = []
        self.tri_poses: List[np.ndarray] = []
        self.tri_materials: List[Tuple[float, ...]] = []
        self.tri_areas: List[float] = []
        self.edge_indices: List[Tuple[int, int, int, int]] = []
        self.edge_rest_angle: List[float] = []
        self.edge_rest_length: List[float] = []
        self.edge_bending_properties: List[Tuple[float, float]] = []
        self.tet_indices: List[Tuple[int, int, int, int]] = []
        self.tet_poses: List[np.ndarray] = []
        self.tet_materials: List[Tuple[float, float, float]] = []

        # custom attributes: name -> (spec, {index: value})
        self.custom_attributes: Dict[str, Tuple[AttributeSpec, dict]] = {}

    # ------------------------------------------------------------------
    @property
    def body_count(self) -> int:
        return len(self.body_q)

    @property
    def shape_count(self) -> int:
        return len(self.shape_type)

    @property
    def joint_count(self) -> int:
        return len(self.joint_type)

    @property
    def joint_coord_count(self) -> int:
        return len(self.joint_q)

    @property
    def joint_dof_count(self) -> int:
        return len(self.joint_axis)

    @property
    def articulation_count(self) -> int:
        return len(self.articulation_start)

    @property
    def particle_count(self) -> int:
        return len(self.particle_q)

    @property
    def spring_count(self) -> int:
        return len(self.spring_indices)

    @property
    def tri_count(self) -> int:
        return len(self.tri_indices)

    @property
    def edge_count(self) -> int:
        return len(self.edge_indices)

    @property
    def tet_count(self) -> int:
        return len(self.tet_indices)

    @property
    def current_world(self) -> int:
        return self._current_world

    def _gravity_vec(self) -> np.ndarray:
        return np.array([0.0, 0.0, 1.0]) * self.gravity

    # ------------------------------------------------------------------
    # worlds (the JAX builder's begin_world/end_world/add_world/replicate)
    # ------------------------------------------------------------------
    def begin_world(self, key: Optional[str] = None, gravity=None) -> int:
        """Open a world scope; entities added until ``end_world`` belong
        to it. ``gravity`` (a 3-vector) overrides the builder's for this
        world."""
        if self._current_world != -1:
            raise RuntimeError(f"Already in world context "
                               f"{self._current_world}; call end_world() "
                               "first.")
        self._current_world = self.world_count
        self.world_count += 1
        self.world_key.append(key or f"world_{self._current_world}")
        self.world_gravity.append(
            self._gravity_vec() if gravity is None
            else np.asarray(gravity, dtype=np.float64))
        return self._current_world

    def end_world(self):
        if self._current_world == -1:
            raise RuntimeError("Not in a world context.")
        self._current_world = -1

    def add_world(self, builder: "ModelBuilder", xform=None,
                  key_prefix: Optional[str] = None) -> int:
        """Add a sub-builder as a new world."""
        w = self.begin_world()
        try:
            self.add_builder(builder, xform=xform, key_prefix=key_prefix)
        finally:
            self.end_world()
        return w

    def replicate(self, builder: "ModelBuilder", count: int,
                  spacing=None) -> None:
        """Add ``count`` copies of ``builder``, one world each. Without
        ``spacing`` (and outside a world scope) the copies merge in one
        vectorized pass; with it, world i is offset on a square grid."""
        if spacing is None and self._current_world == -1:
            self._replicate_bulk(builder, count)
            return
        for i in range(count):
            xform = None
            if spacing is not None:
                sp = np.asarray(spacing, dtype=np.float64)
                n = max(1, int(math.ceil(math.sqrt(count))))
                xform = np_transform(p=np.array(
                    [(i % n) * sp[0], (i // n) * sp[1], 0.0]))
            self.add_world(builder, xform=xform)

    def _replicate_bulk(self, o: "ModelBuilder", count: int) -> None:
        """``count`` copies of ``o`` in one pass, one world each: list
        repeats and offset arrays, no loop over the copies' entities."""
        w0, b0, s0 = self.world_count, self.body_count, self.shape_count
        j0, d0, q0 = (self.joint_count, self.joint_dof_count,
                      self.joint_coord_count)
        t0, p0 = len(self.tendon_params), self.particle_count
        nb, ns, nj = o.body_count, o.shape_count, o.joint_count
        na, npart = o.articulation_count, o.particle_count
        nd, nq = o.joint_dof_count, o.joint_coord_count
        worlds = np.arange(w0, w0 + count)

        def per_world(n):
            return np.repeat(worlds, n).tolist()

        def offset(lst, base, stride, keep_neg=True):
            a = np.asarray(lst, dtype=np.int64)
            out = a[None, :] + (base + stride * np.arange(count))[:, None]
            if keep_neg:
                out = np.where(a[None, :] >= 0, out, a[None, :])
            return out.reshape(-1).tolist()

        def copies(lst):
            return [x.copy() for _ in range(count) for x in lst]

        self.world_count += count
        self.world_key += [f"world_{w}" for w in worlds]
        self.world_gravity += [self._gravity_vec() for _ in range(count)]
        # bodies
        self.body_q += copies(o.body_q)
        self.body_qd += copies(o.body_qd)
        self.body_com += copies(o.body_com)
        self.body_inertia += copies(o.body_inertia)
        self.body_mass += list(o.body_mass) * count
        self.body_flags += list(o.body_flags) * count
        self.body_key += list(o.body_key) * count
        self.body_world += per_world(nb)
        # shapes
        self.shape_transform += copies(o.shape_transform)
        self.shape_scale += copies(o.shape_scale)
        self.shape_body += offset(o.shape_body, b0, nb)
        for name in ("shape_type", "shape_flags", "shape_thickness",
                     "shape_material_mu", "shape_material_restitution",
                     "shape_collision_group", "shape_contype",
                     "shape_conaffinity", "shape_material_kh",
                     "shape_sdf_resolution", "shape_source", "shape_key"):
            getattr(self, name).extend(list(getattr(o, name)) * count)
        self.shape_world += per_world(ns)
        for mine, theirs, base, stride in (
                (self.shape_collision_filter_pairs,
                 o.shape_collision_filter_pairs, s0, ns),
                (self._body_filter_pairs, o._body_filter_pairs, b0, nb)):
            if theirs:
                pr = np.asarray(sorted(theirs), dtype=np.int64)
                off = (base + stride * np.arange(count))[:, None, None]
                mine.update(map(tuple, (pr[None] + off).reshape(-1, 2)
                                .tolist()))
        # articulations
        self.articulation_start += offset(o.articulation_start, j0, nj)
        self.articulation_key += list(o.articulation_key) * count
        self.articulation_world += per_world(na)
        # joints
        self.joint_type += list(o.joint_type) * count
        self.joint_parent += offset(o.joint_parent, b0, nb)
        self.joint_child += offset(o.joint_child, b0, nb)
        self.joint_X_p += copies(o.joint_X_p)
        self.joint_X_c += copies(o.joint_X_c)
        self.joint_key += list(o.joint_key) * count
        self.joint_world += per_world(nj)
        self.joint_dof_dim += list(o.joint_dof_dim) * count
        self.joint_q_start += offset(o.joint_q_start[1:], q0, nq,
                                     keep_neg=False)
        self.joint_qd_start += offset(o.joint_qd_start[1:], d0, nd,
                                      keep_neg=False)
        self.joint_axis += copies(o.joint_axis)
        for name in _DOF_LISTS + ("joint_q", "joint_target_q"):
            getattr(self, name).extend(list(getattr(o, name)) * count)
        # fixed tendons
        for i in range(count):
            joff = j0 + i * nj
            self.tendon_joints += [[j + joff for j in js]
                                   for js in o.tendon_joints]
        self.tendon_axes += [list(a) for _ in range(count)
                             for a in o.tendon_axes]
        self.tendon_coefs += [list(c) for _ in range(count)
                              for c in o.tendon_coefs]
        self.tendon_params += list(o.tendon_params) * count
        self.tendon_key += list(o.tendon_key) * count
        s0 = len(self.sten_params)
        for i in range(count):
            self._copy_sten_muscles(o, b0 + i * nb)
        # particles
        self.particle_q += copies(o.particle_q)
        self.particle_qd += copies(o.particle_qd)
        self.particle_mass += list(o.particle_mass) * count
        self.particle_radius += list(o.particle_radius) * count
        self.particle_flags += list(o.particle_flags) * count
        self.particle_world += per_world(npart)
        self._copy_topology(o, p0, npart, count)
        self._merge_mjcf_data(o, count, d0, q0, t0, s0)
        self._copy_equalities(o, count, j0, b0, worlds)

    def add_builder(self, other: "ModelBuilder", xform=None,
                    key_prefix: Optional[str] = None) -> None:
        """Merge another builder's entities into this one, offsetting
        indices; they take this builder's current world. ``xform`` moves
        the merged bodies, static shapes and root joints."""
        X = None if xform is None else _as_transform(xform)
        pre = key_prefix + "/" if key_prefix else ""
        w = self._current_world
        b0, s0, j0 = self.body_count, self.shape_count, self.joint_count
        d0, q0 = self.joint_dof_count, self.joint_coord_count
        t0 = len(self.tendon_params)

        def moved(t, moves=True):
            return np_transform_multiply(X, t) if X is not None and moves \
                else t.copy()
        # bodies
        self.body_q += [moved(t) for t in other.body_q]
        self.body_qd += [v.copy() for v in other.body_qd]
        self.body_com += [v.copy() for v in other.body_com]
        self.body_inertia += [v.copy() for v in other.body_inertia]
        self.body_mass += list(other.body_mass)
        self.body_flags += list(other.body_flags)
        self.body_key += [pre + k for k in other.body_key]
        self.body_world += [w] * other.body_count
        # shapes
        self.shape_transform += [moved(t, b < 0) for t, b in
                                 zip(other.shape_transform, other.shape_body)]
        self.shape_scale += [v.copy() for v in other.shape_scale]
        self.shape_body += [b + b0 if b >= 0 else -1
                            for b in other.shape_body]
        for name in ("shape_type", "shape_flags", "shape_thickness",
                     "shape_material_mu", "shape_material_restitution",
                     "shape_collision_group", "shape_contype",
                     "shape_conaffinity", "shape_material_kh",
                     "shape_sdf_resolution", "shape_source"):
            getattr(self, name).extend(getattr(other, name))
        self.shape_key += [pre + k for k in other.shape_key]
        self.shape_world += [w] * other.shape_count
        self.shape_collision_filter_pairs.update(
            (a + s0, b + s0) for a, b in other.shape_collision_filter_pairs)
        self._body_filter_pairs.update(
            (a + b0, b + b0) for a, b in other._body_filter_pairs)
        # articulations
        self.articulation_start += [a + j0 for a in other.articulation_start]
        self.articulation_key += [pre + k for k in other.articulation_key]
        self.articulation_world += [w] * other.articulation_count
        # joints
        self.joint_type += list(other.joint_type)
        self.joint_parent += [p + b0 if p >= 0 else -1
                              for p in other.joint_parent]
        self.joint_child += [c + b0 for c in other.joint_child]
        self.joint_X_p += [moved(t, p < 0) for t, p in
                           zip(other.joint_X_p, other.joint_parent)]
        self.joint_X_c += [t.copy() for t in other.joint_X_c]
        self.joint_key += [pre + k for k in other.joint_key]
        self.joint_world += [w] * other.joint_count
        self.joint_dof_dim += list(other.joint_dof_dim)
        self.joint_q_start += [q0 + x for x in other.joint_q_start[1:]]
        self.joint_qd_start += [d0 + x for x in other.joint_qd_start[1:]]
        self.joint_axis += [a.copy() for a in other.joint_axis]
        for name in _DOF_LISTS + ("joint_q", "joint_target_q"):
            getattr(self, name).extend(getattr(other, name))
        if X is not None:
            # free root coordinates are world poses: move them too
            for i, (t, p) in enumerate(zip(other.joint_type,
                                           other.joint_parent)):
                if t == int(JointType.FREE) and p < 0:
                    qs = self.joint_q_start[j0 + i]
                    pose = np_transform_multiply(
                        X, np.asarray(self.joint_q[qs:qs + 7]))
                    self.joint_q[qs:qs + 7] = pose.tolist()
                    self.joint_target_q[qs:qs + 7] = pose.tolist()
        # fixed tendons
        self.tendon_joints += [[j + j0 for j in js]
                               for js in other.tendon_joints]
        self.tendon_axes += [list(a) for a in other.tendon_axes]
        self.tendon_coefs += [list(c) for c in other.tendon_coefs]
        self.tendon_params += list(other.tendon_params)
        self.tendon_key += [pre + k for k in other.tendon_key]
        s0 = len(self.sten_params)
        self._copy_sten_muscles(other, b0, pre)
        # particles
        p0 = self.particle_count
        for p, v in zip(other.particle_q, other.particle_qd):
            self.particle_q.append(np.asarray(p) if X is None
                                   else np_transform_point(X, p))
            self.particle_qd.append(np.asarray(v) if X is None
                                    else np_transform_vector(X, v))
        self.particle_mass += list(other.particle_mass)
        self.particle_radius += list(other.particle_radius)
        self.particle_flags += list(other.particle_flags)
        self.particle_world += [w] * other.particle_count
        self._copy_topology(other, p0, other.particle_count, 1)
        self._merge_mjcf_data(other, 1, d0, q0, t0, s0)
        self._copy_equalities(other, 1, j0, b0, [w], pre)

    def _copy_sten_muscles(self, o: "ModelBuilder", boff: int,
                           pre: str = "") -> None:
        """One copy of ``o``'s spatial tendons and muscles, its bodies
        offset by ``boff`` (the world's -1 stays)."""
        for path, prm, k in zip(o.sten_paths, o.sten_params, o.sten_key):
            self.sten_paths.append(path.remapped(lambda b: b + boff))
            self.sten_params.append(prm)
            self.sten_key.append(pre + k)
        ends = list(o.muscle_start[1:]) + [len(o.muscle_bodies)]
        for mi, (s, e) in enumerate(zip(o.muscle_start, ends)):
            self.muscle_start.append(len(self.muscle_bodies))
            self.muscle_params.append(o.muscle_params[mi])
            for w in range(s, e):
                mb = o.muscle_bodies[w]
                self.muscle_bodies.append(mb + boff if mb >= 0 else -1)
                self.muscle_points.append(o.muscle_points[w].copy())

    def _copy_topology(self, o: "ModelBuilder", p0: int, npart: int,
                       count: int) -> None:
        """``count`` copies of ``o``'s springs, triangles, bending edges
        and tetrahedra, copy i's particle indices offset by p0 + i npart;
        a -1 wing stays -1."""
        def rows(table, width):
            a = np.asarray(table, dtype=np.int64).reshape(-1, width)
            out = a[None] + (p0 + npart * np.arange(count))[:, None, None]
            out = np.where(a[None] >= 0, out, a[None])
            return [tuple(r) for r in out.reshape(-1, width).tolist()]

        def copies(lst):
            return [x.copy() for _ in range(count) for x in lst]
        self.spring_indices += rows(o.spring_indices, 2)
        self.tri_indices += rows(o.tri_indices, 3)
        self.edge_indices += rows(o.edge_indices, 4)
        self.tet_indices += rows(o.tet_indices, 4)
        for name in ("spring_rest_length", "spring_stiffness",
                     "spring_damping", "tri_materials", "tri_areas",
                     "edge_rest_angle", "edge_rest_length",
                     "edge_bending_properties", "tet_materials"):
            getattr(self, name).extend(list(getattr(o, name)) * count)
        self.tri_poses += copies(o.tri_poses)
        self.tet_poses += copies(o.tet_poses)

    def _merge_mjcf_data(self, o: "ModelBuilder", count: int, d0: int,
                         q0: int, t0: int, s0: int = 0) -> None:
        """Custom attributes, MJCF options and actuator tables of ``count``
        copies of ``o`` whose dofs, coordinates and tendons start at d0,
        q0 and t0. Each copy's actuators drive that copy's dofs, and
        ``mjc:ctrl`` grows to one entry per actuator of the merged model
        (the flat ``(N * A,)`` layout)."""
        nd, nq = o.joint_dof_count, o.joint_coord_count
        ks = np.arange(count)
        for name, (spec, values) in o.custom_attributes.items():
            self.add_custom_attribute(name, spec.frequency, spec.shape,
                                      spec.assignment, spec.default)
            base, stride = {AttributeFrequency.JOINT_DOF: (d0, nd),
                            AttributeFrequency.JOINT_COORD: (q0, nq)}.get(
                                spec.frequency, (0, 0))
            mine = self.custom_attributes[name][1]
            for k, v in values.items():
                mine.update(dict.fromkeys((base + stride * ks + k).tolist(),
                                          v))
        for k, v in o.mjc_options.items():
            self.mjc_options.setdefault(k, v)
        au = o.mjc_actuation
        if au is None or au.n == 0:
            return
        nt, ns = len(o.tendon_params), len(o.sten_params)
        rep = MJCActuation(au.n * count)
        for name, base, stride in (("dof", d0, nd), ("coord", q0, nq),
                                   ("tendon", t0, nt), ("sten", s0, ns)):
            a = np.asarray(getattr(au, name))
            off = (base + stride * ks)[:, None] + a[None, :]
            setattr(rep, name, np.where(a[None, :] >= 0, off, a[None, :])
                    .reshape(-1).astype(np.int32))
        for name in _ACTUATION_TABLES:
            a = np.asarray(getattr(au, name))
            setattr(rep, name, np.tile(a, (count,) + (1,) * (a.ndim - 1)))
        if self.mjc_actuation is not None and self.mjc_actuation.n:
            prev, merged = self.mjc_actuation, MJCActuation(
                self.mjc_actuation.n + rep.n)
            for name in ("dof", "coord", "tendon", "sten") + \
                    _ACTUATION_TABLES:
                setattr(merged, name, np.concatenate(
                    [getattr(prev, name), getattr(rep, name)]))
            rep = merged
        self.mjc_actuation = rep.finish()
        for key in ("mjc:ctrl", "mjc:act"):
            if key in self.custom_attributes:
                spec, values = self.custom_attributes[key]
                self.custom_attributes[key] = (
                    dc_replace(spec, shape=(rep.n,)), values)

    # ------------------------------------------------------------------
    # bodies, articulations, joints
    # ------------------------------------------------------------------
    def add_body(self, xform=None, com=None, I_m=None, mass: float = 0.0,
                 key: Optional[str] = None, qd=None,
                 kinematic: bool = False) -> int:
        """Add a rigid body; mass and inertia accumulate from shapes. ``qd``
        is its initial twist [v_com, w] (world frame). A ``kinematic`` body
        (``BodyFlags.KINEMATIC``) gets a zero inverse mass and inertia at
        ``finalize``: no force moves it, and a body without a joint keeps
        ``qd`` as the velocity of a moving support (a conveyor belt)."""
        idx = self.body_count
        self.body_q.append(_as_transform(xform))
        self.body_qd.append(np.zeros(6) if qd is None
                            else np.asarray(qd, dtype=np.float64))
        self.body_com.append(np.zeros(3) if com is None
                             else np.asarray(com, dtype=np.float64))
        self.body_mass.append(float(mass))
        self.body_inertia.append(np.zeros((3, 3)) if I_m is None
                                 else np.asarray(I_m, dtype=np.float64))
        self.body_flags.append(int(BodyFlags.KINEMATIC) if kinematic
                               else int(BodyFlags.NONE))
        self.body_key.append(key or f"body_{idx}")
        self.body_world.append(self._current_world)
        return idx

    def add_articulation(self, key: Optional[str] = None) -> int:
        idx = self.articulation_count
        self.articulation_start.append(self.joint_count)
        self.articulation_key.append(key or f"articulation_{idx}")
        self.articulation_world.append(self._current_world)
        return idx

    def add_joint(self, joint_type: JointType, parent: int, child: int,
                  linear_axes: Optional[Sequence[JointDofConfig]] = None,
                  angular_axes: Optional[Sequence[JointDofConfig]] = None,
                  xform_p=None, xform_c=None, key: Optional[str] = None,
                  collision_filter_parent: bool = True) -> int:
        """Free, revolute, prismatic, fixed, ball, D6, distance or cable
        joint between ``parent`` (-1 = world) and ``child``. A prismatic
        joint takes one linear axis, a D6 joint 0-3 linear and 0-3 angular
        axes (at least one), each a dof with its own limits, armature and
        gains. A D6 joint's linear dofs and coordinates come first, then its
        angular ones: it translates along its linear axes in the
        parent-anchor frame, then rotates about the translated anchor. A
        distance joint has a free joint's six dofs and seven coordinates
        (its config's limits on all six); a cable joint six dofs (three
        linear, three angular configs) and no coordinates."""
        joint_type = JointType(joint_type)
        if joint_type not in _JOINT_TYPES:
            raise NotImplementedError(
                f"joint type {joint_type.name} is not ported yet")
        linear = list(linear_axes or [])
        angular = list(angular_axes or [])
        if linear and joint_type not in (JointType.PRISMATIC, JointType.D6,
                                         JointType.DISTANCE,
                                         JointType.CABLE):
            raise ValueError(f"a {joint_type.name} joint takes no linear "
                             "axes")
        if joint_type == JointType.PRISMATIC and (len(linear) != 1
                                                  or angular):
            raise ValueError("a prismatic joint takes exactly one linear "
                             "axis")
        axes = linear + angular
        if joint_type == JointType.REVOLUTE and len(axes) != 1:
            raise ValueError("a revolute joint takes exactly one axis")
        if joint_type == JointType.D6 and not (
                len(linear) <= 3 and len(angular) <= 3 and axes):
            raise ValueError("a D6 joint takes 0-3 linear and 0-3 angular "
                             "axes, at least one")
        if joint_type == JointType.FIXED:
            linear, angular, axes = [], [], []
        if joint_type == JointType.BALL and (linear or len(angular) > 1):
            raise ValueError("a ball joint takes at most one angular dof "
                             "config, applied to its three dofs")
        if joint_type == JointType.CABLE and (len(linear) != 3
                                              or len(angular) != 3):
            raise ValueError("a cable joint takes three linear and three "
                             "angular axes")
        dof_count, coord_count = joint_type.dof_count(len(axes))

        idx = self.joint_count
        if self.articulation_count == 0:
            self.add_articulation()
        self.joint_type.append(int(joint_type))
        self.joint_parent.append(int(parent))
        self.joint_child.append(int(child))
        self.joint_X_p.append(_as_transform(xform_p))
        self.joint_X_c.append(_as_transform(xform_c))
        self.joint_key.append(key or f"joint_{idx}")
        self.joint_world.append(self._current_world)
        self.joint_dof_dim.append((len(linear), len(angular)))

        if joint_type in (JointType.FREE, JointType.DISTANCE):
            base = axes[0] if axes else self.default_joint_cfg
            canon = [np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
                     np.array([0, 0, 1.0])]
            for a in canon * 2:
                self._append_dof(base, axis_override=a)
            # initial coords: child pose relative to the parent anchor
            X_wp = (self.body_q[parent] if parent >= 0
                    else np_transform_identity())
            X_wp = np_transform_multiply(X_wp, self.joint_X_p[idx])
            X_wc = np_transform_multiply(self.body_q[child],
                                         self.joint_X_c[idx])
            rel = np_transform_multiply(np_transform_inverse(X_wp), X_wc)
            self.joint_q.extend(rel.tolist())
            self.joint_target_q.extend(rel.tolist())
        elif joint_type == JointType.BALL:
            # three angular dofs about the canonical axes of the joint-parent
            # frame, one config for all; the coordinate is a quaternion
            base = axes[0] if axes else self.default_joint_cfg
            for a in np.eye(3):
                self._append_dof(base, axis_override=a)
            self.joint_q.extend([0.0, 0.0, 0.0, 1.0])
            self.joint_target_q.extend([0.0, 0.0, 0.0, 1.0])
        elif joint_type == JointType.CABLE:
            # six constraint dofs, no coordinate: the maximal-coordinate
            # solvers integrate the segments' transforms directly
            for cfg in axes:
                self._append_dof(cfg)
        else:
            for cfg in axes:
                self._append_dof(cfg)
                self.joint_q.append(float(cfg.target) if cfg.target_ke > 0
                                    else 0.0)
                self.joint_target_q.append(float(cfg.target))

        self.joint_q_start.append(self.joint_q_start[-1] + coord_count)
        self.joint_qd_start.append(self.joint_qd_start[-1] + dof_count)
        if collision_filter_parent and parent >= 0:
            self._filter_body_pair(parent, child)
        return idx

    def _append_dof(self, cfg: JointDofConfig, axis_override=None):
        axis = axis_override if axis_override is not None \
            else axis_to_vec3(cfg.axis)
        self.joint_axis.append(np.asarray(axis, dtype=np.float64))
        self.joint_armature.append(float(cfg.armature))
        self.joint_target_ke.append(float(cfg.target_ke))
        self.joint_target_kd.append(float(cfg.target_kd))
        self.joint_limit_lower.append(float(cfg.limit_lower))
        self.joint_limit_upper.append(float(cfg.limit_upper))
        self.joint_limit_ke.append(float(cfg.limit_ke))
        self.joint_limit_kd.append(float(cfg.limit_kd))
        self.joint_friction.append(float(cfg.friction))
        self.joint_effort_limit.append(float(cfg.effort_limit))
        self.joint_velocity_limit.append(float(cfg.velocity_limit))
        self.joint_qd.append(0.0)

    def _dof_cfg(self, axis: AxisType, **kwargs) -> JointDofConfig:
        """The builder's default dof config with ``axis`` and every
        keyword that is not None."""
        cfg = self.default_joint_cfg.copy()
        cfg.axis = axis
        for k, v in kwargs.items():
            if v is not None:
                setattr(cfg, k, v)
        return cfg

    def add_joint_revolute(self, parent: int, child: int, xform_p=None,
                           xform_c=None, axis: AxisType = Axis.X,
                           key: Optional[str] = None,
                           collision_filter_parent: bool = True,
                           **dof) -> int:
        """Revolute (hinge) joint; ``dof`` takes the JointDofConfig fields
        (target, target_ke, limit_lower, armature, ...)."""
        return self.add_joint(JointType.REVOLUTE, parent, child,
                              angular_axes=[self._dof_cfg(axis, **dof)],
                              xform_p=xform_p, xform_c=xform_c, key=key,
                              collision_filter_parent=collision_filter_parent)

    def add_joint_prismatic(self, parent: int, child: int, axis: AxisType
                            = Axis.X, xform_p=None, xform_c=None,
                            key: Optional[str] = None,
                            collision_filter_parent: bool = True,
                            **dof) -> int:
        """Prismatic (slider) joint along ``axis``; ``dof`` takes the
        JointDofConfig fields (target, limit_lower, armature, ...)."""
        return self.add_joint(JointType.PRISMATIC, parent, child,
                              linear_axes=[self._dof_cfg(axis, **dof)],
                              xform_p=xform_p, xform_c=xform_c, key=key,
                              collision_filter_parent=collision_filter_parent)

    def add_joint_d6(self, parent: int, child: int,
                     linear_axes: Optional[Sequence[JointDofConfig]] = None,
                     angular_axes: Optional[Sequence[JointDofConfig]] = None,
                     xform_p=None, xform_c=None, key: Optional[str] = None,
                     collision_filter_parent: bool = True) -> int:
        """D6 joint with explicit linear and angular dof axes (see
        ``add_joint``)."""
        return self.add_joint(JointType.D6, parent, child,
                              linear_axes=linear_axes,
                              angular_axes=angular_axes, xform_p=xform_p,
                              xform_c=xform_c, key=key,
                              collision_filter_parent=collision_filter_parent)

    def add_joint_fixed(self, parent: int, child: int, xform_p=None,
                        xform_c=None, key: Optional[str] = None) -> int:
        return self.add_joint(JointType.FIXED, parent, child,
                              xform_p=xform_p, xform_c=xform_c, key=key)

    def add_joint_ball(self, parent: int, child: int, xform_p=None,
                       xform_c=None, armature: Optional[float] = None,
                       key: Optional[str] = None,
                       collision_filter_parent: bool = True) -> int:
        """Ball (spherical) joint: three angular dofs in the joint-parent
        frame and a unit quaternion coordinate (xyzw)."""
        cfg = self._dof_cfg(Axis.X, armature=armature)
        return self.add_joint(JointType.BALL, parent, child,
                              angular_axes=[cfg], xform_p=xform_p,
                              xform_c=xform_c, key=key,
                              collision_filter_parent=collision_filter_parent)

    def add_joint_free(self, child: int, parent: int = -1, xform_p=None,
                       xform_c=None, armature: Optional[float] = None,
                       key: Optional[str] = None) -> int:
        cfg = self.default_joint_cfg.copy()
        cfg.armature = 0.0 if armature is None else armature
        return self.add_joint(JointType.FREE, parent, child,
                              angular_axes=[cfg], xform_p=xform_p,
                              xform_c=xform_c, key=key)

    def add_joint_distance(self, parent: int, child: int,
                           min_distance: float = -1.0,
                           max_distance: float = 1.0, xform_p=None,
                           xform_c=None, key: Optional[str] = None,
                           collision_filter_parent: bool = True) -> int:
        """Distance joint: a free joint's dofs and coordinates, its limits
        ``min_distance``/``max_distance`` on every dof (the JAX builder's
        ``add_joint_distance``; SolverXPBD leaves it unconstrained, as the
        JAX package does)."""
        cfg = self.default_joint_cfg.copy()
        cfg.limit_lower = float(min_distance)
        cfg.limit_upper = float(max_distance)
        return self.add_joint(JointType.DISTANCE, parent, child,
                              linear_axes=[cfg], xform_p=xform_p,
                              xform_c=xform_c, key=key,
                              collision_filter_parent=collision_filter_parent)

    def add_joint_cable(self, parent: int, child: int, xform_p=None,
                        xform_c=None, stretch_stiffness: float = 1.0e5,
                        stretch_damping: float = 0.0,
                        shear_stiffness: Optional[float] = None,
                        shear_damping: Optional[float] = None,
                        bend_stiffness: float = 0.0,
                        bend_damping: float = 0.0,
                        twist_stiffness: Optional[float] = None,
                        twist_damping: Optional[float] = None,
                        key: Optional[str] = None,
                        collision_filter_parent: bool = True) -> int:
        """Cable (Cosserat rod) joint (the JAX builder's
        ``add_joint_cable``): six dofs whose drive gains hold the split
        stiffness and damping in the order [shear_x, shear_y, stretch_z,
        bend_x, bend_y, twist_z], each anchor's local +Z the material
        tangent; no coordinates (SolverXPBD integrates the segments).
        Shear defaults to the stretch values, twist to the bend values."""
        if shear_stiffness is None and shear_damping is None:
            shear_stiffness, shear_damping = stretch_stiffness, \
                stretch_damping
        shear_stiffness = (stretch_stiffness if shear_stiffness is None
                           else shear_stiffness)
        shear_damping = 0.0 if shear_damping is None else shear_damping
        if twist_stiffness is None and twist_damping is None:
            twist_stiffness, twist_damping = bend_stiffness, bend_damping
        twist_stiffness = (bend_stiffness if twist_stiffness is None
                           else twist_stiffness)
        twist_damping = 0.0 if twist_damping is None else twist_damping

        def cfg(axis, ke, kd):
            return JointDofConfig(axis=axis, target_ke=float(ke),
                                  target_kd=float(kd), armature=0.0)
        lin = [cfg(Axis.X, shear_stiffness, shear_damping),
               cfg(Axis.Y, shear_stiffness, shear_damping),
               cfg(Axis.Z, stretch_stiffness, stretch_damping)]
        ang = [cfg(Axis.X, bend_stiffness, bend_damping),
               cfg(Axis.Y, bend_stiffness, bend_damping),
               cfg(Axis.Z, twist_stiffness, twist_damping)]
        return self.add_joint(JointType.CABLE, parent, child,
                              linear_axes=lin, angular_axes=ang,
                              xform_p=xform_p, xform_c=xform_c, key=key,
                              collision_filter_parent=collision_filter_parent)

    def add_tendon_fixed(self, joints: Sequence[int],
                         coefs: Sequence[float], stiffness: float = 0.0,
                         damping: float = 0.0, rest_length: float = 0.0,
                         key: Optional[str] = None,
                         axes: Optional[Sequence[int]] = None) -> int:
        """Fixed tendon: length L = sum coef_i * q_i. Passive force
        -ke (L - L0) - kd Ldot plus ``control.tendon_f`` maps back to the
        dofs as tau_i += coef_i * f (the JAX builder's signature).

        Entry i is axis ``axes[i]`` (default 0) of joint ``joints[i]``; a
        joint with more than one dof needs its axis named, since its first
        coordinate is not the hinge an MJCF tendon names."""
        joints = [int(j) for j in joints]
        named = axes is not None
        axes = [int(a) for a in axes] if named else [0] * len(joints)
        if len(coefs) != len(joints) or len(axes) != len(joints):
            raise ValueError("add_tendon_fixed: joints, coefs and axes "
                             "differ in length")
        for j, a in zip(joints, axes):
            n = self.joint_qd_start[j + 1] - self.joint_qd_start[j]
            if (n > 1 and not named) or not 0 <= a < n:
                raise ValueError(f"add_tendon_fixed: joint {j} has {n} "
                                 f"dofs; name the axis of each entry")
        idx = len(self.tendon_params)
        self.tendon_joints.append(joints)
        self.tendon_axes.append(axes)
        self.tendon_coefs.append([float(c) for c in coefs])
        self.tendon_params.append((float(stiffness), float(damping),
                                   float(rest_length)))
        self.tendon_key.append(key or f"tendon_{idx}")
        return idx

    def add_equality_constraint(
            self, constraint_type: EqType, body1: int = -1, body2: int = -1,
            joint1: int = -1, joint2: int = -1,
            anchor=(0.0, 0.0, 0.0), relpose=None,
            polycoef: Sequence[float] = (0.0, 1.0, 0.0, 0.0, 0.0),
            torquescale: float = 1.0, enabled: bool = True,
            key: Optional[str] = None) -> int:
        """A CONNECT or WELD constraint between two bodies (-1: the world;
        ``anchor`` in body1's frame, ``relpose`` body1's pose relative to
        body2 for a WELD), or a JOINT constraint q1 = poly(q2) between the
        first coordinates of two joints (``polycoef`` c0..c4; joint2 -1:
        q1 = c0). The JAX builder's signature."""
        ct = EqType(constraint_type)
        idx = len(self.eq_type)
        if ct == EqType.JOINT:
            obj1, obj2 = int(joint1), int(joint2)
        else:
            obj1, obj2 = int(body1), int(body2)
        pc = np.zeros(5)
        pc[:len(polycoef)] = np.asarray(polycoef, dtype=np.float64)[:5]
        self.eq_type.append(int(ct))
        self.eq_obj1.append(obj1)
        self.eq_obj2.append(obj2)
        self.eq_anchor.append(np.asarray(anchor, dtype=np.float64))
        self.eq_relpose.append(_as_transform(relpose))
        self.eq_polycoef.append(pc)
        self.eq_enabled.append(bool(enabled))
        self.eq_torquescale.append(float(torquescale))
        self.eq_world.append(self._current_world)
        self.eq_key.append(key or f"equality_{idx}")
        return idx

    def add_constraint_mimic(self, joint1: int, joint2: int,
                             multiplier: float = 1.0, offset: float = 0.0,
                             enabled: bool = True,
                             key: Optional[str] = None) -> int:
        """Mimic constraint: q1 = offset + multiplier * q2 (a JOINT
        equality constraint)."""
        return self.add_equality_constraint(
            EqType.JOINT, joint1=joint1, joint2=joint2,
            polycoef=(offset, multiplier, 0.0, 0.0, 0.0), enabled=enabled,
            key=key)

    def _copy_equalities(self, o: "ModelBuilder", count: int, j0: int,
                         b0: int, worlds, pre: str = "") -> None:
        """``count`` copies of ``o``'s equality constraints: copy i's
        objects move by j0 + i * joints (JOINT) or b0 + i * bodies, and
        take world ``worlds[i]``."""
        ne = len(o.eq_type)
        if not ne:
            return
        typ = np.asarray(o.eq_type)
        is_joint = typ == int(EqType.JOINT)
        step = np.where(is_joint, o.joint_count, o.body_count)
        base = np.where(is_joint, j0, b0)
        for name in ("eq_obj1", "eq_obj2"):
            a = np.asarray(getattr(o, name), dtype=np.int64)
            out = (a[None] + base[None] + step[None]
                   * np.arange(count)[:, None])
            getattr(self, name).extend(
                np.where(a[None] >= 0, out, -1).reshape(-1).tolist())
        self.eq_type += list(o.eq_type) * count
        for name in ("eq_anchor", "eq_relpose", "eq_polycoef"):
            getattr(self, name).extend(x.copy() for _ in range(count)
                                       for x in getattr(o, name))
        self.eq_enabled += list(o.eq_enabled) * count
        self.eq_torquescale += list(o.eq_torquescale) * count
        self.eq_world += np.repeat(np.asarray(worlds), ne).tolist()
        self.eq_key += [pre + k for k in o.eq_key] * count

    def _filter_body_pair(self, body_a: int, body_b: int):
        """Disable collision between every shape of two bodies."""
        shapes_a = [s for s, b in enumerate(self.shape_body) if b == body_a]
        shapes_b = [s for s, b in enumerate(self.shape_body) if b == body_b]
        for sa in shapes_a:
            for sb in shapes_b:
                self.shape_collision_filter_pairs.add((min(sa, sb),
                                                       max(sa, sb)))
        self._body_filter_pairs.add((min(body_a, body_b),
                                     max(body_a, body_b)))

    # ------------------------------------------------------------------
    # shapes
    # ------------------------------------------------------------------
    def add_shape(self, body: int, geo_type: GeoType, xform=None,
                  scale=(1.0, 1.0, 1.0), cfg: Optional[ShapeConfig] = None,
                  key: Optional[str] = None, source=None) -> int:
        """Collision shape attached to ``body`` (-1 = static); ``source``
        is a mesh kind's Mesh, Heightfield or SDF."""
        geo_type = GeoType(geo_type)
        if geo_type not in _SHAPE_MASS:
            raise NotImplementedError(
                f"shape type {geo_type.name} is not ported yet")
        cfg = cfg or self.default_shape_cfg
        idx = self.shape_count
        self.shape_transform.append(_as_transform(xform))
        self.shape_body.append(int(body))
        self.shape_type.append(int(geo_type))
        self.shape_scale.append(np.asarray(scale, dtype=np.float64))
        self.shape_flags.append(cfg.flags)
        self.shape_thickness.append(float(cfg.thickness))
        self.shape_material_mu.append(float(cfg.mu))
        self.shape_material_restitution.append(float(cfg.restitution))
        self.shape_collision_group.append(int(cfg.collision_group))
        self.shape_contype.append(int(cfg.contype))
        self.shape_conaffinity.append(int(cfg.conaffinity))
        self.shape_material_kh.append(float(cfg.kh))
        self.shape_sdf_resolution.append(int(cfg.sdf_max_resolution))
        self.shape_source.append(source)
        self.shape_key.append(key or f"shape_{idx}")
        self.shape_world.append(self._current_world)

        mass_of = _SHAPE_MASS[geo_type]
        if geo_type in (GeoType.MESH, GeoType.CONVEX):
            def mass_of(rho, sc):
                return mesh_mass(source, rho, sc)
        if body >= 0 and cfg.density > 0.0 and mass_of is not None:
            m, c, I = mass_of(cfg.density, self.shape_scale[idx])
            if m > 0.0:
                self._update_body_mass(body, m, I, c,
                                       self.shape_transform[idx])
        return idx

    def _update_body_mass(self, body: int, m: float, I: np.ndarray,
                          com: np.ndarray, shape_xform: np.ndarray):
        """Accumulate a shape's mass properties into its body."""
        p_com = np_transform_point(shape_xform, com)
        R = np.asarray([np_transform_vector(shape_xform, e)
                        for e in np.eye(3)]).T
        I_body = R @ I @ R.T
        m0 = self.body_mass[body]
        c0 = self.body_com[body]
        I0 = self.body_inertia[body]
        m1 = m0 + m
        c1 = (m0 * c0 + m * p_com) / m1
        ident = np.array([0.0, 0.0, 0.0, 1.0])
        I0s = transform_inertia(m0, I0, c0 - c1, ident)
        I1s = transform_inertia(m, I_body, p_com - c1, ident)
        self.body_mass[body] = m1
        self.body_com[body] = c1
        self.body_inertia[body] = I0s + I1s

    def add_site(self, body: int, xform=None, key: Optional[str] = None,
                 cfg: Optional[ShapeConfig] = None) -> int:
        """A massless, non-colliding frame marker on ``body`` (-1: the
        world): a ``GeoType.NONE`` shape that the static pipeline gives no
        contact slot."""
        return self.add_shape(body, GeoType.NONE, xform,
                              cfg=cfg or self.default_site_cfg, key=key)

    def add_shape_plane(self, body: int = -1, xform=None,
                        width: float = 10.0, length: float = 10.0,
                        cfg: Optional[ShapeConfig] = None,
                        key: Optional[str] = None) -> int:
        """Plane with +Z normal in the shape frame."""
        return self.add_shape(body, GeoType.PLANE, xform,
                              scale=(width, length, 0.0), cfg=cfg, key=key)

    def add_ground_plane(self, cfg: Optional[ShapeConfig] = None,
                         key: Optional[str] = None) -> int:
        return self.add_shape(-1, GeoType.PLANE, np_transform(),
                              scale=(0.0, 0.0, 0.0), cfg=cfg,
                              key=key or "ground_plane")

    def add_shape_sphere(self, body: int, xform=None, radius: float = 1.0,
                         cfg: Optional[ShapeConfig] = None,
                         key: Optional[str] = None) -> int:
        return self.add_shape(body, GeoType.SPHERE, xform,
                              scale=(radius, radius, radius), cfg=cfg,
                              key=key)

    def add_shape_box(self, body: int, xform=None, hx: float = 0.5,
                      hy: float = 0.5, hz: float = 0.5,
                      cfg: Optional[ShapeConfig] = None,
                      key: Optional[str] = None) -> int:
        """Box of half-extents (hx, hy, hz) along the shape frame's axes."""
        return self.add_shape(body, GeoType.BOX, xform, scale=(hx, hy, hz),
                              cfg=cfg, key=key)

    def add_shape_capsule(self, body: int, xform=None, radius: float = 1.0,
                          half_height: float = 0.5, axis: AxisType = Axis.Z,
                          cfg: Optional[ShapeConfig] = None,
                          key: Optional[str] = None) -> int:
        """Capsule along +Z in the shape frame; ``axis`` rotates it."""
        return self.add_shape(body, GeoType.CAPSULE,
                              _axis_shape_xform(xform, axis),
                              scale=(radius, half_height, 0.0), cfg=cfg,
                              key=key)

    def add_shape_cylinder(self, body: int, xform=None, radius: float = 1.0,
                           half_height: float = 0.5, axis: AxisType = Axis.Z,
                           cfg: Optional[ShapeConfig] = None,
                           key: Optional[str] = None) -> int:
        """Solid cylinder along +Z in the shape frame; ``axis`` rotates it.
        It collides as the capsule of its radius and half-height, except
        against a plane (see ``geometry/narrow_phase.py``)."""
        return self.add_shape(body, GeoType.CYLINDER,
                              _axis_shape_xform(xform, axis),
                              scale=(radius, half_height, 0.0), cfg=cfg,
                              key=key)

    def add_shape_cone(self, body: int, xform=None, radius: float = 1.0,
                       half_height: float = 0.5, axis: AxisType = Axis.Z,
                       cfg: Optional[ShapeConfig] = None,
                       key: Optional[str] = None) -> int:
        """Solid cone along +Z in the shape frame (apex at +half_height,
        base disc of ``radius`` at -half_height); ``axis`` rotates it."""
        return self.add_shape(body, GeoType.CONE,
                              _axis_shape_xform(xform, axis),
                              scale=(radius, half_height, 0.0), cfg=cfg,
                              key=key)

    def add_shape_ellipsoid(self, body: int, xform=None, rx: float = 1.0,
                            ry: float = 1.0, rz: float = 1.0,
                            cfg: Optional[ShapeConfig] = None,
                            key: Optional[str] = None) -> int:
        """Solid ellipsoid of radii (rx, ry, rz) along the shape axes."""
        return self.add_shape(body, GeoType.ELLIPSOID, xform,
                              scale=(rx, ry, rz), cfg=cfg, key=key)

    def add_shape_mesh(self, body: int, xform=None, mesh: Mesh = None,
                       scale=(1.0, 1.0, 1.0),
                       cfg: Optional[ShapeConfig] = None,
                       key: Optional[str] = None) -> int:
        """Triangle mesh (vertices in the shape frame, times ``scale``);
        its mass from the mesh's volume at the config's density."""
        if mesh is None:
            raise ValueError("add_shape_mesh requires a Mesh source")
        return self.add_shape(body, GeoType.MESH, xform, scale=scale,
                              cfg=cfg, key=key, source=mesh)

    def add_shape_convex_hull(self, body: int, xform=None,
                              mesh: Mesh = None, scale=(1.0, 1.0, 1.0),
                              cfg: Optional[ShapeConfig] = None,
                              key: Optional[str] = None) -> int:
        """The convex hull of a mesh (computed on the host), colliding as
        a convex vertex cloud."""
        if mesh is None:
            raise ValueError("add_shape_convex_hull requires a Mesh source")
        return self.add_shape(body, GeoType.CONVEX, xform, scale=scale,
                              cfg=cfg, key=key,
                              source=_convex_hull_mesh(mesh))

    def add_shape_sdf(self, body: int, xform=None, sdf: SDF = None,
                      scale=(1.0, 1.0, 1.0),
                      cfg: Optional[ShapeConfig] = None,
                      key: Optional[str] = None) -> int:
        """A shape given by its SDF grid. As in the JAX package, the
        collision pipeline gives its pairs no contacts (skipped with a
        warning; ROADMAP C)."""
        return self.add_shape(body, GeoType.SDF, xform, scale=scale,
                              cfg=cfg, key=key, source=sdf)

    def add_shape_heightfield(self, body: int = -1, xform=None,
                              heightfield: Heightfield = None,
                              cfg: Optional[ShapeConfig] = None,
                              key: Optional[str] = None) -> int:
        """A heightfield, centred at the shape origin, +Z up."""
        if heightfield is None:
            raise ValueError("add_shape_heightfield requires a Heightfield "
                             "source")
        return self.add_shape(body, GeoType.HFIELD, xform,
                              scale=(heightfield.size_x, heightfield.size_y,
                                     1.0), cfg=cfg, key=key,
                              source=heightfield)

    def approximate_meshes(self, method: str = "convex_hull",
                           maxhullvert: int = 64) -> None:
        """Replace every mesh shape's source by its convex hull (the shape
        becomes CONVEX and collides through MPR)."""
        for s, src in enumerate(self.shape_source):
            if isinstance(src, Mesh) and \
                    self.shape_type[s] == int(GeoType.MESH):
                hull = _convex_hull_mesh(src)
                hull.maxhullvert = maxhullvert
                self.shape_source[s] = hull
                self.shape_type[s] = int(GeoType.CONVEX)

    def add_rod(self, start_pos, end_pos, segments: int = 8,
                radius: float = 0.02, density: float = 1000.0,
                bend_ke: float = 100.0, bend_kd: float = 1.0,
                root_joint: str = "free", root_parent: int = -1,
                joint: str = "ball", stretch_ke: float = 1.0e5,
                stretch_kd: float = 0.0, twist_ke: Optional[float] = None,
                twist_kd: Optional[float] = None,
                key: Optional[str] = None) -> List[int]:
        """Discrete elastic rod as a chain of capsules from ``start_pos``
        to ``end_pos`` (the JAX builder's ``add_rod``): segment +Z is the
        tangent. ``joint="ball"`` joins consecutive segments by ball joints
        whose dof drive gains ``bend_ke`` and ``bend_kd`` give the bending
        stiffness (every rigid solver); ``joint="cable"`` by cable joints
        with the split stretch/shear (``stretch_ke``/``stretch_kd``) and
        bend/twist (``bend_*``, ``twist_*``, twist defaulting to bend)
        stiffness (SolverXPBD). The first segment hangs from
        ``root_parent`` by a fixed or ball joint at ``start_pos``, or is
        free. Returns the body indices."""
        if joint not in ("ball", "cable"):
            raise ValueError(f"unknown rod joint {joint!r}")
        if root_joint not in ("fixed", "ball", "free"):
            raise ValueError(f"unknown root_joint {root_joint!r}")
        p0 = np.asarray(start_pos, dtype=np.float64)
        p1 = np.asarray(end_pos, dtype=np.float64)
        axis = p1 - p0
        length = float(np.linalg.norm(axis))
        axis = axis / max(length, 1e-9)
        seg_len = length / segments
        q = np_quat_between_axes(np.array([0.0, 0, 1]), axis)
        cfg = self.default_shape_cfg.copy()
        cfg.density = density
        name = key or "rod"
        root_X_p = (np_transform(p0, q) if root_parent < 0
                    else np_transform(np.zeros(3), q))
        anchor_p = np_transform(np.array([0.0, 0, seg_len / 2]))
        anchor_c = np_transform(np.array([0.0, 0, -seg_len / 2]))

        bodies, prev = [], -1
        for i in range(segments):
            center = p0 + axis * (i + 0.5) * seg_len
            b = self.add_body(xform=np_transform(center, q), key=f"{name}_{i}")
            self.add_shape_capsule(b, radius=radius,
                                   half_height=seg_len / 2 - radius * 0.5,
                                   cfg=cfg, key=f"{name}_shape_{i}")
            if i == 0 and root_joint == "fixed":
                self.add_joint_fixed(root_parent, b, xform_p=root_X_p,
                                     xform_c=anchor_c, key=f"{name}_root")
            elif i == 0 and root_joint == "ball":
                self._bend(self.add_joint_ball(
                    root_parent, b, xform_p=root_X_p, xform_c=anchor_c,
                    key=f"{name}_root"), bend_ke, bend_kd)
            elif i == 0:
                self.add_joint_free(b, key=f"{name}_root")
            elif joint == "cable":
                self.add_joint_cable(
                    prev, b, xform_p=anchor_p, xform_c=anchor_c,
                    stretch_stiffness=stretch_ke, stretch_damping=stretch_kd,
                    bend_stiffness=bend_ke, bend_damping=bend_kd,
                    twist_stiffness=twist_ke, twist_damping=twist_kd,
                    key=f"{name}_j{i}")
            else:
                self._bend(self.add_joint_ball(
                    prev, b, xform_p=anchor_p, xform_c=anchor_c,
                    key=f"{name}_j{i}"), bend_ke, bend_kd)
            prev = b
            bodies.append(b)
        return bodies

    def _bend(self, j: int, ke: float, kd: float) -> None:
        """A ball joint's bending stiffness: its three dofs' drive gains."""
        d0 = self.joint_qd_start[j]
        self.joint_target_ke[d0:d0 + 3] = [float(ke)] * 3
        self.joint_target_kd[d0:d0 + 3] = [float(kd)] * 3

    def add_rod_graph(self, points, edges, radius: float = 0.02,
                      density: float = 1000.0, bend_ke: float = 100.0,
                      bend_kd: float = 1.0, joint: str = "ball",
                      stretch_ke: float = 1.0e5, stretch_kd: float = 0.0,
                      twist_ke: Optional[float] = None,
                      twist_kd: Optional[float] = None,
                      key: Optional[str] = None) -> List[int]:
        """Branching rod network (the JAX builder's ``add_rod_graph``): one
        capsule body per edge ``(i, j)`` of ``points`` (P, 3), joined where
        edges share a point by ball joints (bending through the drive
        gains) or, with ``joint="cable"``, cable joints whose child frame
        is anchored in the rest pose (the branch angle is unstrained). An
        edge whose start point no earlier edge reached gets a free joint.
        Returns the per-edge body indices."""
        if joint not in ("ball", "cable"):
            raise ValueError(f"unknown rod joint {joint!r}")
        pts = np.asarray(points, dtype=np.float64)
        cfg = self.default_shape_cfg.copy()
        cfg.density = density
        name = key or "rodg"
        point_body, body_rot, bodies = {}, {}, []
        for ei, (i, j) in enumerate(edges):
            i, j = int(i), int(j)
            axis = pts[j] - pts[i]
            length = float(np.linalg.norm(axis))
            axis = axis / max(length, 1e-9)
            q = np_quat_between_axes(np.array([0.0, 0, 1]), axis)
            b = self.add_body(xform=np_transform((pts[i] + pts[j]) / 2, q),
                              key=f"{name}_{ei}")
            body_rot[b] = q
            self.add_shape_capsule(b, radius=radius,
                                   half_height=max(length / 2 - radius * 0.5,
                                                   radius * 0.25),
                                   cfg=cfg, key=f"{name}_shape_{ei}")
            if i in point_body:
                parent, off = point_body[i]
                if joint == "cable":
                    q_cl = np_quat_mul(np.array([-q[0], -q[1], -q[2], q[3]]),
                                       body_rot[parent])
                    self.add_joint_cable(
                        parent, b, xform_p=np_transform(off),
                        xform_c=np_transform(
                            np.array([0.0, 0, -length / 2]), q_cl),
                        stretch_stiffness=stretch_ke,
                        stretch_damping=stretch_kd, bend_stiffness=bend_ke,
                        bend_damping=bend_kd, twist_stiffness=twist_ke,
                        twist_damping=twist_kd, key=f"{name}_j{ei}")
                else:
                    self._bend(self.add_joint_ball(
                        parent, b, xform_p=np_transform(off),
                        xform_c=np_transform(np.array([0.0, 0,
                                                       -length / 2])),
                        key=f"{name}_j{ei}"), bend_ke, bend_kd)
            else:
                self.add_joint_free(b, key=f"{name}_root{ei}")
            if i not in point_body:
                point_body[i] = (b, np.array([0.0, 0, -length / 2]))
            point_body[j] = (b, np.array([0.0, 0, length / 2]))
            bodies.append(b)
        return bodies

    # ------------------------------------------------------------------
    # particles (the JAX builder's add_particle/add_particles/
    # add_particle_grid, same arguments and defaults)
    # ------------------------------------------------------------------
    def add_particle(self, pos, vel=(0.0, 0.0, 0.0), mass: float = 1.0,
                     radius: float = 0.1,
                     flags: int = int(ParticleFlags.ACTIVE)) -> int:
        idx = self.particle_count
        self.particle_q.append(np.asarray(pos, dtype=np.float64))
        self.particle_qd.append(np.asarray(vel, dtype=np.float64))
        self.particle_mass.append(float(mass))
        self.particle_radius.append(float(radius))
        self.particle_flags.append(int(flags))
        self.particle_world.append(self._current_world)
        return idx

    def add_particles(self, pos, vel=None, mass=None, radius=None,
                      flags=None) -> List[int]:
        pos = np.asarray(pos, dtype=np.float64).reshape(-1, 3)
        n = len(pos)
        vel = np.zeros((n, 3)) if vel is None \
            else np.asarray(vel, dtype=np.float64).reshape(-1, 3)

        def per_particle(x, default, dtype=np.float64):
            x = default if x is None else x
            return np.broadcast_to(np.asarray(x, dtype=dtype), (n,))
        mass = per_particle(mass, 1.0)
        radius = per_particle(radius, 0.1)
        flags = per_particle(flags, int(ParticleFlags.ACTIVE), np.int64)
        start = self.particle_count
        self.particle_q.extend(list(pos))
        self.particle_qd.extend(list(vel))
        self.particle_mass.extend([float(m) for m in mass])
        self.particle_radius.extend([float(r) for r in radius])
        self.particle_flags.extend([int(f) for f in flags])
        self.particle_world.extend([self._current_world] * n)
        return list(range(start, start + n))

    def add_particle_grid(self, pos, rot=None, vel=(0, 0, 0),
                          dim_x: int = 4, dim_y: int = 4, dim_z: int = 4,
                          cell_x: float = 0.1, cell_y: float = 0.1,
                          cell_z: float = 0.1, mass: float = 1.0,
                          radius: float = 0.05, jitter: float = 0.0,
                          seed: int = 42) -> List[int]:
        """Regular 3D particle grid, x fastest (optionally jittered from a
        numpy generator seeded with ``seed``)."""
        rot = np_quat_identity() if rot is None \
            else np.asarray(rot, dtype=np.float64)
        pos = np.asarray(pos, dtype=np.float64)
        rng = np.random.default_rng(seed)
        start = self.particle_count
        for zi in range(dim_z):
            for yi in range(dim_y):
                for xi in range(dim_x):
                    local = np.array([xi * cell_x, yi * cell_y, zi * cell_z])
                    if jitter > 0.0:
                        local = local + rng.uniform(-jitter, jitter, 3)
                    self.add_particle(pos + np_quat_rotate(rot, local),
                                      vel, mass, radius=radius)
        return list(range(start, self.particle_count))

    # ------------------------------------------------------------------
    # cloth and soft topology (the JAX builder's springs, triangles,
    # bending edges, tetrahedra and their grid and mesh helpers: same
    # arguments, defaults, entity order and rest values; the grid helpers
    # compute a whole grid's rows with array operations)
    # ------------------------------------------------------------------
    def _particle_array(self) -> np.ndarray:
        return np.asarray(self.particle_q, dtype=np.float64).reshape(-1, 3)

    def add_spring(self, i: int, j: int, ke: float = 1.0e3, kd: float = 0.0,
                   control: float = 1.0) -> int:
        """Spring between particles i and j; its rest length is their
        current distance times ``control``."""
        rest = float(np.linalg.norm(self.particle_q[i]
                                    - self.particle_q[j])) * control
        self.spring_indices.append((int(i), int(j)))
        self.spring_rest_length.append(rest)
        self.spring_stiffness.append(float(ke))
        self.spring_damping.append(float(kd))
        return len(self.spring_indices) - 1

    def sew_particles(self, indices_a, indices_b, ke: float = 2.0e3,
                      kd: float = 1.0, shrink: float = 0.0) -> List[int]:
        """Seam springs between paired particles of two panels, rest length
        ``1 - shrink`` times their current separation. Returns the spring
        indices."""
        return [self.add_spring(int(a), int(b), ke=ke, kd=kd,
                                control=max(1.0 - float(shrink), 0.0))
                for a, b in zip(indices_a, indices_b)]

    def add_triangle(self, i: int, j: int, k: int, tri_ke: float = 100.0,
                     tri_ka: float = 100.0, tri_kd: float = 10.0,
                     tri_drag: float = 0.0, tri_lift: float = 0.0) -> float:
        """Membrane triangle; stores the inverse of its 2x2 rest matrix in
        the triangle's own plane basis and returns its rest area (raises
        ValueError on a degenerate triangle)."""
        return self.add_triangles([(i, j, k)], tri_ke=tri_ke, tri_ka=tri_ka,
                                  tri_kd=tri_kd, tri_drag=tri_drag,
                                  tri_lift=tri_lift)[0]

    def add_triangles(self, indices, tri_ke: float = 100.0,
                      tri_ka: float = 100.0, tri_kd: float = 10.0,
                      tri_drag: float = 0.0,
                      tri_lift: float = 0.0) -> List[float]:
        """Triangles ``indices`` (T, 3) with one material; returns their
        rest areas."""
        idx = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
        if not len(idx):
            return []
        Q = self._particle_array()
        p = Q[idx[:, 0]]
        qp, rp = Q[idx[:, 1]] - p, Q[idx[:, 2]] - p
        n = np.cross(qp, rp)
        area = 0.5 * np.linalg.norm(n, axis=-1)
        if (area < 1e-12).any():
            raise ValueError("Degenerate triangle")
        e1 = qp / np.linalg.norm(qp, axis=-1)[:, None]
        e2 = np.cross(n / (2.0 * area)[:, None], e1)
        D = np.stack([np.stack([(qp * e1).sum(-1), (rp * e1).sum(-1)], -1),
                      np.stack([(qp * e2).sum(-1), (rp * e2).sum(-1)], -1)],
                     -2)
        self.tri_indices += [tuple(t) for t in idx.tolist()]
        self.tri_poses += list(np.linalg.inv(D))
        self.tri_materials += [(tri_ke, tri_ka, tri_kd, tri_drag,
                                tri_lift)] * len(idx)
        self.tri_areas += area.tolist()
        return area.tolist()

    def add_edge(self, i: int, j: int, k: int, l: int,
                 rest: Optional[float] = None, edge_ke: float = 100.0,
                 edge_kd: float = 0.0) -> int:
        """Bending edge between triangles (i, k, l) and (j, l, k): wings
        i and j (-1 for none), shared edge (k, l). Without ``rest`` the
        rest angle is the current dihedral angle (0 where a wing is
        missing or a triangle degenerate)."""
        if rest is None:
            rest = 0.0
            if i >= 0 and j >= 0:
                x1, x2 = self.particle_q[k], self.particle_q[l]
                x3, x4 = self.particle_q[i], self.particle_q[j]
                e = x2 - x1
                e_norm = np.linalg.norm(e)
                n1 = np.cross(x3 - x1, x2 - x1)
                n2 = np.cross(x2 - x1, x4 - x1)
                if (e_norm > 1e-12 and np.linalg.norm(n1) > 1e-12
                        and np.linalg.norm(n2) > 1e-12):
                    n1 /= np.linalg.norm(n1)
                    n2 /= np.linalg.norm(n2)
                    cos_t = float(np.clip(n1 @ n2, -1.0, 1.0))
                    sin_t = float(np.clip(np.cross(n1, n2) @ (e / e_norm),
                                          -1.0, 1.0))
                    rest = math.atan2(sin_t, cos_t)
        self.edge_indices.append((int(i), int(j), int(k), int(l)))
        self.edge_rest_angle.append(float(rest))
        self.edge_rest_length.append(float(np.linalg.norm(
            self.particle_q[l] - self.particle_q[k])))
        self.edge_bending_properties.append((edge_ke, edge_kd))
        return len(self.edge_indices) - 1

    def add_edges(self, indices, **kwargs) -> List[int]:
        return [self.add_edge(int(a), int(b), int(c), int(d), **kwargs)
                for a, b, c, d in np.asarray(indices).reshape(-1, 4)]

    def add_tetrahedron(self, i: int, j: int, k: int, l: int,
                        k_mu: float = 1.0e3, k_lambda: float = 1.0e3,
                        k_damp: float = 0.0) -> float:
        """NeoHookean tetrahedron; stores the inverse rest matrix and
        returns the rest volume (raises ValueError when it is inverted or
        degenerate)."""
        p, q, r, s = (self.particle_q[x] for x in (i, j, k, l))
        D = np.stack([q - p, r - p, s - p], axis=1)
        vol = float(np.linalg.det(D)) / 6.0
        if vol <= 0.0:
            raise ValueError("Inverted or degenerate tetrahedron")
        self.tet_indices.append((int(i), int(j), int(k), int(l)))
        self.tet_poses.append(np.linalg.inv(D))
        self.tet_materials.append((k_mu, k_lambda, k_damp))
        return vol

    def add_cloth_grid(self, pos, rot=None, vel=(0, 0, 0), dim_x: int = 10,
                       dim_y: int = 10, cell_x: float = 0.1,
                       cell_y: float = 0.1, mass: float = 1.0,
                       fix_left: bool = False, fix_right: bool = False,
                       fix_top: bool = False, fix_bottom: bool = False,
                       radius: float = 0.05, tri_ke: float = 100.0,
                       tri_ka: float = 100.0, tri_kd: float = 10.0,
                       edge_ke: float = 100.0, edge_kd: float = 0.0,
                       add_springs: bool = False, spring_ke: float = 100.0,
                       spring_kd: float = 0.0) -> List[int]:
        """Regular cloth grid of (dim_x + 1) x (dim_y + 1) particles in the
        XY plane of ``rot``, x fastest; the fixed edges' particles get mass
        0. Two triangles per cell (the diagonal alternating with the cell's
        parity), bending rows as collinear triples along x then y (rest
        angle 0), optional structural springs."""
        rot = np_quat_identity() if rot is None \
            else np.asarray(rot, dtype=np.float64)
        pos = np.asarray(pos, dtype=np.float64)
        vel = np.asarray(vel, dtype=np.float64)
        nx, ny = dim_x + 1, dim_y + 1
        start = self.particle_count
        pm = mass / (nx * ny)
        yi, xi = np.divmod(np.arange(nx * ny), nx)
        local = np.stack([xi * cell_x, yi * cell_y, np.zeros(nx * ny)], 1)
        fixed = ((fix_left & (xi == 0)) | (fix_right & (xi == nx - 1))
                 | (fix_bottom & (yi == 0)) | (fix_top & (yi == ny - 1)))
        self.add_particles(pos + np_quat_rotate(rot, local),
                           np.broadcast_to(vel, (nx * ny, 3)),
                           np.where(fixed, 0.0, pm), radius)
        idx = start + np.arange(nx * ny).reshape(ny, nx)
        v0, v1 = idx[:-1, :-1], idx[:-1, 1:]
        v2, v3 = idx[1:, :-1], idx[1:, 1:]
        even = ((np.arange(dim_y)[:, None] + np.arange(dim_x)[None]) % 2
                == 0)[..., None]
        tri_a = np.where(even, np.stack([v0, v1, v3], -1),
                         np.stack([v0, v1, v2], -1))
        tri_b = np.where(even, np.stack([v0, v3, v2], -1),
                         np.stack([v1, v3, v2], -1))
        self.add_triangles(np.stack([tri_a, tri_b], 2),
                           tri_ke=tri_ke, tri_ka=tri_ka, tri_kd=tri_kd)
        self._add_grid_bend_edges(idx, edge_ke, edge_kd)
        if add_springs:
            right = np.stack([idx, np.roll(idx, -1, 1)], -1)
            up = np.stack([idx, np.roll(idx, -1, 0)], -1)
            both = np.stack([right, up], 2)                 # (ny, nx, 2, 2)
            ok = np.stack([np.broadcast_to(np.arange(nx) < dim_x, (ny, nx)),
                           np.broadcast_to((np.arange(ny) < dim_y)[:, None],
                                           (ny, nx))], 2)
            pairs = both[ok]
            Q = self._particle_array()
            rest = np.linalg.norm(Q[pairs[:, 0]] - Q[pairs[:, 1]], axis=-1)
            self.spring_indices += [tuple(p) for p in pairs.tolist()]
            self.spring_rest_length += rest.tolist()
            self.spring_stiffness += [float(spring_ke)] * len(pairs)
            self.spring_damping += [float(spring_kd)] * len(pairs)
        return list(range(start, self.particle_count))

    def _add_grid_bend_edges(self, idx, edge_ke, edge_kd):
        """Bending rows of a grid of particle indices ``idx`` (ny, nx):
        every collinear triple (o0, o1, m, m) along x, row by row, then
        along y, column by column; rest angle and rest length 0."""
        rows = np.concatenate([
            np.stack([idx[:, :-2], idx[:, 2:], idx[:, 1:-1]], -1)
            .reshape(-1, 3),
            np.stack([idx[:-2], idx[2:], idx[1:-1]], -1)
            .transpose(1, 0, 2).reshape(-1, 3)])
        n = len(rows)
        self.edge_indices += [(a, b, m, m) for a, b, m in rows.tolist()]
        self.edge_rest_angle += [0.0] * n
        self.edge_rest_length += [0.0] * n
        self.edge_bending_properties += [(edge_ke, edge_kd)] * n

    def add_cloth_mesh(self, pos, rot, vel, vertices, indices,
                       density: float = 1.0, scale: float = 1.0,
                       radius: float = 0.05, tri_ke: float = 100.0,
                       tri_ka: float = 100.0, tri_kd: float = 10.0,
                       edge_ke: float = 100.0,
                       edge_kd: float = 0.0) -> List[int]:
        """Cloth from a triangle mesh: masses lumped from the triangle
        areas, a bending edge on every edge shared by two triangles."""
        rot = np_quat_identity() if rot is None \
            else np.asarray(rot, dtype=np.float64)
        pos = np.asarray(pos, dtype=np.float64)
        vel = np.asarray(vel, dtype=np.float64)
        verts = np.asarray(vertices, dtype=np.float64).reshape(-1, 3) * scale
        faces = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
        start = self.particle_count
        for v in verts:
            self.add_particle(pos + np_quat_rotate(rot, v), vel, 0.0,
                              radius=radius)
        areas = self.add_triangles(faces + start, tri_ke=tri_ke,
                                   tri_ka=tri_ka, tri_kd=tri_kd)
        for (a, b, c), ar in zip(faces + start, areas):
            m = density * ar / 3.0
            for vtx in (a, b, c):
                self.particle_mass[vtx] += m
        edge_map: Dict[Tuple[int, int], List[int]] = {}
        for a, b, c in (faces + start).tolist():
            for (u, v), opp in (((a, b), c), ((b, c), a), ((c, a), b)):
                edge_map.setdefault((min(u, v), max(u, v)), []).append(opp)
        for (u, v), opps in edge_map.items():
            if len(opps) == 2:
                self.add_edge(opps[0], opps[1], u, v, edge_ke=edge_ke,
                              edge_kd=edge_kd)
        return list(range(start, self.particle_count))

    def add_soft_grid(self, pos, rot, vel, dim_x: int, dim_y: int,
                      dim_z: int, cell_x: float, cell_y: float,
                      cell_z: float, density: float = 100.0,
                      k_mu: float = 1.0e3, k_lambda: float = 1.0e3,
                      k_damp: float = 0.0, radius: float = 0.05,
                      fix_left: bool = False, fix_right: bool = False,
                      fix_top: bool = False, fix_bottom: bool = False,
                      tri_ke: float = 0.0, tri_ka: float = 0.0,
                      tri_kd: float = 0.0) -> List[int]:
        """Hexahedral soft-body grid, five tetrahedra per cell with the
        split alternating with the cell's parity; a tetrahedron the split
        leaves inverted is added with two vertices swapped."""
        rot = np_quat_identity() if rot is None \
            else np.asarray(rot, dtype=np.float64)
        pos = np.asarray(pos, dtype=np.float64)
        vel = np.asarray(vel, dtype=np.float64)
        nx, ny, nz = dim_x + 1, dim_y + 1, dim_z + 1
        start = self.particle_count
        pm = (density * cell_x * cell_y * cell_z * dim_x * dim_y * dim_z
              / (nx * ny * nz))

        def vidx(xi, yi, zi):
            return start + zi * nx * ny + yi * nx + xi

        for zi in range(nz):
            for yi in range(ny):
                for xi in range(nx):
                    local = np.array([xi * cell_x, yi * cell_y, zi * cell_z])
                    fixed = ((fix_left and xi == 0)
                             or (fix_right and xi == nx - 1)
                             or (fix_bottom and zi == 0)
                             or (fix_top and zi == nz - 1))
                    self.add_particle(pos + np_quat_rotate(rot, local), vel,
                                      0.0 if fixed else pm, radius=radius)
        for zi in range(dim_z):
            for yi in range(dim_y):
                for xi in range(dim_x):
                    v = [vidx(xi, yi, zi), vidx(xi + 1, yi, zi),
                         vidx(xi + 1, yi + 1, zi), vidx(xi, yi + 1, zi),
                         vidx(xi, yi, zi + 1), vidx(xi + 1, yi, zi + 1),
                         vidx(xi + 1, yi + 1, zi + 1),
                         vidx(xi, yi + 1, zi + 1)]
                    if (xi + yi + zi) % 2 == 0:
                        tets = [(0, 1, 2, 5), (0, 2, 7, 5), (0, 2, 3, 7),
                                (0, 5, 7, 4), (2, 7, 5, 6)]
                    else:
                        tets = [(1, 3, 0, 4), (1, 6, 3, 4), (1, 2, 3, 6),
                                (3, 6, 4, 7), (1, 4, 6, 5)]
                    for a, b, c, d in tets:
                        try:
                            self.add_tetrahedron(v[a], v[b], v[c], v[d],
                                                 k_mu, k_lambda, k_damp)
                        except ValueError:
                            self.add_tetrahedron(v[a], v[c], v[b], v[d],
                                                 k_mu, k_lambda, k_damp)
        return list(range(start, self.particle_count))

    def add_soft_mesh(self, pos, rot, vel, vertices, indices,
                      density: float = 100.0, scale: float = 1.0,
                      k_mu: float = 1.0e3, k_lambda: float = 1.0e3,
                      k_damp: float = 0.0, radius: float = 0.05,
                      tri_ke: float = 0.0, tri_ka: float = 0.0,
                      tri_kd: float = 0.0) -> List[int]:
        """Soft body from a tetrahedral mesh (``indices`` (T, 4)): masses
        lumped from the volumes, a membrane triangle on every face that
        belongs to one tetrahedron only."""
        rot = np_quat_identity() if rot is None \
            else np.asarray(rot, dtype=np.float64)
        pos = np.asarray(pos, dtype=np.float64)
        vel = np.asarray(vel, dtype=np.float64)
        verts = np.asarray(vertices, dtype=np.float64).reshape(-1, 3) * scale
        tets = np.asarray(indices, dtype=np.int64).reshape(-1, 4) \
            + self.particle_count
        start = self.particle_count
        for v in verts:
            self.add_particle(pos + np_quat_rotate(rot, v), vel, 0.0,
                              radius=radius)
        for a, b, c, d in tets.tolist():
            try:
                vol = self.add_tetrahedron(a, b, c, d, k_mu, k_lambda,
                                           k_damp)
            except ValueError:
                vol = self.add_tetrahedron(a, c, b, d, k_mu, k_lambda,
                                           k_damp)
            for vtx in (a, b, c, d):
                self.particle_mass[vtx] += density * vol / 4.0
        faces: Dict[Tuple[int, ...], Tuple[int, int, int]] = {}
        for a, b, c, d in tets.tolist():
            for f in ((a, c, b), (a, b, d), (a, d, c), (b, c, d)):
                key = tuple(sorted(f))
                if key in faces:
                    del faces[key]
                else:
                    faces[key] = f
        for f in faces.values():
            try:
                self.add_triangle(f[0], f[1], f[2], tri_ke, tri_ka, tri_kd)
            except ValueError:
                pass
        return list(range(start, self.particle_count))

    def add_muscle(self, bodies: Sequence[int], positions: Sequence,
                   f0: float, lm: float, lt: float, lmax: float,
                   pen: float, passive_ke: float = 0.0,
                   passive_kd: float = 0.0) -> int:
        """Muscle-tendon unit routed through body-frame waypoints: an
        activation (``Control.muscle_activations``) pulls with ``act *
        f0`` along the path, and passive_ke/passive_kd add tension when
        the path stretches past ``lm + lt`` (applied by
        ``SolverSemiImplicit``)."""
        idx = len(self.muscle_params)
        self.muscle_start.append(len(self.muscle_bodies))
        self.muscle_params.append((float(f0), float(lm), float(lt),
                                   float(lmax), float(pen),
                                   float(passive_ke), float(passive_kd)))
        for b, p in zip(bodies, positions):
            self.muscle_bodies.append(int(b))
            self.muscle_points.append(np.asarray(p, dtype=np.float64))
        return idx

    def add_tendon_spatial(self, elems: Sequence[tuple],
                           stiffness: float = 0.0, damping: float = 0.0,
                           rest_length: Optional[float] = None,
                           key: Optional[str] = None) -> int:
        """Spatial tendon routed through body-frame sites with optional
        sphere/cylinder wrap geoms (MuJoCo ``<spatial>``). ``elems`` in
        path order: ("site", body, pos), ("sphere", body, pos, radius,
        side_or_None), ("cylinder", body, pos, axis, radius,
        side_or_None). Its passive force ``-ke (L - L0) - kd Ldot`` acts
        through the moment rows (sim/tendon.py); actuators may drive it.
        ``rest_length=None`` takes L0 from the build pose at finalize."""
        idx = len(self.sten_params)
        self.sten_paths.append(SpatialTendonPath(elems))
        self.sten_params.append((float(stiffness), float(damping),
                                 float("nan") if rest_length is None
                                 else float(rest_length)))
        self.sten_key.append(key or f"sten_{idx}")
        return idx

    # ------------------------------------------------------------------
    # custom attributes and importers
    # ------------------------------------------------------------------
    def add_custom_attribute(self, name: str, frequency: AttributeFrequency,
                             shape=(),
                             assignment=AttributeAssignment.MODEL,
                             default: float = 0.0):
        if name not in self.custom_attributes:
            spec = AttributeSpec(name, frequency, assignment, tuple(shape),
                                 float(default))
            self.custom_attributes[name] = (spec, {})

    def add_custom_values(self, name: str, values: Dict[int, float]):
        self.custom_attributes[name][1].update(values)

    def add_urdf(self, source: str, xform=None, floating: bool = False,
                 scale: float = 1.0, key_prefix: Optional[str] = None,
                 **kwargs):
        """Import a URDF file or XML string (see ``utils/import_urdf.py``);
        returns name -> index maps of its bodies and joints."""
        from ..utils.import_urdf import parse_urdf
        return parse_urdf(self, source, xform=xform, floating=floating,
                          scale=scale, key_prefix=key_prefix, **kwargs)

    def collapse_fixed_joints(self) -> None:
        """Merge every body attached to another body by a fixed joint into
        that body (mass, COM and inertia combined; its shapes, outgoing
        joints and CONNECT/WELD constraints moved onto it), the JAX
        builder's ``collapse_fixed_joints``; bodies fixed to the world
        stay. Call before ``finalize``. Builders with fixed tendons, MJCF
        actuators, custom attributes or particles raise (their joint and
        dof maps are not remapped)."""
        if (self.tendon_params or self.mjc_actuation is not None
                or self.custom_attributes or self.particle_count):
            raise NotImplementedError(
                "collapse_fixed_joints with fixed tendons, MJCF actuators, "
                "custom attributes or particles is not ported yet")
        while True:
            fixed = [j for j in range(self.joint_count)
                     if self.joint_type[j] == int(JointType.FIXED)
                     and self.joint_parent[j] >= 0]
            if not fixed:
                return
            self._collapse_joint(fixed[0])

    def _collapse_joint(self, j: int) -> None:
        parent, child = self.joint_parent[j], self.joint_child[j]
        # the child's frame in the parent's, through the joint
        X_pc = np_transform_multiply(self.joint_X_p[j],
                                     np_transform_inverse(self.joint_X_c[j]))
        m_c = self.body_mass[child]
        if m_c > 0:
            com_c = np_transform_point(X_pc, self.body_com[child])
            m_p, c_p = self.body_mass[parent], self.body_com[parent]
            m_new = m_p + m_c
            c_new = (m_p * c_p + m_c * com_c) / m_new
            ident = np.array([0.0, 0, 0, 1])
            self.body_inertia[parent] = (
                transform_inertia(m_p, self.body_inertia[parent],
                                  c_p - c_new, ident)
                + transform_inertia(m_c, self.body_inertia[child],
                                    com_c - c_new, X_pc[3:]))
            self.body_mass[parent] = m_new
            self.body_com[parent] = c_new
        for s in range(self.shape_count):
            if self.shape_body[s] == child:
                self.shape_body[s] = parent
                self.shape_transform[s] = np_transform_multiply(
                    X_pc, self.shape_transform[s])
        for j2 in range(self.joint_count):
            if j2 != j and self.joint_parent[j2] == child:
                self.joint_parent[j2] = parent
                self.joint_X_p[j2] = np_transform_multiply(
                    X_pc, self.joint_X_p[j2])
        q_pc = X_pc[3:]
        for e, typ in enumerate(self.eq_type):
            if typ == int(EqType.JOINT):
                continue
            rel = self.eq_relpose[e]
            if self.eq_obj1[e] == child:
                # body1's anchor into the parent's frame; a WELD holds the
                # parent at the orientation that held the child
                self.eq_obj1[e] = parent
                self.eq_anchor[e] = np_transform_point(X_pc,
                                                       self.eq_anchor[e])
                rel = np.concatenate([rel[:3], np_quat_mul(
                    rel[3:], q_pc * [-1.0, -1.0, -1.0, 1.0])])
            if self.eq_obj2[e] == child:
                self.eq_obj2[e] = parent
                rel = np.concatenate([rel[:3], np_quat_mul(q_pc, rel[3:])])
            self.eq_relpose[e] = rel
        # delete joint j (it has no dofs or coordinates) and body child
        for lst in (self.joint_type, self.joint_parent, self.joint_child,
                    self.joint_X_p, self.joint_X_c, self.joint_key,
                    self.joint_world, self.joint_dof_dim):
            del lst[j]
        del self.joint_q_start[j + 1]
        del self.joint_qd_start[j + 1]
        self.articulation_start = [a - 1 if a > j else a
                                   for a in self.articulation_start]
        for e, typ in enumerate(self.eq_type):
            if typ == int(EqType.JOINT):
                for name in ("eq_obj1", "eq_obj2"):
                    if getattr(self, name)[e] > j:
                        getattr(self, name)[e] -= 1
        for lst in (self.body_q, self.body_qd, self.body_com, self.body_mass,
                    self.body_inertia, self.body_flags, self.body_world,
                    self.body_key):
            del lst[child]

        def remap(x):
            return x - 1 if x > child else x
        self.shape_body = [remap(x) for x in self.shape_body]
        self.joint_parent = [remap(x) for x in self.joint_parent]
        self.joint_child = [remap(x) for x in self.joint_child]
        for e, typ in enumerate(self.eq_type):
            if typ != int(EqType.JOINT):
                self.eq_obj1[e] = remap(self.eq_obj1[e])
                self.eq_obj2[e] = remap(self.eq_obj2[e])
        self._body_filter_pairs = {
            (remap(a), remap(b)) for a, b in self._body_filter_pairs
            if a != child and b != child and remap(a) != remap(b)}

    def add_mjcf(self, source: str, **kwargs):
        """Import an MJCF file (see ``utils/import_mjcf.py``)."""
        from ..utils.import_mjcf import parse_mjcf
        return parse_mjcf(self, source, **kwargs)

    # ------------------------------------------------------------------
    # collision candidates
    # ------------------------------------------------------------------
    def _collide_mask(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Which shape pairs (a[i], b[i]) can ever collide: the JAX
        builder's ``_should_collide`` over arrays. Pairs never cross two
        worlds; a global shape (world -1) meets every world."""
        body = np.asarray(self.shape_body, dtype=np.int64)
        world = np.asarray(self.shape_world, dtype=np.int64)
        flags = np.asarray(self.shape_flags, dtype=np.int64)
        ct = np.asarray(self.shape_contype, dtype=np.int64)
        ca = np.asarray(self.shape_conaffinity, dtype=np.int64)
        grp = np.asarray(self.shape_collision_group, dtype=np.int64)
        typ = np.asarray(self.shape_type, dtype=np.int64)
        COLL = int(ShapeFlags.COLLIDE_SHAPES)
        ba, bb = body[a], body[b]
        wa, wb = world[a], world[b]
        ga, gb = grp[a], grp[b]
        m = (a != b) & (ba != bb) & ~((ba < 0) & (bb < 0))
        m &= ((flags[a] & COLL) != 0) & ((flags[b] & COLL) != 0)
        m &= (wa == -1) | (wb == -1) | (wa == wb)
        m &= ((ct[a] & ca[b]) != 0) | ((ct[b] & ca[a]) != 0)
        m &= (ga != 0) & (gb != 0)
        m &= ~((ga > 0) & ~((ga == gb) | (gb < 0)))
        m &= ~((ga < 0) & (ga == gb))
        S, B = max(self.shape_count, 1), max(self.body_count, 1)
        for pairs, x, y, n in (
                (self.shape_collision_filter_pairs, a, b, S),
                (self._body_filter_pairs, ba, bb, B)):
            if pairs:
                keys = np.fromiter((p * n + q for p, q in pairs),
                                   dtype=np.int64, count=len(pairs))
                hit = np.isin(np.minimum(x, y) * n + np.maximum(x, y), keys)
                m &= ~(hit & (x >= 0) & (y >= 0))
        plane = int(GeoType.PLANE)
        m &= ~((typ[a] == plane) & (typ[b] == plane))
        return m

    def _compute_candidate_pairs(self):
        """All shape pairs that can ever collide, sorted, with cumulative
        contact-slot offsets: the JAX builder's set and order. Pairs inside
        one world are (lower, higher) index; a world shape with a global
        shape puts the static one second; two global shapes are (lower,
        higher). Vectorized over the worlds: the pairs of every world with
        n collision shapes come from one triangular index table."""
        COLL = int(ShapeFlags.COLLIDE_SHAPES)
        flags = np.asarray(self.shape_flags, dtype=np.int64).reshape(-1)
        world = np.asarray(self.shape_world, dtype=np.int64).reshape(-1)
        body = np.asarray(self.shape_body, dtype=np.int64).reshape(-1)
        coll = np.nonzero(flags & COLL)[0]
        glob = coll[world[coll] < 0]
        local = coll[world[coll] >= 0]
        local = local[np.argsort(world[local], kind="stable")]
        parts = []
        if len(local):
            w = world[local]
            starts = np.flatnonzero(np.r_[True, w[1:] != w[:-1]])
            lens = np.diff(np.r_[starts, len(local)])
            for n in np.unique(lens):
                i, j = np.triu_indices(int(n), 1)
                st0 = starts[lens == n][:, None]
                parts.append(np.stack([local[st0 + i].reshape(-1),
                                       local[st0 + j].reshape(-1)], 1))
            if len(glob):
                a = np.repeat(local, len(glob))
                g = np.tile(glob, len(local))
                static = body[g] < 0
                parts.append(np.stack([np.where(static, a, g),
                                       np.where(static, g, a)], 1))
        i, j = np.triu_indices(len(glob), 1)
        parts.append(np.stack([glob[i], glob[j]], 1))
        pairs = np.concatenate(parts).reshape(-1, 2)
        pairs = pairs[self._collide_mask(pairs[:, 0], pairs[:, 1])]
        pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
        typ = np.asarray(self.shape_type, dtype=np.int64).reshape(-1)
        slots = np.zeros(len(pairs) + 1, dtype=np.int32)
        if len(pairs):
            t0, t1 = typ[pairs[:, 0]], typ[pairs[:, 1]]
            table = {k: pair_slot_count(*k)
                     for k in set(zip(t0.tolist(), t1.tolist()))}
            code = t0 * 64 + t1
            per = np.zeros(len(pairs), dtype=np.int64)
            for (x, y), k in table.items():
                per[code == x * 64 + y] = k
            slots[1:] = np.cumsum(per)
        return pairs.astype(np.int32), slots, int(slots[-1])

    def _compute_soft_pairs(self):
        """Particle-shape candidates, one soft contact slot each: every
        particle with every shape that collides with particles in its
        world or in no world (a global particle meets every such shape),
        sorted by particle then shape (the JAX builder's set and order).
        Rows of particles at a time, so the mask stays small."""
        COLL = int(ShapeFlags.COLLIDE_PARTICLES)
        flags = np.asarray(self.shape_flags, dtype=np.int64).reshape(-1)
        shapes = np.nonzero(flags & COLL)[0]
        sw = np.asarray(self.shape_world, dtype=np.int64).reshape(-1)[shapes]
        pw = np.asarray(self.particle_world, dtype=np.int64).reshape(-1)
        parts = [np.zeros((0, 2), dtype=np.int64)]
        rows = max(1, (1 << 24) // max(len(shapes), 1))
        for s in range(0, len(pw) if len(shapes) else 0, rows):
            w = pw[s:s + rows, None]
            p, k = np.nonzero((w == -1) | (sw[None] == -1) | (w == sw[None]))
            parts.append(np.stack([p + s, shapes[k]], 1))
        pairs = np.concatenate(parts).astype(np.int32)
        return pairs, len(pairs)

    def _collision_radius(self) -> np.ndarray:
        """Per-shape bounding radius: sphere r, box |half-extents|, capsule,
        cylinder and cone r + half height, ellipsoid its largest radius,
        plane MAXVAL; mesh kinds as ``mesh_prep.mesh_collision_radius``."""
        typ = np.asarray(self.shape_type, dtype=np.int64).reshape(-1)
        sc = np.asarray(self.shape_scale, dtype=np.float64).reshape(-1, 3)
        r = np.select(
            [typ == int(GeoType.SPHERE), typ == int(GeoType.BOX),
             np.isin(typ, [int(GeoType.CAPSULE), int(GeoType.CYLINDER),
                           int(GeoType.CONE)]),
             typ == int(GeoType.ELLIPSOID)],
            [sc[:, 0], np.linalg.norm(sc, axis=1), sc[:, 0] + sc[:, 1],
             sc.max(axis=1, initial=0.0)],
            MAXVAL)
        for s in np.nonzero(np.isin(typ, MESH_KINDS))[0].tolist():
            r[s] = mesh_collision_radius(int(typ[s]), sc[s],
                                         self.shape_source[s])
        return r

    # ------------------------------------------------------------------
    def finalize(self, device="cuda") -> Model:
        """Build the Model with float32 tensors on ``device``: the card by
        default (raises where CUDA is absent; pass ``"cpu"`` to build on
        the CPU)."""
        if self._current_world != -1:
            raise RuntimeError("finalize() called inside an open world "
                               "scope")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("finalize(): CUDA is not available; pass "
                               "device='cpu' to build the model on the CPU")
        st = ModelStructure()
        st.world_count = max(self.world_count, 1)
        st.body_count = self.body_count
        st.shape_count = self.shape_count
        st.joint_count = self.joint_count
        st.joint_coord_count = self.joint_coord_count
        st.joint_dof_count = self.joint_dof_count
        st.articulation_count = self.articulation_count
        st.particle_count = self.particle_count
        st.spring_count, st.tri_count = self.spring_count, self.tri_count
        st.edge_count, st.tet_count = self.edge_count, self.tet_count
        st.mjc_actuation = self.mjc_actuation
        st.mjc_options = dict(self.mjc_options)
        # spatial tendons; a NaN rest length is the build-pose length
        # (MuJoCo springlength=-1)
        st.sten_count = len(self.sten_params)
        st.sten_paths = list(self.sten_paths)
        st.sten_key = list(self.sten_key)
        sten_params = np.asarray(self.sten_params,
                                 dtype=np.float64).reshape(-1, 3)
        unset = np.nonzero(np.isnan(sten_params[:, 2]))[0]
        if len(unset):
            sten_params[unset, 2] = spatial_tendon_rest_lengths(
                [st.sten_paths[k] for k in unset], self.body_q)
        st.muscle_count = len(self.muscle_params)
        st.muscle_start = np.asarray(
            self.muscle_start + [len(self.muscle_bodies)], dtype=np.int32)

        i32 = np.int32
        st.joint_type = np.asarray(self.joint_type, dtype=i32)
        st.joint_parent = np.asarray(self.joint_parent, dtype=i32)
        st.joint_child = np.asarray(self.joint_child, dtype=i32)
        st.joint_q_start = np.asarray(self.joint_q_start, dtype=i32)
        st.joint_qd_start = np.asarray(self.joint_qd_start, dtype=i32)
        st.joint_dof_dim = np.asarray(self.joint_dof_dim,
                                      dtype=i32).reshape(-1, 2)
        st.joint_world = np.asarray(self.joint_world, dtype=i32)
        st.articulation_start = np.asarray(
            self.articulation_start + [self.joint_count], dtype=i32)
        st.articulation_world = np.asarray(self.articulation_world,
                                           dtype=i32)
        child_of = np.full(self.body_count + 1, -1, dtype=i32)
        child_of[st.joint_child] = np.arange(self.joint_count, dtype=i32)
        st.joint_parent_joint = child_of[st.joint_parent]   # -1 -> last
        st.body_world = np.asarray(self.body_world, dtype=i32)
        st.shape_world = np.asarray(self.shape_world, dtype=i32)
        st.particle_world = np.asarray(self.particle_world, dtype=i32)
        st.shape_body = np.asarray(self.shape_body, dtype=i32)
        st.shape_type = np.asarray(self.shape_type, dtype=i32)
        st.shape_flags = np.asarray(self.shape_flags, dtype=i32)
        st.shape_filter_pairs = set(self.shape_collision_filter_pairs)
        st.shape_collision_group = np.asarray(self.shape_collision_group,
                                              dtype=i32)
        st.body_key = list(self.body_key)
        st.joint_key = list(self.joint_key)
        st.shape_key = list(self.shape_key)

        st.candidate_pairs, st.candidate_pair_slots, st.rigid_contact_max = \
            self._compute_candidate_pairs()
        counts = np.diff(st.candidate_pair_slots)
        st.slot_shape0 = np.repeat(st.candidate_pairs[:, 0], counts).astype(i32)
        st.slot_shape1 = np.repeat(st.candidate_pairs[:, 1], counts).astype(i32)
        sb = st.shape_body
        st.slot_body0 = np.where(st.slot_shape0 >= 0,
                                 sb[np.maximum(st.slot_shape0, 0)],
                                 -1).astype(i32)
        st.slot_body1 = np.where(st.slot_shape1 >= 0,
                                 sb[np.maximum(st.slot_shape1, 0)],
                                 -1).astype(i32)

        st.soft_pairs, st.soft_contact_max = self._compute_soft_pairs()
        mesh_tensors, mesh_st = prepare_mesh_data(self, st.candidate_pairs,
                                                  device)
        for name, v in mesh_st.items():
            setattr(st, name, v)
        st.eq_count = len(self.eq_type)
        st.eq_type = np.asarray(self.eq_type, dtype=i32)
        st.eq_world = np.asarray(self.eq_world, dtype=i32)

        # fixed tendons, padded to the longest with coef 0 at coordinate
        # and dof 0 (the JAX builder's layout); an entry is its axis's own
        # coordinate and dof
        st.tendon_count = T = len(self.tendon_params)
        K = max((len(js) for js in self.tendon_joints), default=1)
        st.tendon_coord = np.zeros((T, K), dtype=i32)
        st.tendon_dof = np.zeros((T, K), dtype=i32)
        st.tendon_coef = np.zeros((T, K))
        if T:
            n = np.asarray([len(js) for js in self.tendon_joints])
            row = np.repeat(np.arange(T), n)
            col = np.arange(len(row)) - np.repeat(np.cumsum(n) - n, n)
            j = np.concatenate(self.tendon_joints).astype(np.int64)
            a = np.concatenate(self.tendon_axes).astype(np.int64)
            st.tendon_coord[row, col] = st.joint_q_start[j] + a
            st.tendon_dof[row, col] = st.joint_qd_start[j] + a
            st.tendon_coef[row, col] = np.concatenate(self.tendon_coefs)

        # custom attribute arrays
        custom = {}
        per = {AttributeFrequency.JOINT_DOF: (st.joint_dof_count,),
               AttributeFrequency.JOINT_COORD: (st.joint_coord_count,),
               AttributeFrequency.ONCE: ()}
        for name, (spec, values) in self.custom_attributes.items():
            arr = np.full(per[spec.frequency] + tuple(spec.shape),
                          spec.default, dtype=np.float32)
            if values:
                arr[np.fromiter(values.keys(), dtype=np.int64,
                                count=len(values))] = list(values.values())
            custom[name] = torch.as_tensor(arr, device=device)
        st.custom_specs = {name: spec for name, (spec, _)
                           in self.custom_attributes.items()}

        B = self.body_count
        body_inertia = np.stack(self.body_inertia) if B \
            else np.zeros((0, 3, 3))
        mass = np.asarray(self.body_mass, dtype=np.float64)
        inv_mass = np.where(mass > 0, 1.0 / np.maximum(mass, 1e-30), 0.0)
        inv_inertia = np.zeros_like(body_inertia)
        if B:
            ok = (mass > 0) & (np.linalg.det(body_inertia) > 1e-18)
            safe = np.where(ok[:, None, None], body_inertia, np.eye(3)[None])
            inv_inertia = np.where(ok[:, None, None], np.linalg.inv(safe),
                                   0.0)
            kin = (np.asarray(self.body_flags, dtype=np.int64)
                   & int(BodyFlags.KINEMATIC)) != 0
            inv_mass[kin] = 0.0
            inv_inertia[kin] = 0.0

        def f32(x, shape_if_empty=(0,)):
            a = np.asarray(x, dtype=np.float64)
            if a.size == 0:
                a = np.zeros(shape_if_empty)
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        def i32t(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int32),
                                   device=device)

        def table(rows, shape, to=None):
            a = np.asarray(rows, dtype=np.float64 if to is None
                           else np.int64).reshape((-1,) + shape)
            return f32(a, a.shape) if to is None else to(a)

        def stack(xs, width):
            return f32(np.stack(xs) if len(xs) else np.zeros((0, width)),
                       (0, width))

        # per-world gravity; worlds past the last begin_world (none in a
        # model without world scopes) take the builder's
        gravity = np.tile(self._gravity_vec(), (st.world_count, 1))
        if self.world_gravity:
            gravity[:len(self.world_gravity)] = np.stack(self.world_gravity)
        pmass = np.asarray(self.particle_mass, dtype=np.float64)
        return Model(
            body_q=stack(self.body_q, 7),
            body_qd=stack(self.body_qd, 6),
            body_com=stack(self.body_com, 3),
            body_mass=f32(mass),
            body_inv_mass=f32(inv_mass),
            body_inertia=f32(body_inertia, (0, 3, 3)),
            body_inv_inertia=f32(inv_inertia, (0, 3, 3)),
            body_flags=i32t(self.body_flags),
            shape_transform=stack(self.shape_transform, 7),
            shape_body=i32t(st.shape_body),
            shape_type=i32t(st.shape_type),
            shape_scale=stack(self.shape_scale, 3),
            shape_flags=i32t(st.shape_flags),
            shape_thickness=f32(self.shape_thickness),
            shape_collision_radius=f32(self._collision_radius()),
            shape_material_mu=f32(self.shape_material_mu),
            shape_material_restitution=f32(self.shape_material_restitution),
            shape_material_kh=f32(self.shape_material_kh),
            shape_world=i32t(st.shape_world),
            joint_type_arr=i32t(st.joint_type),
            joint_parent=i32t(st.joint_parent),
            joint_child=i32t(st.joint_child),
            joint_X_p=stack(self.joint_X_p, 7),
            joint_X_c=stack(self.joint_X_c, 7),
            joint_axis=stack(self.joint_axis, 3),
            joint_armature=f32(self.joint_armature),
            joint_target_ke=f32(self.joint_target_ke),
            joint_target_kd=f32(self.joint_target_kd),
            joint_limit_lower=f32(self.joint_limit_lower),
            joint_limit_upper=f32(self.joint_limit_upper),
            joint_limit_ke=f32(self.joint_limit_ke),
            joint_limit_kd=f32(self.joint_limit_kd),
            joint_friction=f32(self.joint_friction),
            joint_effort_limit=f32(self.joint_effort_limit),
            joint_velocity_limit=f32(self.joint_velocity_limit),
            joint_qd0=f32(self.joint_qd),
            joint_q0=f32(self.joint_q),
            joint_target_q0=f32(self.joint_target_q),
            gravity=f32(gravity),
            tendon_params=f32(self.tendon_params, (0, 3)),
            sten_params=f32(sten_params, (0, 3)),
            muscle_params=f32(np.asarray(self.muscle_params,
                                         dtype=np.float64).reshape(-1, 7),
                              (0, 7)),
            muscle_bodies=i32t(self.muscle_bodies),
            muscle_points=stack(self.muscle_points, 3),
            particle_q=stack(self.particle_q, 3),
            particle_qd=stack(self.particle_qd, 3),
            particle_mass=f32(pmass),
            particle_inv_mass=f32(np.divide(1.0, pmass, where=pmass > 0,
                                            out=np.zeros_like(pmass))),
            particle_radius=f32(self.particle_radius),
            particle_flags=i32t(self.particle_flags),
            spring_indices=table(self.spring_indices, (2,), i32t),
            spring_rest_length=f32(self.spring_rest_length),
            spring_stiffness=f32(self.spring_stiffness),
            spring_damping=f32(self.spring_damping),
            tri_indices=table(self.tri_indices, (3,), i32t),
            tri_poses=table(self.tri_poses, (2, 2)),
            tri_materials=table(self.tri_materials, (5,)),
            tri_areas=f32(self.tri_areas),
            edge_indices=table(self.edge_indices, (4,), i32t),
            edge_rest_angle=f32(self.edge_rest_angle),
            edge_rest_length=f32(self.edge_rest_length),
            edge_bending_properties=table(self.edge_bending_properties,
                                          (2,)),
            tet_indices=table(self.tet_indices, (4,), i32t),
            tet_poses=table(self.tet_poses, (3, 3)),
            tet_materials=table(self.tet_materials, (3,)),
            **{name: f32(getattr(self, name)) for name in (
                "particle_ke", "particle_kd", "particle_kf", "particle_mu",
                "particle_max_velocity", "soft_contact_ke",
                "soft_contact_kd", "soft_contact_kf", "soft_contact_mu",
                "soft_contact_margin")},
            eq_obj1=i32t(self.eq_obj1),
            eq_obj2=i32t(self.eq_obj2),
            eq_anchor=stack(self.eq_anchor, 3),
            eq_relpose=stack(self.eq_relpose, 7),
            eq_polycoef=stack(self.eq_polycoef, 5),
            eq_enabled=torch.as_tensor(np.asarray(self.eq_enabled,
                                                  dtype=bool), device=device),
            eq_torquescale=f32(self.eq_torquescale),
            custom=custom,
            structure=st,
            **mesh_tensors,
        )
