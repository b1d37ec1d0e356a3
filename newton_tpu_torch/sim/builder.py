"""Scene authoring: host-side ``ModelBuilder`` -> ``Model`` on a device.

Port of the subset of ``newton_tpu/sim/builder.py`` that the gymnasium
robots, the reference's replicated-world KPI scenes and the MPM path drive:
bodies, articulations, free/revolute/prismatic/fixed joints and D6 joints
with linear and angular axes, fixed tendons, plane/sphere/capsule shapes with
density-driven mass, particles, world contexts (``begin_world``,
``add_world``, ``add_builder`` and the vectorized ``replicate``) with
per-world gravity, MJCF-style collision filtering, the static candidate
contact pairs with their slot layout, and ``finalize`` onto an explicit
device. Host storage is float64 numpy, like the JAX builder; the
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
    compute_capsule_inertia,
    compute_sphere_inertia,
    transform_inertia,
)
from ..geometry.narrow_phase import pair_slot_count
from ..geometry.types import GeoType, ShapeFlags
from ..solvers.generalized.actuation import MJCActuation
from .enums import BodyFlags, JointType, ParticleFlags
from .model import (
    AttributeAssignment,
    AttributeFrequency,
    AttributeSpec,
    Model,
    ModelStructure,
)

__all__ = ["ModelBuilder", "ShapeConfig", "JointDofConfig"]

_JOINT_TYPES = (JointType.FREE, JointType.REVOLUTE, JointType.PRISMATIC,
                JointType.FIXED, JointType.D6)
_SHAPE_TYPES = (GeoType.PLANE, GeoType.SPHERE, GeoType.CAPSULE)
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


@dataclass
class ShapeConfig:
    """Shape defaults (same fields and defaults as the JAX builder's)."""

    density: float = 1000.0
    mu: float = 0.5
    restitution: float = 0.0
    thickness: float = 1.0e-5
    collision_group: int = 1
    has_shape_collision: bool = True
    has_particle_collision: bool = True
    is_visible: bool = True
    contype: int = 1
    conaffinity: int = 1

    @property
    def flags(self) -> int:
        f = 0
        if self.is_visible:
            f |= int(ShapeFlags.VISIBLE)
        if self.has_shape_collision:
            f |= int(ShapeFlags.COLLIDE_SHAPES)
        if self.has_particle_collision:
            f |= int(ShapeFlags.COLLIDE_PARTICLES)
        return f

    def copy(self) -> "ShapeConfig":
        return dc_replace(self)


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

        # particles
        self.particle_q: List[np.ndarray] = []
        self.particle_qd: List[np.ndarray] = []
        self.particle_mass: List[float] = []
        self.particle_radius: List[float] = []
        self.particle_flags: List[int] = []
        self.particle_world: List[int] = []

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
        t0 = len(self.tendon_params)
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
                     "shape_conaffinity", "shape_key"):
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
        # particles
        self.particle_q += copies(o.particle_q)
        self.particle_qd += copies(o.particle_qd)
        self.particle_mass += list(o.particle_mass) * count
        self.particle_radius += list(o.particle_radius) * count
        self.particle_flags += list(o.particle_flags) * count
        self.particle_world += per_world(npart)
        self._merge_mjcf_data(o, count, d0, q0, t0)

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
                     "shape_conaffinity"):
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
        # particles
        for p, v in zip(other.particle_q, other.particle_qd):
            self.particle_q.append(np.asarray(p) if X is None
                                   else np_transform_point(X, p))
            self.particle_qd.append(np.asarray(v) if X is None
                                    else np_transform_vector(X, v))
        self.particle_mass += list(other.particle_mass)
        self.particle_radius += list(other.particle_radius)
        self.particle_flags += list(other.particle_flags)
        self.particle_world += [w] * other.particle_count
        self._merge_mjcf_data(other, 1, d0, q0, t0)

    def _merge_mjcf_data(self, o: "ModelBuilder", count: int, d0: int,
                         q0: int, t0: int) -> None:
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
        nt = len(o.tendon_params)
        rep = MJCActuation(au.n * count)
        for name, base, stride in (("dof", d0, nd), ("coord", q0, nq),
                                   ("tendon", t0, nt), ("sten", 0, 0)):
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
        if "mjc:ctrl" in self.custom_attributes:
            spec, values = self.custom_attributes["mjc:ctrl"]
            self.custom_attributes["mjc:ctrl"] = (
                dc_replace(spec, shape=(rep.n,)), values)

    # ------------------------------------------------------------------
    # bodies, articulations, joints
    # ------------------------------------------------------------------
    def add_body(self, xform=None, com=None, I_m=None, mass: float = 0.0,
                 key: Optional[str] = None) -> int:
        """Add a rigid body; mass and inertia accumulate from shapes."""
        idx = self.body_count
        self.body_q.append(_as_transform(xform))
        self.body_qd.append(np.zeros(6))
        self.body_com.append(np.zeros(3) if com is None
                             else np.asarray(com, dtype=np.float64))
        self.body_mass.append(float(mass))
        self.body_inertia.append(np.zeros((3, 3)) if I_m is None
                                 else np.asarray(I_m, dtype=np.float64))
        self.body_flags.append(int(BodyFlags.NONE))
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
        """Free, revolute, prismatic, fixed or D6 joint between
        ``parent`` (-1 = world) and ``child``. A prismatic joint takes one
        linear axis, a D6 joint 0-3 linear and 0-3 angular axes (at least
        one), each a dof with its own limits, armature and gains. A D6
        joint's linear dofs and coordinates come first, then its angular
        ones: it translates along its linear axes in the parent-anchor
        frame, then rotates about the translated anchor."""
        joint_type = JointType(joint_type)
        if joint_type not in _JOINT_TYPES:
            raise NotImplementedError(
                f"joint type {joint_type.name} is not ported yet")
        linear = list(linear_axes or [])
        angular = list(angular_axes or [])
        if linear and joint_type not in (JointType.PRISMATIC, JointType.D6):
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

        if joint_type == JointType.FREE:
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

    def add_joint_free(self, child: int, parent: int = -1, xform_p=None,
                       xform_c=None, armature: Optional[float] = None,
                       key: Optional[str] = None) -> int:
        cfg = self.default_joint_cfg.copy()
        cfg.armature = 0.0 if armature is None else armature
        return self.add_joint(JointType.FREE, parent, child,
                              angular_axes=[cfg], xform_p=xform_p,
                              xform_c=xform_c, key=key)

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
                  key: Optional[str] = None) -> int:
        """Collision shape attached to ``body`` (-1 = static)."""
        geo_type = GeoType(geo_type)
        if geo_type not in _SHAPE_TYPES:
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
        self.shape_key.append(key or f"shape_{idx}")
        self.shape_world.append(self._current_world)

        if body >= 0 and cfg.density > 0.0:
            sc = self.shape_scale[idx]
            if geo_type == GeoType.SPHERE:
                m, c, I = compute_sphere_inertia(cfg.density, sc[0])
            elif geo_type == GeoType.CAPSULE:
                m, c, I = compute_capsule_inertia(cfg.density, sc[0], sc[1])
            else:
                m = 0.0
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

    def add_shape_capsule(self, body: int, xform=None, radius: float = 1.0,
                          half_height: float = 0.5, axis: AxisType = Axis.Z,
                          cfg: Optional[ShapeConfig] = None,
                          key: Optional[str] = None) -> int:
        """Capsule along +Z in the shape frame; ``axis`` rotates it."""
        q = np_quat_between_axes(np.array([0.0, 0.0, 1.0]),
                                 axis_to_vec3(axis))
        xf = np_transform_multiply(_as_transform(xform), np_transform(q=q))
        return self.add_shape(body, GeoType.CAPSULE, xf,
                              scale=(radius, half_height, 0.0), cfg=cfg,
                              key=key)

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

    def _collision_radius(self) -> np.ndarray:
        """Per-shape bounding radius: sphere r, capsule r + half height,
        plane MAXVAL."""
        typ = np.asarray(self.shape_type, dtype=np.int64).reshape(-1)
        sc = np.asarray(self.shape_scale, dtype=np.float64).reshape(-1, 3)
        return np.where(typ == int(GeoType.SPHERE), sc[:, 0],
                        np.where(typ == int(GeoType.CAPSULE),
                                 sc[:, 0] + sc[:, 1], MAXVAL))

    # ------------------------------------------------------------------
    def finalize(self, device) -> Model:
        """Build the Model with float32 tensors on ``device``."""
        if self._current_world != -1:
            raise RuntimeError("finalize() called inside an open world "
                               "scope")
        device = torch.device(device)
        st = ModelStructure()
        st.world_count = max(self.world_count, 1)
        st.body_count = self.body_count
        st.shape_count = self.shape_count
        st.joint_count = self.joint_count
        st.joint_coord_count = self.joint_coord_count
        st.joint_dof_count = self.joint_dof_count
        st.articulation_count = self.articulation_count
        st.particle_count = self.particle_count
        st.mjc_actuation = self.mjc_actuation
        st.mjc_options = dict(self.mjc_options)

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

        def f32(x, shape_if_empty=(0,)):
            a = np.asarray(x, dtype=np.float64)
            if a.size == 0:
                a = np.zeros(shape_if_empty)
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        def i32t(x):
            return torch.as_tensor(np.asarray(x, dtype=np.int32),
                                   device=device)

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
            particle_q=stack(self.particle_q, 3),
            particle_qd=stack(self.particle_qd, 3),
            particle_mass=f32(pmass),
            particle_inv_mass=f32(np.divide(1.0, pmass, where=pmass > 0,
                                            out=np.zeros_like(pmass))),
            particle_radius=f32(self.particle_radius),
            particle_flags=i32t(self.particle_flags),
            custom=custom,
            structure=st,
        )
