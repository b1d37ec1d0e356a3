"""Scene authoring: host-side ``ModelBuilder`` -> ``Model`` on a device.

Port of the subset of ``newton_tpu/sim/builder.py`` that the gymnasium ant
and humanoid MJCF files and the MPM path drive: bodies, one articulation,
free/revolute/fixed joints, plane/sphere/capsule shapes with density-driven
mass, particles, MJCF-style collision filtering, the static candidate
contact pairs with their slot layout, and ``finalize`` onto an explicit
device. Host storage is float64 numpy, like the JAX builder; the
candidate-pair order and slot offsets are the JAX builder's exactly,
because the solvers' contact rows follow them.
"""

from __future__ import annotations

from dataclasses import dataclass, replace as dc_replace
from typing import Dict, List, Optional, Sequence, Set, Tuple

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
from .enums import BodyFlags, JointType, ParticleFlags
from .model import (
    AttributeAssignment,
    AttributeFrequency,
    AttributeSpec,
    Model,
    ModelStructure,
)

__all__ = ["ModelBuilder", "ShapeConfig", "JointDofConfig"]

_JOINT_TYPES = (JointType.FREE, JointType.REVOLUTE, JointType.FIXED)
_SHAPE_TYPES = (GeoType.PLANE, GeoType.SPHERE, GeoType.CAPSULE)


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

        # particles; the port's builder has no world contexts, so every
        # particle is global (world -1), as the reference's outside one
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
        return idx

    def add_articulation(self, key: Optional[str] = None) -> int:
        idx = self.articulation_count
        self.articulation_start.append(self.joint_count)
        self.articulation_key.append(key or f"articulation_{idx}")
        return idx

    def add_joint(self, joint_type: JointType, parent: int, child: int,
                  angular_axes: Optional[Sequence[JointDofConfig]] = None,
                  xform_p=None, xform_c=None, key: Optional[str] = None,
                  collision_filter_parent: bool = True) -> int:
        """Free, revolute or fixed joint between ``parent`` (-1 = world) and
        ``child``."""
        joint_type = JointType(joint_type)
        if joint_type not in _JOINT_TYPES:
            raise NotImplementedError(
                f"joint type {joint_type.name} is not ported yet")
        axes = list(angular_axes or [])
        if joint_type == JointType.REVOLUTE and len(axes) != 1:
            raise ValueError("a revolute joint takes exactly one axis")
        if joint_type == JointType.FIXED:
            axes = []
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
        self.joint_dof_dim.append((0, len(axes)))

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
        self.particle_world.append(-1)
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
        self.particle_world.extend([-1] * n)
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
    def _should_collide(self, a: int, b: int) -> bool:
        if a == b:
            return False
        ba, bb = self.shape_body[a], self.shape_body[b]
        if ba == bb or (ba < 0 and bb < 0):
            return False
        COLL = int(ShapeFlags.COLLIDE_SHAPES)
        if not (self.shape_flags[a] & COLL) or not (self.shape_flags[b] & COLL):
            return False
        ct_a, ca_a = self.shape_contype[a], self.shape_conaffinity[a]
        ct_b, ca_b = self.shape_contype[b], self.shape_conaffinity[b]
        if not ((ct_a & ca_b) or (ct_b & ca_a)):
            return False
        ga, gb = self.shape_collision_group[a], self.shape_collision_group[b]
        if ga == 0 or gb == 0:
            return False
        if ga > 0 and not (ga == gb or gb < 0):
            return False
        if ga < 0 and ga == gb:
            return False
        if (min(a, b), max(a, b)) in self.shape_collision_filter_pairs:
            return False
        if ba >= 0 and bb >= 0 and \
                (min(ba, bb), max(ba, bb)) in self._body_filter_pairs:
            return False
        plane = int(GeoType.PLANE)
        if self.shape_type[a] == plane and self.shape_type[b] == plane:
            return False
        return True

    def _compute_candidate_pairs(self):
        """All shape pairs that can ever collide, sorted, with cumulative
        contact-slot offsets (the JAX builder's single-world order: every
        entity here is global, world -1)."""
        COLL = int(ShapeFlags.COLLIDE_SHAPES)
        shapes = [s for s in range(self.shape_count)
                  if self.shape_flags[s] & COLL]
        pairs = [(a, b) for i, a in enumerate(shapes) for b in shapes[i + 1:]
                 if self._should_collide(a, b)]
        pairs.sort()
        slots = np.zeros(len(pairs) + 1, dtype=np.int32)
        for i, (a, b) in enumerate(pairs):
            slots[i + 1] = slots[i] + pair_slot_count(self.shape_type[a],
                                                      self.shape_type[b])
        arr = np.asarray(pairs, dtype=np.int32).reshape(-1, 2)
        return arr, slots, int(slots[-1])

    def _collision_radius(self, s: int) -> float:
        g = GeoType(self.shape_type[s])
        sc = self.shape_scale[s]
        if g == GeoType.SPHERE:
            return float(sc[0])
        if g == GeoType.CAPSULE:
            return float(sc[0] + sc[1])
        return MAXVAL                                   # plane

    # ------------------------------------------------------------------
    def finalize(self, device) -> Model:
        """Build the Model with float32 tensors on ``device``."""
        device = torch.device(device)
        st = ModelStructure()
        st.world_count = 1
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
        st.joint_world = np.full(self.joint_count, -1, dtype=i32)
        st.articulation_start = np.asarray(
            self.articulation_start + [self.joint_count], dtype=i32)
        st.articulation_world = np.full(self.articulation_count, -1,
                                        dtype=i32)
        child_of = {c: j for j, c in enumerate(self.joint_child)}
        st.joint_parent_joint = np.asarray(
            [child_of.get(p, -1) for p in self.joint_parent], dtype=i32)
        st.body_world = np.full(self.body_count, -1, dtype=i32)
        st.shape_world = np.full(self.shape_count, -1, dtype=i32)
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

        # custom attribute arrays
        custom = {}
        for name, (spec, values) in self.custom_attributes.items():
            shape = (spec.shape if spec.frequency == AttributeFrequency.ONCE
                     else (st.joint_dof_count, *spec.shape))
            arr = np.full(shape, spec.default, dtype=np.float32)
            for k, v in values.items():
                arr[k] = v
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

        S = self.shape_count
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
            shape_collision_radius=f32([self._collision_radius(s)
                                        for s in range(S)]),
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
            gravity=f32([[0.0, 0.0, self.gravity]]),
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
