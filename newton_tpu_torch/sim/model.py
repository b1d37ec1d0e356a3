"""The finalized simulation model (port of ``newton_tpu/sim/model.py``).

``Model`` is a dataclass of tensors on one device; ``ModelStructure`` holds
the host-side numpy topology (counts, joint tree, candidate contact pairs,
actuation tables) that the solvers turn into static index tensors once, at
construction. The port carries the fields the robot, MPM and cloth paths
read; the names match the JAX package's so the bridge (utils/bridge.py)
maps them 1:1.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields, replace
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .control import Control
from .state import State

__all__ = ["Model", "ModelStructure", "AttributeFrequency",
           "AttributeAssignment", "AttributeSpec", "MODEL_FLOAT_FIELDS",
           "MODEL_INT_FIELDS", "MODEL_BOOL_FIELDS", "MODEL_UINT8_FIELDS"]


class AttributeFrequency(enum.Enum):
    """Entity group a custom attribute is allocated per."""

    JOINT_DOF = "joint_dof"
    JOINT_COORD = "joint_coord"
    ONCE = "once"


class AttributeAssignment(enum.Enum):
    """Which container a custom attribute lives on."""

    MODEL = "model"
    STATE = "state"
    CONTROL = "control"


@dataclass
class AttributeSpec:
    name: str
    frequency: AttributeFrequency
    assignment: AttributeAssignment = AttributeAssignment.MODEL
    shape: Tuple[int, ...] = ()
    default: float = 0.0


class ModelStructure:
    """Static host-side topology. Fields keep the JAX package's names."""

    def __init__(self):
        self.world_count = 1
        self.body_count = 0
        self.shape_count = 0
        self.joint_count = 0
        self.joint_coord_count = 0
        self.joint_dof_count = 0
        self.articulation_count = 0
        self.particle_count = 0
        self.spring_count = 0
        self.tri_count = 0
        self.edge_count = 0
        self.tet_count = 0
        self.eq_count = 0
        self.tendon_count = 0
        self.sten_count = 0
        self.sten_paths: List[Any] = []       # sim/tendon.SpatialTendonPath
        self.sten_key: List[str] = []
        self.muscle_count = 0
        self.muscle_start = np.zeros(1, dtype=np.int32)
        self.up_axis = 2

        self.joint_type = np.zeros(0, dtype=np.int32)
        self.joint_parent = np.zeros(0, dtype=np.int32)
        self.joint_child = np.zeros(0, dtype=np.int32)
        self.joint_q_start = np.zeros(1, dtype=np.int32)
        self.joint_qd_start = np.zeros(1, dtype=np.int32)
        self.joint_dof_dim = np.zeros((0, 2), dtype=np.int32)
        self.joint_world = np.zeros(0, dtype=np.int32)
        self.joint_parent_joint = np.zeros(0, dtype=np.int32)
        self.articulation_start = np.zeros(1, dtype=np.int32)
        self.articulation_world = np.zeros(0, dtype=np.int32)
        self.body_world = np.zeros(0, dtype=np.int32)
        self.particle_world = np.zeros(0, dtype=np.int32)
        self.shape_world = np.zeros(0, dtype=np.int32)
        self.shape_body = np.zeros(0, dtype=np.int32)
        self.shape_type = np.zeros(0, dtype=np.int32)
        self.shape_flags = np.zeros(0, dtype=np.int32)
        self.shape_collision_group = np.zeros(0, dtype=np.int32)
        self.eq_world = np.zeros(0, dtype=np.int32)
        self.eq_type = np.zeros(0, dtype=np.int32)

        self.body_key: List[str] = []
        self.articulation_key: List[str] = []
        self.joint_key: List[str] = []
        self.shape_key: List[str] = []
        # shape pairs excluded from collision, (lower, higher) index
        self.shape_filter_pairs: set = set()

        # collision candidates: pairs, cumulative slot offsets, slot maps
        self.candidate_pairs = np.zeros((0, 2), dtype=np.int32)
        self.candidate_pair_slots = np.zeros(1, dtype=np.int32)
        self.rigid_contact_max = 0
        # particle-shape candidates (particle, shape), sorted; one soft
        # contact slot each
        self.soft_pairs = np.zeros((0, 2), dtype=np.int32)
        self.soft_contact_max = 0
        self.slot_shape0 = np.zeros(0, dtype=np.int32)
        self.slot_shape1 = np.zeros(0, dtype=np.int32)
        self.slot_body0 = np.zeros(0, dtype=np.int32)
        self.slot_body1 = np.zeros(0, dtype=np.int32)
        # mesh kinds (sim/mesh_prep.py): each shape's dense SDF grid and
        # sparse texture in the pools (-1: none), hull vertex clouds
        # (S, H, 3) float32 (boxes' corners, hulls' vertices), and the mean
        # vector area of each shape's samples (float64)
        self.shape_sdf_id = np.zeros(0, dtype=np.int32)
        self.shape_sdf_tex_id = np.zeros(0, dtype=np.int32)
        self.shape_hull_verts = np.zeros((0, 1, 3), dtype=np.float32)
        self.shape_sample_cell_area = np.zeros(0)
        # geometry sources: the meshes pooled by object identity, SDFs and
        # heightfields in shape order, each shape's index into its kind's
        # list (-1: none); the Gaussian splat clouds as (shape, source
        # dict) for the viewers and the tiled camera
        self.meshes: List[Any] = []
        self.sdfs: List[Any] = []
        self.heightfields: List[Any] = []
        self.shape_source_id = np.zeros(0, dtype=np.int32)
        self.gaussians: List[Tuple[int, Dict[str, Any]]] = []

        # fixed tendons (T, K): coordinate, dof and coefficient per entry
        self.tendon_coord = np.zeros((0, 1), dtype=np.int32)
        self.tendon_dof = np.zeros((0, 1), dtype=np.int32)
        self.tendon_coef = np.zeros((0, 1))

        self.mjc_actuation = None
        self.mjc_options: Dict[str, Any] = {}
        self.custom_specs: Dict[str, AttributeSpec] = {}


# tensor fields of Model, by dtype (the bridge and the tests iterate these)
MODEL_FLOAT_FIELDS = (
    "body_q", "body_qd", "body_com", "body_mass", "body_inv_mass",
    "body_inertia", "body_inv_inertia",
    "shape_transform", "shape_scale", "shape_thickness",
    "shape_collision_radius", "shape_material_mu",
    "shape_material_restitution", "shape_material_kh",
    "shape_sample_points", "shape_sample_areas",
    "sdf_grids", "sdf_lower", "sdf_upper", "sdf_tex_scale",
    "sdf_tex_offset", "sdf_tex_coarse", "sdf_tex_lower", "sdf_tex_upper",
    "joint_X_p", "joint_X_c", "joint_axis", "joint_armature",
    "joint_target_ke", "joint_target_kd", "joint_limit_lower",
    "joint_limit_upper", "joint_limit_ke", "joint_limit_kd",
    "joint_friction", "joint_effort_limit", "joint_velocity_limit",
    "joint_qd0", "joint_q0", "joint_target_q0", "gravity", "tendon_params",
    "sten_params", "muscle_params", "muscle_points",
    "particle_q", "particle_qd", "particle_mass", "particle_inv_mass",
    "particle_radius",
    "spring_rest_length", "spring_stiffness", "spring_damping",
    "tri_poses", "tri_materials", "tri_areas",
    "edge_rest_angle", "edge_rest_length", "edge_bending_properties",
    "tet_poses", "tet_materials",
    "particle_ke", "particle_kd", "particle_kf", "particle_mu",
    "particle_max_velocity", "soft_contact_ke", "soft_contact_kd",
    "soft_contact_kf", "soft_contact_mu", "soft_contact_margin",
    "eq_anchor", "eq_relpose", "eq_polycoef", "eq_torquescale",
)
MODEL_INT_FIELDS = (
    "body_flags", "shape_body", "shape_type", "shape_flags", "shape_world",
    "joint_type_arr", "joint_parent", "joint_child", "particle_flags",
    "spring_indices", "tri_indices", "edge_indices", "tet_indices",
    "eq_obj1", "eq_obj2", "muscle_bodies",
    "sdf_tex_block_index", "sdf_tex_blocks",
)
# integer fields stored as uint8 (the texture's quantized corners)
MODEL_UINT8_FIELDS = ("sdf_tex_blocks",)
MODEL_BOOL_FIELDS = ("eq_enabled",)


@dataclass
class Model:
    """Finalized model: tensors on one device plus a host ``structure``.

    Shapes: B bodies, S shapes, J joints, D dofs, Q coords, N particles,
    W worlds.
    """

    body_q: torch.Tensor          # (B, 7) initial pose
    body_qd: torch.Tensor         # (B, 6)
    body_com: torch.Tensor        # (B, 3) COM in body frame
    body_mass: torch.Tensor       # (B,)
    body_inv_mass: torch.Tensor   # (B,)
    body_inertia: torch.Tensor    # (B, 3, 3) about COM, body frame
    body_inv_inertia: torch.Tensor
    body_flags: torch.Tensor      # (B,) int32
    shape_transform: torch.Tensor  # (S, 7) body-local
    shape_body: torch.Tensor      # (S,) int32, -1 = static
    shape_type: torch.Tensor      # (S,) int32 GeoType
    shape_scale: torch.Tensor     # (S, 3)
    shape_flags: torch.Tensor     # (S,) int32
    shape_thickness: torch.Tensor
    shape_collision_radius: torch.Tensor
    shape_material_mu: torch.Tensor
    shape_material_restitution: torch.Tensor
    shape_material_kh: torch.Tensor  # (S,) hydroelastic modulus
    shape_world: torch.Tensor     # (S,) int32
    joint_type_arr: torch.Tensor  # (J,) int32
    joint_parent: torch.Tensor    # (J,) int32
    joint_child: torch.Tensor     # (J,) int32
    joint_X_p: torch.Tensor       # (J, 7)
    joint_X_c: torch.Tensor       # (J, 7)
    joint_axis: torch.Tensor      # (D, 3)
    joint_armature: torch.Tensor  # (D,)
    joint_target_ke: torch.Tensor
    joint_target_kd: torch.Tensor
    joint_limit_lower: torch.Tensor
    joint_limit_upper: torch.Tensor
    joint_limit_ke: torch.Tensor
    joint_limit_kd: torch.Tensor
    joint_friction: torch.Tensor
    joint_effort_limit: torch.Tensor
    joint_velocity_limit: torch.Tensor
    joint_qd0: torch.Tensor       # (D,)
    joint_q0: torch.Tensor        # (Q,)
    joint_target_q0: torch.Tensor  # (Q,)
    gravity: torch.Tensor         # (W, 3), one row per world
    tendon_params: torch.Tensor   # (T, 3) ke, kd, rest length
    sten_params: torch.Tensor     # (Ts, 3) spatial tendons' ke, kd, L0
    muscle_params: torch.Tensor   # (M, 7) f0 lm lt lmax pen ke kd
    muscle_bodies: torch.Tensor   # (Mw,) int32 waypoint body
    muscle_points: torch.Tensor   # (Mw, 3) waypoint in its body's frame
    particle_q: torch.Tensor      # (N, 3) initial positions
    particle_qd: torch.Tensor     # (N, 3)
    particle_mass: torch.Tensor   # (N,)
    particle_inv_mass: torch.Tensor  # (N,), 0 = pinned
    particle_radius: torch.Tensor  # (N,)
    particle_flags: torch.Tensor  # (N,) int32 ParticleFlags
    # cloth and soft topology (empty tables keep their trailing shape)
    spring_indices: torch.Tensor  # (Sp, 2) int32
    spring_rest_length: torch.Tensor  # (Sp,)
    spring_stiffness: torch.Tensor  # (Sp,)
    spring_damping: torch.Tensor  # (Sp,)
    tri_indices: torch.Tensor     # (T, 3) int32
    tri_poses: torch.Tensor       # (T, 2, 2) inverse rest matrix
    tri_materials: torch.Tensor   # (T, 5) ke, ka, kd, drag, lift
    tri_areas: torch.Tensor       # (T,)
    edge_indices: torch.Tensor    # (E, 4) int32 (o0, o1, v0, v1), -1 wings
    edge_rest_angle: torch.Tensor  # (E,)
    edge_rest_length: torch.Tensor  # (E,)
    edge_bending_properties: torch.Tensor  # (E, 2) ke, kd
    tet_indices: torch.Tensor     # (Tt, 4) int32
    tet_poses: torch.Tensor       # (Tt, 3, 3) inverse rest matrix
    tet_materials: torch.Tensor   # (Tt, 3) k_mu, k_lambda, k_damp
    # global particle material scalars (0-d)
    particle_ke: torch.Tensor
    particle_kd: torch.Tensor
    particle_kf: torch.Tensor
    particle_mu: torch.Tensor
    particle_max_velocity: torch.Tensor
    soft_contact_ke: torch.Tensor
    soft_contact_kd: torch.Tensor
    soft_contact_kf: torch.Tensor
    soft_contact_mu: torch.Tensor
    soft_contact_margin: torch.Tensor
    # equality constraints (E = structure.eq_count; the kinds are
    # structure.eq_type): bodies (CONNECT, WELD) or joints (JOINT)
    eq_obj1: torch.Tensor         # (E,) int32, -1 = the world
    eq_obj2: torch.Tensor         # (E,) int32
    eq_anchor: torch.Tensor       # (E, 3) in body1's frame
    eq_relpose: torch.Tensor      # (E, 7) WELD: body1 relative to body2
    eq_polycoef: torch.Tensor     # (E, 5) JOINT: q1 = poly(q2)
    eq_enabled: torch.Tensor      # (E,) bool
    eq_torquescale: torch.Tensor  # (E,)
    # mesh kinds (sim/mesh_prep.py): K contact samples per shape in its
    # frame and their vector areas; the pooled dense SDF grids over their
    # boxes; the pooled sparse textures (n, B, B, B) block indices into
    # one block pool (nb, 9, 9, 9) uint8 with per-block scale and offset,
    # and their coarse grids and boxes
    shape_sample_points: torch.Tensor  # (S, K, 3)
    shape_sample_areas: torch.Tensor   # (S, K, 3)
    sdf_grids: torch.Tensor       # (G, R, R, R)
    sdf_lower: torch.Tensor       # (G, 3)
    sdf_upper: torch.Tensor       # (G, 3)
    sdf_tex_block_index: torch.Tensor  # (T, B, B, B) int32, -1 coarse
    sdf_tex_blocks: torch.Tensor  # (nb, 9, 9, 9) uint8
    sdf_tex_scale: torch.Tensor   # (nb,)
    sdf_tex_offset: torch.Tensor  # (nb,)
    sdf_tex_coarse: torch.Tensor  # (T, B+1, B+1, B+1)
    sdf_tex_lower: torch.Tensor   # (T, 3)
    sdf_tex_upper: torch.Tensor   # (T, 3)
    custom: Dict[str, torch.Tensor] = field(default_factory=dict)
    structure: ModelStructure = None

    @property
    def device(self) -> torch.device:
        return self.joint_q0.device

    @property
    def body_count(self) -> int:
        return self.structure.body_count

    @property
    def joint_coord_count(self) -> int:
        return self.structure.joint_coord_count

    @property
    def joint_dof_count(self) -> int:
        return self.structure.joint_dof_count

    @property
    def particle_count(self) -> int:
        return self.structure.particle_count

    def replace(self, **kw) -> "Model":
        """A copy with the given fields replaced, the same structure (the
        JAX package's ``replace``: ``SolverXPBD.step(..., model=m)`` steps
        it); the tensors are not copied, so a graph through them is kept."""
        return replace(self, **kw)

    def to(self, device) -> "Model":
        kw = {f.name: getattr(self, f.name).to(device) for f in fields(self)
              if isinstance(getattr(self, f.name), torch.Tensor)}
        kw["custom"] = {k: v.to(device) for k, v in self.custom.items()}
        return replace(self, **kw)

    def _custom_for(self, assignment: AttributeAssignment):
        out = {}
        for name, spec in self.structure.custom_specs.items():
            if spec.assignment == assignment:
                out[name] = self.custom[name].clone()
        return out

    def state(self) -> State:
        """A State initialized from the model's defaults."""
        return State(body_q=self.body_q.clone(), body_qd=self.body_qd.clone(),
                     body_f=torch.zeros_like(self.body_qd),
                     joint_q=self.joint_q0.clone(),
                     joint_qd=self.joint_qd0.clone(),
                     particle_q=self.particle_q.clone(),
                     particle_qd=self.particle_qd.clone(),
                     particle_f=torch.zeros_like(self.particle_q),
                     custom=self._custom_for(AttributeAssignment.STATE))

    def control(self) -> Control:
        return Control(joint_target_q=self.joint_target_q0.clone(),
                       joint_target_qd=torch.zeros_like(self.joint_qd0),
                       joint_f=torch.zeros_like(self.joint_qd0),
                       tendon_f=self.tendon_params.new_zeros(
                           self.tendon_params.shape[0]),
                       muscle_activations=self.muscle_params.new_zeros(
                           self.muscle_params.shape[0]),
                       custom=self._custom_for(AttributeAssignment.CONTROL))
