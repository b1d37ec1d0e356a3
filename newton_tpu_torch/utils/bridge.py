"""Numpy bridge between the JAX package's containers and the port's.

The bridge takes plain dicts of numpy arrays (and Python values for the
structure), so it imports neither jax nor the JAX package: the caller
reads the JAX ``Model`` leaves and ``ModelStructure`` fields into numpy
(``np.asarray(getattr(model, name))`` for every name in
``MODEL_FLOAT_FIELDS``/``MODEL_INT_FIELDS``/``MODEL_BOOL_FIELDS``,
``getattr(structure, name)`` for ``STRUCTURE_FIELDS``) and gets the
port's objects on a device. The ``*_to_numpy`` functions go the other
way, so a round trip is exact. A multi-world model (``replicate``,
``add_world``) needs nothing more: its leaves are the flat ones, and its
world tables are structure fields. The mesh kinds' leaves (sample
points and areas, SDF grids, texture pools; ``sdf_tex_blocks`` as uint8)
and structure fields (SDF and texture ids, hull vertex clouds, sample
cell areas) ride the same lists.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..sim.contacts import Contacts
from ..sim.control import Control
from ..sim.model import (
    MODEL_BOOL_FIELDS,
    MODEL_FLOAT_FIELDS,
    MODEL_INT_FIELDS,
    MODEL_UINT8_FIELDS,
    AttributeAssignment,
    AttributeFrequency,
    AttributeSpec,
    Model,
    ModelStructure,
)
from ..sim.state import State
from ..sim.tendon import SpatialTendonPath
from ..solvers.generalized.actuation import MJCActuation

__all__ = ["STRUCTURE_FIELDS", "ACTUATION_FIELDS", "STATE_FIELDS",
           "CONTROL_FIELDS", "CONTACT_FIELDS", "CONTACT_COUNTERS",
           "CONTACT_OPTIONAL",
           "SOFT_CONTACT_FIELDS",
           "model_from_numpy",
           "model_to_numpy", "state_from_numpy", "state_to_numpy",
           "control_from_numpy", "control_to_numpy", "contacts_from_numpy",
           "contacts_to_numpy"]

STRUCTURE_FIELDS = (
    "world_count", "body_count", "shape_count", "joint_count",
    "joint_coord_count", "joint_dof_count", "articulation_count",
    "eq_count", "tendon_count", "sten_count", "up_axis",
    "joint_type", "joint_parent", "joint_child", "joint_q_start",
    "joint_qd_start", "joint_dof_dim", "joint_world", "joint_parent_joint",
    "articulation_start", "articulation_world", "body_world", "shape_world",
    "shape_body", "shape_type", "shape_flags", "shape_collision_group",
    "body_key", "joint_key", "shape_key",
    "candidate_pairs", "candidate_pair_slots", "rigid_contact_max",
    "slot_shape0", "slot_shape1", "slot_body0", "slot_body1",
    "mjc_options", "particle_count", "particle_world",
    "tendon_coord", "tendon_dof", "tendon_coef",
    "spring_count", "tri_count", "edge_count", "tet_count", "soft_pairs",
    "soft_contact_max", "eq_world", "eq_type",
    "sten_paths", "sten_key", "muscle_count", "muscle_start",
    "shape_filter_pairs", "shape_sdf_id", "shape_sdf_tex_id",
    "shape_hull_verts", "shape_sample_cell_area",
)
ACTUATION_FIELDS = ("n", "dof", "coord", "tendon", "sten", "gear",
                    "dyntype", "dynprm", "gaintype", "gainprm", "biastype",
                    "biasprm", "ctrlrange", "forcerange", "actrange",
                    "ctrllimited", "forcelimited", "actlimited",
                    "lengthrange", "acc0")
STATE_FIELDS = ("body_q", "body_qd", "body_f", "joint_q", "joint_qd",
                "particle_q", "particle_qd", "particle_f")
CONTROL_FIELDS = ("joint_target_q", "joint_target_qd", "joint_f",
                  "tendon_f", "muscle_activations")
CONTACT_FIELDS = ("rigid_contact_mask", "rigid_contact_shape0",
                  "rigid_contact_shape1", "rigid_contact_position",
                  "rigid_contact_normal", "rigid_contact_depth",
                  "rigid_contact_force")
# the device scalars of the dynamic-pair and mesh budgets' overflow
CONTACT_COUNTERS = ("broad_phase_dropped", "mesh_samples_dropped")
# the hydroelastic slots' stiffness (the JAX package's Contacts always
# carry it, zeros without hydroelastic contacts; the port's only then)
CONTACT_OPTIONAL = ("rigid_contact_stiffness",)
# present where the contacts have soft capacity (the JAX package's always
# have them, possibly empty)
SOFT_CONTACT_FIELDS = ("soft_contact_mask", "soft_contact_particle",
                       "soft_contact_shape", "soft_contact_position",
                       "soft_contact_normal", "soft_contact_depth")


def _tensor(x, device, dtype=None):
    a = np.array(x)             # a writable copy: the caller keeps its own
    if dtype is None:
        dtype = {np.dtype(bool): torch.bool}.get(a.dtype, None)
        if dtype is None:
            dtype = (torch.int32 if np.issubdtype(a.dtype, np.integer)
                     else torch.float32)
    return torch.as_tensor(a, device=device).to(dtype)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _structure_from_dict(d: Dict[str, Any]) -> ModelStructure:
    st = ModelStructure()
    for name in STRUCTURE_FIELDS:
        if name == "shape_filter_pairs" and name not in d:
            continue            # none: the structure's empty set
        v = d[name]
        if isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, (list, dict, set)):
            v = type(v)(v)
        setattr(st, name, v)
    # spatial tendon paths: any object with ``elems`` (the JAX package's
    # SpatialTendonPath) becomes the port's
    st.sten_paths = [SpatialTendonPath([tuple(e) for e in p.elems])
                     for p in st.sten_paths]
    au = d.get("mjc_actuation")
    if au is not None:
        a = MJCActuation(int(au["n"]))
        for name in ACTUATION_FIELDS[1:]:
            setattr(a, name, np.array(au[name]))
        st.mjc_actuation = a.finish()
    st.custom_specs = {
        name: AttributeSpec(name, AttributeFrequency(s["frequency"]),
                            AttributeAssignment(s["assignment"]),
                            tuple(s["shape"]), float(s["default"]))
        for name, s in d.get("custom_specs", {}).items()}
    return st


def model_from_numpy(leaves: Dict[str, Any], structure: Dict[str, Any],
                     device) -> Model:
    """The port's Model on ``device`` from numpy leaves and structure
    fields (``structure["mjc_actuation"]`` is a dict of ACTUATION_FIELDS
    or None; ``leaves["eq_enabled"]`` may be missing (all enabled);
    ``structure["custom_specs"]`` maps names to dicts of
    frequency/assignment values, shape and default)."""
    kw = {n: _tensor(leaves[n], device, torch.float32)
          for n in MODEL_FLOAT_FIELDS}
    kw.update({n: _tensor(leaves[n], device, torch.uint8
                          if n in MODEL_UINT8_FIELDS else torch.int32)
               for n in MODEL_INT_FIELDS})
    # eq_enabled may be left out: every constraint enabled
    kw["eq_enabled"] = _tensor(leaves.get(
        "eq_enabled", np.ones(int(structure["eq_count"]), bool)), device,
        torch.bool)
    kw["custom"] = {k: _tensor(v, device, torch.float32)
                    for k, v in leaves.get("custom", {}).items()}
    return Model(structure=_structure_from_dict(structure), **kw)


def model_to_numpy(model: Model) -> Tuple[dict, dict]:
    leaves = {n: _numpy(getattr(model, n)) for n in
              MODEL_FLOAT_FIELDS + MODEL_INT_FIELDS + MODEL_BOOL_FIELDS}
    leaves["custom"] = {k: _numpy(v) for k, v in model.custom.items()}
    st = model.structure
    structure = {n: getattr(st, n) for n in STRUCTURE_FIELDS}
    structure["sten_paths"] = [SpatialTendonPath(list(p.elems))
                               for p in st.sten_paths]
    au = st.mjc_actuation
    structure["mjc_actuation"] = None if au is None else {
        n: getattr(au, n) for n in ACTUATION_FIELDS}
    structure["custom_specs"] = {
        name: dict(frequency=s.frequency.value, assignment=s.assignment.value,
                   shape=s.shape, default=s.default)
        for name, s in st.custom_specs.items()}
    return leaves, structure


def state_from_numpy(d: Dict[str, Any], device) -> State:
    return State(**{n: _tensor(d[n], device, torch.float32)
                    for n in STATE_FIELDS},
                 custom={k: _tensor(v, device)
                         for k, v in d.get("custom", {}).items()})


def state_to_numpy(state: State) -> dict:
    out = {n: _numpy(getattr(state, n)) for n in STATE_FIELDS}
    out["custom"] = {k: _numpy(v) for k, v in state.custom.items()}
    return out


def control_from_numpy(d: Dict[str, Any], device) -> Control:
    """``tendon_f`` may be missing or None (no tendon force input)."""
    return Control(**{n: None if d.get(n) is None
                      else _tensor(d[n], device, torch.float32)
                      for n in CONTROL_FIELDS},
                   custom={k: _tensor(v, device)
                           for k, v in d.get("custom", {}).items()})


def control_to_numpy(control: Control) -> dict:
    out = {n: None if getattr(control, n) is None
           else _numpy(getattr(control, n)) for n in CONTROL_FIELDS}
    out["custom"] = {k: _numpy(v) for k, v in control.custom.items()}
    return out


def contacts_from_numpy(d: Dict[str, Any], device) -> Contacts:
    """Soft fields are taken where ``d`` has them with a nonzero
    capacity; otherwise the Contacts has none. The overflow counters and
    the ``custom`` entries are taken where ``d`` has them, the stiffness
    where it has one per rigid slot."""
    soft = {}
    if d.get("soft_contact_mask") is not None and \
            np.asarray(d["soft_contact_mask"]).shape[-1]:
        soft = {n: _tensor(d[n], device) for n in SOFT_CONTACT_FIELDS}
    counters = {n: _tensor(d[n], device, torch.int32)
                for n in CONTACT_COUNTERS if d.get(n) is not None}
    C = np.asarray(d["rigid_contact_mask"]).shape[-1]
    counters.update({n: _tensor(d[n], device, torch.float32)
                     for n in CONTACT_OPTIONAL if d.get(n) is not None
                     and np.asarray(d[n]).shape[-1:] == (C,)})
    return Contacts(**{n: _tensor(d[n], device) for n in CONTACT_FIELDS},
                    **soft, **counters,
                    custom={k: _tensor(v, device)
                            for k, v in d.get("custom", {}).items()})


def contacts_to_numpy(contacts: Contacts) -> dict:
    names = CONTACT_FIELDS + (SOFT_CONTACT_FIELDS
                              if contacts.soft_contact_max else ())
    out = {n: _numpy(getattr(contacts, n)) for n in names}
    out.update({n: _numpy(getattr(contacts, n))
                for n in CONTACT_COUNTERS + CONTACT_OPTIONAL
                if getattr(contacts, n) is not None})
    if contacts.custom:
        out["custom"] = {k: _numpy(v) for k, v in contacts.custom.items()}
    return out
