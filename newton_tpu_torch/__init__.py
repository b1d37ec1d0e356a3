"""newton_tpu_torch: the PyTorch/CUDA port of newton_tpu.

The JAX package ``newton_tpu`` is the reference; this package re-implements
these of its paths in PyTorch: the robot path (MJCF or URDF robot -> static
collision -> batched generalized step, with contact warm start, sleeping
and equality constraints), the rigid-body path of ``SolverXPBD``, the MPM
path (particles -> ``SolverImplicitMPM``), the cloth path (cloth and soft
topology, particle-shape contacts -> ``SolverStyle3D``, ``SolverVBD``,
``SolverSemiImplicit``), rigid bodies under ``SolverVBD``'s AVBD, the
co-simulation of two solvers (``SolverCoupled``), mesh, convex-hull, heightfield and hydroelastic
contacts, and batched inverse kinematics (``ik``). Every TPU kernel of the JAX package has a
hand-written CUDA counterpart for Hopper in ``csrc/``: the Cholesky and PGS
kernels of the robot path, the P2G/G2P transfers of the MPM path. It
imports torch, never jax.

Physics needs true float32 products: TF32 would corrupt mass matrices and
Delassus operators, so it is switched off here for matmuls and cuDNN.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .core.types import MAXVAL, Axis  # noqa: E402
from .geometry.types import SDF, GeoType, Heightfield, Mesh, ShapeFlags  # noqa: E402
from .parallel.envs import batch_state  # noqa: E402
from .sim.articulation import eval_fk, eval_ik  # noqa: E402
from .sim.builder import JointDofConfig, ModelBuilder, ShapeConfig  # noqa: E402
from .sim.collide import CollisionPipeline  # noqa: E402
from .sim.contacts import Contacts  # noqa: E402
from .sim.control import Control  # noqa: E402
from .sim.enums import EqType, JointType, ParticleFlags  # noqa: E402
from .sim.model import Model, ModelStructure  # noqa: E402
from .sim.state import State  # noqa: E402
from .solvers.generalized.kamino import SolverKamino  # noqa: E402
from .solvers.generalized.solver import SolverFeatherstone, SolverMuJoCo  # noqa: E402
from .solvers.solver_coupled import SolverCoupled  # noqa: E402
from .solvers.solver_mpm import SolverImplicitMPM, SolverMPM  # noqa: E402
from .solvers.solver_semi_implicit import SolverSemiImplicit  # noqa: E402
from .solvers.solver_style3d import SolverStyle3D  # noqa: E402
from .solvers.solver_vbd import SolverVBD  # noqa: E402
from .solvers.solver_xpbd import SolverXPBD  # noqa: E402

__all__ = [
    "MAXVAL", "Axis", "GeoType", "ShapeFlags", "Mesh", "SDF", "Heightfield",
    "batch_state", "eval_fk",
    "eval_ik",
    "JointDofConfig", "ModelBuilder", "ShapeConfig", "CollisionPipeline",
    "Contacts", "Control", "EqType", "JointType", "Model", "ModelStructure", "State",
    "SolverCoupled", "SolverFeatherstone", "SolverKamino", "SolverMuJoCo",
    "SolverImplicitMPM", "SolverMPM",
    "SolverSemiImplicit", "SolverStyle3D", "SolverVBD", "SolverXPBD",
    "ParticleFlags", "ASSET_DIR",
]

import os as _os  # noqa: E402

ASSET_DIR = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                          "assets")
