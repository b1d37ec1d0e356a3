"""Solvers of the port."""

from .generalized.kamino import SolverKamino
from .generalized.solver import SolverFeatherstone, SolverMuJoCo
from .solver import SolverBase, integrate_bodies, integrate_particles
from .solver_mpm import SolverImplicitMPM, SolverMPM
from .solver_semi_implicit import SolverSemiImplicit
from .solver_style3d import SolverStyle3D
from .solver_vbd import SolverVBD
from .solver_xpbd import SolverXPBD

__all__ = ["SolverBase", "SolverFeatherstone", "SolverKamino",
           "SolverMuJoCo", "SolverImplicitMPM", "SolverMPM",
           "SolverSemiImplicit", "SolverStyle3D", "SolverVBD", "SolverXPBD",
           "integrate_bodies", "integrate_particles"]
