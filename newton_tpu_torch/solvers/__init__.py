"""Solvers of the port."""

from .solver import SolverBase, integrate_bodies
from .solver_mpm import SolverImplicitMPM, SolverMPM
from .solver_xpbd import SolverXPBD

__all__ = ["SolverBase", "SolverImplicitMPM", "SolverMPM", "SolverXPBD",
           "integrate_bodies"]
