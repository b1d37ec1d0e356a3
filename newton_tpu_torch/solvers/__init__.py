"""Solvers of the port."""

from .solver import SolverBase
from .solver_mpm import SolverImplicitMPM, SolverMPM

__all__ = ["SolverBase", "SolverImplicitMPM", "SolverMPM"]
