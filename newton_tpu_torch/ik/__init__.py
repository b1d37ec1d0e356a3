"""Batched inverse kinematics (port of ``newton_tpu/ik``)."""

from .ik_solver import (
    IKObjectiveJointLimit,
    IKObjectivePosition,
    IKObjectiveRotation,
    IKSampling,
    IKSolver,
)

__all__ = ["IKObjectiveJointLimit", "IKObjectivePosition",
           "IKObjectiveRotation", "IKSampling", "IKSolver"]
