from .actuator import Actuator, Delay, DelayState
from .clamping import ClampDCMotor, ClampMaxEffort, ClampPositionBased

__all__ = ["Actuator", "ClampDCMotor", "ClampMaxEffort",
           "ClampPositionBased", "Delay"]
