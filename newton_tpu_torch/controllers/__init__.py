from .controller_neural import (ControllerNeuralLSTM, ControllerNeuralMLP,
                                load_onnx_weights)
from .controller_pd import ControllerPD
from .controller_pid import ControllerPID
from .joint_impedance import JointImpedanceModelBased, JointImpedanceModelFree
from .onnx_runtime import OnnxModule, encode_mlp

__all__ = ["ControllerNeuralLSTM", "ControllerNeuralMLP", "ControllerPD",
           "ControllerPID", "JointImpedanceModelBased",
           "JointImpedanceModelFree", "OnnxModule", "encode_mlp"]
