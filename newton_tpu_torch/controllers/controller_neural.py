"""Neural policy controllers: MLP and LSTM (port of
``newton_tpu/controllers/controller_neural.py``). The weights are tensors
on the policy's device (default: the card); an ONNX file runs through
``OnnxModule`` instead."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["ControllerNeuralMLP", "ControllerNeuralLSTM", "load_onnx_weights"]

_ACTS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "identity": lambda x: x,
}


def _t(a, device):
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a, dtype=torch.float32, device=device)


class ControllerNeuralMLP:
    """MLP policy obs -> action: ``params`` = [(W (in, out), b (out,)),
    ...], ``activation`` between layers, ``output_activation`` after the
    last. The observation is ``obs_fn(model, state)`` or the command."""

    def __init__(self, params: Sequence[Tuple[np.ndarray, np.ndarray]],
                 activation: str = "elu", output_activation: str = "identity",
                 obs_fn: Optional[Callable] = None, device="cuda"):
        self.params = [(_t(W, device), _t(b, device)) for W, b in params]
        self.act = _ACTS[activation]
        self.out_act = _ACTS[output_activation]
        self.obs_fn = obs_fn

    def __call__(self, model, state, command, dof_indices):
        x = self.obs_fn(model, state) if self.obs_fn else command
        x = torch.as_tensor(x, device=self.params[0][0].device)
        for i, (W, b) in enumerate(self.params):
            x = torch.matmul(x, W) + b
            if i < len(self.params) - 1:
                x = self.act(x)
        return self.out_act(x)


class ControllerNeuralLSTM:
    """One LSTM layer and a linear head (gate layout [i, f, g, o]):
    ``init(batch_shape)`` -> (h, c), ``step(carry, obs)`` -> (carry,
    action)."""

    def __init__(self, W_ih, W_hh, b_ih, b_hh, W_out, b_out, device="cuda"):
        self.W_ih = _t(W_ih, device)
        self.W_hh = _t(W_hh, device)
        self.b = _t(b_ih, device) + _t(b_hh, device)
        self.W_out = _t(W_out, device)
        self.b_out = _t(b_out, device)
        self.hidden = self.W_hh.shape[0]

    def init(self, batch_shape=()):
        h = torch.zeros((*batch_shape, self.hidden), device=self.b.device)
        return h, h

    def step(self, carry, obs):
        h, c = carry
        z = (torch.matmul(obs, self.W_ih) + torch.matmul(h, self.W_hh)
             + self.b)
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (h, c), torch.matmul(h, self.W_out) + self.b_out


def load_onnx_weights(path: str) -> Dict[str, np.ndarray]:
    """The initializer tensors of an ONNX file, name -> array, through the
    ``onnx`` package; without it, ``RuntimeError`` (as the JAX package):
    convert the policy to .npz, or run the file with ``OnnxModule``."""
    try:
        import onnx
        from onnx import numpy_helper
    except ImportError:
        raise RuntimeError(
            "No ONNX reader available; convert the policy to .npz "
            "(np.savez(name=array, ...)) and load with np.load instead.")
    m = onnx.load(path)
    return {t.name: numpy_helper.to_array(t) for t in m.graph.initializer}
