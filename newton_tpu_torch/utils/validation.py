"""State validation and test assertion helpers (port of
``newton_tpu/utils/validation.py``).

Members are named as the JAX package names them (``jax.tree_util.keystr``
of the leaf's path): ``.body_q`` for a field, ``.custom['mjc:act']`` for a
``custom`` entry. Each check reduces on the tensors' device and reads the
results back once. ``checkify_step`` keeps its finiteness test on the
device until ``throw()``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from .checkpoint import state_leaves

__all__ = ["assert_np_equal", "find_nan_members", "find_nonfinite_members",
           "nan_sweep", "check_state_valid", "checkify_step", "StepError"]


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def assert_np_equal(a, b, tol: float = 0.0, msg: str = ""):
    """Array equality, or closeness within ``tol`` (absolute)."""
    a, b = _numpy(a), _numpy(b)
    if tol == 0.0:
        np.testing.assert_array_equal(a, b, err_msg=msg)
    else:
        np.testing.assert_allclose(a, b, atol=tol, err_msg=msg)


def _members(obj) -> Dict[str, torch.Tensor]:
    """Floating-point members, by their JAX key path."""
    out = {}
    for name, t in state_leaves(obj):
        if t.is_floating_point():
            key = (f".custom['{name[len('custom/'):]}']"
                   if name.startswith("custom/") else f".{name}")
            out[key] = t
    return out


def _flagged(obj, test) -> List[str]:
    """Names of the members where ``test(t).any()``: one read-back."""
    m = _members(obj)
    if not m:
        return []
    flags = torch.stack([test(t.detach()).any()
                         for t in m.values()]).cpu().tolist()
    return [k for k, f in zip(m, flags) if f]


def find_nan_members(obj) -> List[str]:
    """Names of float members holding a NaN."""
    return _flagged(obj, torch.isnan)


def find_nonfinite_members(obj) -> List[str]:
    """Names of float members holding a NaN or an Inf."""
    return _flagged(obj, lambda t: ~torch.isfinite(t))


def nan_sweep(*objs, context: str = ""):
    """Raise AssertionError if any member of ``objs`` is non-finite."""
    for obj in objs:
        bad = find_nonfinite_members(obj)
        if bad:
            raise AssertionError(
                f"non-finite members{' in ' + context if context else ''}: "
                f"{bad}")


def check_state_valid(state, max_speed: float = 1.0e4) -> Dict[str, Any]:
    """Benchmark validity gates: finite body state, unit quaternions
    (within 1e-2) and speeds below ``max_speed``. Returns a report with
    ``finite``, ``quat_normalized``, ``speed_bounded`` and ``valid``."""
    bq = state.body_q.detach().reshape(-1, 7)
    bqd = state.body_qd.detach().reshape(-1, 6)
    checks = [torch.isfinite(bq).all() & torch.isfinite(bqd).all()]
    if len(bq):
        checks.append((torch.linalg.vector_norm(bq[:, 3:7], dim=-1) - 1.0)
                      .abs().max() < 1e-2)
    if len(bqd):
        checks.append(bqd.abs().max() < max_speed)
    got = torch.stack(checks).cpu().tolist()
    report = {"finite": bool(got[0]),
              "quat_normalized": bool(got[1]) if len(bq) else True,
              "speed_bounded": bool(got[-1]) if len(bqd) else True}
    report["valid"] = all(report.values())
    return report


class StepError:
    """The finiteness flags of a checked step's outputs, on the device."""

    def __init__(self, flags: torch.Tensor, names: List[str]):
        self._flags = flags
        self._names = names

    def get(self):
        """None when every output is finite, else a message naming the
        non-finite members (reads the flags back)."""
        bad = [n for n, f in zip(self._names, self._flags.cpu().tolist())
               if f]
        return f"non-finite step outputs: {bad}" if bad else None

    def throw(self):
        """Raise FloatingPointError if an output was non-finite."""
        msg = self.get()
        if msg:
            raise FloatingPointError(msg)


def checkify_step(step_fn):
    """Wrap a step so that it returns ``(err, out)``: ``err`` holds one
    device flag per float member of ``out`` (a dataclass of tensors, or a
    tensor) saying whether it holds a NaN or an Inf, and ``err.throw()``
    raises on one; nothing is read back before that. The JAX package's
    ``checkify.float_checks`` test every operation of the step; this tests
    what the step returns."""

    def checked(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            members = {"": out} if out.is_floating_point() else {}
        else:
            members = _members(out)
        flags = (torch.stack([~torch.isfinite(t.detach()).all()
                              for t in members.values()])
                 if members else torch.zeros(0, dtype=torch.bool))
        return StepError(flags, list(members)), out

    return checked
