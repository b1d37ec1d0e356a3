"""Timing and profiling helpers (port of ``newton_tpu/utils/benchmark.py``).

``EventTracer`` times nested named scopes on the host clock; with
``sync=True`` a scope's exit first waits for its CUDA device
(``torch.cuda.synchronize``), so the scope holds the device work it
queued. ``run_benchmark`` returns the JAX package's keys and, with
``profile_dir``, writes a ``torch.profiler`` Chrome trace there.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Dict, Optional

import torch

__all__ = ["EventTracer", "event_scope", "ScopedTimer", "run_benchmark",
           "benchmark_step"]


def _first_tensor(obj) -> Optional[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, (list, tuple)):
        for x in obj:
            t = _first_tensor(x)
            if t is not None:
                return t
        return None
    for v in getattr(obj, "__dict__", {}).values():
        if isinstance(v, torch.Tensor):
            return v
    return None


def _synchronize(obj=None) -> None:
    """Wait for the CUDA device of ``obj``'s first tensor, else for the
    current one if CUDA is in use; no-op on the CPU."""
    t = _first_tensor(obj) if obj is not None else None
    if t is not None:
        device = t.device
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EventTracer:
    """Hierarchical host-clock scope timing. Each node keeps its name, its
    children, its total seconds and its count. With ``sync=True`` a
    scope waits for its CUDA device before it stops the clock: the
    device of the scope's ``result``, else the current CUDA device."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.root: Dict[str, Any] = {"name": "root", "children": [],
                                     "elapsed": 0.0, "count": 0}
        self._stack = [self.root]

    @contextlib.contextmanager
    def scope(self, name: str, result=None):
        node = next((c for c in self._stack[-1]["children"]
                     if c["name"] == name), None)
        if node is None:
            node = {"name": name, "children": [], "elapsed": 0.0, "count": 0}
            self._stack[-1]["children"].append(node)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield node
        finally:
            if self.sync:
                _synchronize(result)
            node["elapsed"] += time.perf_counter() - t0
            node["count"] += 1
            self._stack.pop()

    def report(self, node=None, depth=0) -> str:
        node = node or self.root
        lines = []
        for c in node["children"]:
            avg = c["elapsed"] / max(c["count"], 1) * 1e3
            lines.append("  " * depth +
                         f"{c['name']}: {c['elapsed']*1e3:.2f} ms total, "
                         f"{avg:.3f} ms avg x{c['count']}")
            lines.append(self.report(c, depth + 1))
        return "\n".join(l for l in lines if l)


_GLOBAL_TRACER: Optional[EventTracer] = None


def event_scope(fn: Callable) -> Callable:
    """Decorator timing a function under the module's global tracer
    (``benchmark._GLOBAL_TRACER``; untimed while it is None)."""

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if _GLOBAL_TRACER is None:
            return fn(*a, **kw)
        with _GLOBAL_TRACER.scope(fn.__qualname__):
            out = fn(*a, **kw)
        return out

    return wrapper


class ScopedTimer:
    """Host-clock timer of a ``with`` block; ``elapsed`` in ms, printed
    on exit when ``active`` and ``print_``."""

    def __init__(self, name: str, active: bool = True, print_: bool = True):
        self.name = name
        self.active = active
        self.print = print_
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = (time.perf_counter() - self._t0) * 1e3
        if self.active and self.print:
            print(f"{self.name}: {self.elapsed:.3f} ms")
        return False


def benchmark_step(step_fn: Callable, state, iters: int = 20,
                   warmup: int = 3):
    """Time ``state = step_fn(state)``: ``warmup`` calls, then ``iters``
    timed calls closed by a device sync; returns (ms a call, state)."""
    for _ in range(warmup):
        state = step_fn(state)
    _synchronize(state)
    t0 = time.perf_counter()
    for _ in range(iters):
        state = step_fn(state)
    _synchronize(state)
    return (time.perf_counter() - t0) / iters * 1e3, state


def run_benchmark(step_fn: Callable, state, frames: int, substeps: int,
                  worlds: int, dt: float, profile_dir: Optional[str] = None):
    """``frames`` timed calls of a frame step of ``substeps`` substeps of
    ``worlds`` worlds: ms a world-step, world-steps/s, the real-time factor
    and the final state. With ``profile_dir`` the timed calls run under
    ``torch.profiler`` and its Chrome trace goes to
    ``profile_dir/trace.json``."""
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            ms, state = benchmark_step(step_fn, state, iters=frames)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    else:
        ms, state = benchmark_step(step_fn, state, iters=frames)
    steps = substeps * worlds
    return {
        "ms_per_world_step": ms / steps,
        "world_steps_per_s": steps / (ms / 1e3),
        "rtf": steps * dt / (ms / 1e3),
        "state": state,
    }
