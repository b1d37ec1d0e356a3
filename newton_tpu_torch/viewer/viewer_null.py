"""Headless viewer with FPS accounting (port of
``newton_tpu/viewer/viewer_null.py``): counts frames, tracks wall-clock
FPS, drops all geometry; ``max_frames`` makes ``is_running()`` end run
loops."""

from __future__ import annotations

import time
from typing import Optional

from .viewer import ViewerBase

__all__ = ["ViewerNull"]


class ViewerNull(ViewerBase):
    def __init__(self, max_frames: Optional[int] = None):
        super().__init__()
        self.max_frames = max_frames
        self._t0 = None
        self.frame_count = 0

    def begin_frame(self, time_s: float):
        super().begin_frame(time_s)
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def end_frame(self):
        self.frame_count += 1

    @property
    def fps(self) -> float:
        if self._t0 is None or self.frame_count == 0:
            return 0.0
        return self.frame_count / max(time.perf_counter() - self._t0, 1e-9)

    def is_running(self) -> bool:
        return self.max_frames is None or self.frame_count < self.max_frames
