"""Offline ray-traced viewer (port of ``newton_tpu/viewer/viewer_rtx.py``):
each logged frame renders through the tiled camera
(``sensors/sensor_tiled_camera.py``: primary and shadow rays, a Reinhard
tone map, exact BVH hits for meshes) and is written as a PNG encoded with
the standard library's ``zlib``."""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np
import torch

from ..core.host_math import np_quat_from_matrix
from .viewer import ViewerBase

__all__ = ["ViewerRTX", "write_png"]


def write_png(path: str, rgb: np.ndarray):
    """Write an (H, W, 3) float [0, 1] or uint8 array as a PNG."""
    if rgb.dtype != np.uint8:
        rgb = (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


class ViewerRTX(ViewerBase):
    """Offline ray-traced viewer.

    Args:
        out_dir: PNG output directory (frame_00000.png, ...).
        width/height: render resolution.
        cam_pos/cam_target: camera placement (look-at, +Z up).
        every: render every Nth logged frame.
    """

    def __init__(self, out_dir: str = "rtx_frames", width: int = 320,
                 height: int = 240, cam_pos=(2.5, -2.5, 1.8),
                 cam_target=(0.0, 0.0, 0.5), every: int = 1,
                 checker_texture: bool = True):
        super().__init__()
        self.out_dir = out_dir
        self.width, self.height = int(width), int(height)
        self.every = int(every)
        self.checker_texture = bool(checker_texture)
        self._cam = None
        self.cam_xform = self._look_at(np.asarray(cam_pos, np.float64),
                                       np.asarray(cam_target, np.float64))
        self.last_image: Optional[np.ndarray] = None
        os.makedirs(out_dir, exist_ok=True)

    @staticmethod
    def _look_at(eye, target, up=(0.0, 0.0, 1.0)):
        """Camera transform (position, xyzw quaternion) looking along -Z."""
        f = target - eye
        f = f / max(np.linalg.norm(f), 1e-9)
        r = np.cross(f, np.asarray(up, np.float64))
        r = r / max(np.linalg.norm(r), 1e-9)
        u = np.cross(r, f)
        R = np.stack([r, u, -f], axis=1)         # columns: x, y, z (camera)
        return np.concatenate([eye, np_quat_from_matrix(R)]).astype(
            np.float32)

    def set_model(self, model):
        super().set_model(model)
        from ..sensors.sensor_tiled_camera import SensorTiledCamera
        self._cam = SensorTiledCamera(
            model, width=self.width, height=self.height, shadows=True,
            checker_texture=self.checker_texture)

    def log_state(self, state):
        if self._cam is None or (self._frame % self.every):
            return
        out = self._cam.render(state, torch.as_tensor(self.cam_xform[None]))
        img = out["color"][0].cpu().numpy()
        self.last_image = img
        write_png(os.path.join(self.out_dir,
                               f"frame_{max(self._frame, 0):05d}.png"), img)
