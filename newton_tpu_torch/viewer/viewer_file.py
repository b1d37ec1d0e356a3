"""Record/replay viewer (port of ``newton_tpu/viewer/viewer_file.py``):
shape metadata once and body/particle state per frame, saved as JSON (or
CBOR where ``cbor2`` is installed) in the JAX package's format
(``newton_tpu.recording.v1``); ``ViewerFile.load`` and ``replay`` read a
recording back and feed it to another viewer."""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from .viewer import ViewerBase, to_numpy

__all__ = ["ViewerFile"]


def _to_list(a):
    return to_numpy(a).tolist()


class ViewerFile(ViewerBase):
    """Record frames to a .json or .cbor file."""

    def __init__(self, path: str, auto_save_interval: Optional[int] = None,
                 max_history: Optional[int] = None):
        super().__init__()
        self.path = path
        self.auto_save_interval = auto_save_interval
        self.max_history = max_history
        self.header: Dict[str, Any] = {}
        self.frames: List[Dict[str, Any]] = []

    def set_model(self, model):
        super().set_model(model)
        st = model.structure
        self.header = {
            "format": "newton_tpu.recording.v1",
            "world_count": st.world_count,
            "body_count": st.body_count,
            "shape_count": st.shape_count,
            "particle_count": st.particle_count,
            "shape_type": _to_list(st.shape_type),
            "shape_body": _to_list(st.shape_body),
            "shape_transform": _to_list(model.shape_transform),
            "shape_scale": _to_list(model.shape_scale),
            "shape_key": list(st.shape_key),
            "body_key": list(st.body_key),
        }

    def log_state(self, state):
        frame = {"time": self.time, "body_q": _to_list(state.body_q)}
        if state.particle_q.shape[-2]:
            frame["particle_q"] = _to_list(state.particle_q)
        self.frames.append(frame)
        if self.max_history and len(self.frames) > self.max_history:
            self.frames.pop(0)

    def log_contacts(self, contacts, state=None):
        if not self.frames:
            return
        mask = to_numpy(contacts.rigid_contact_mask)
        self.frames[-1]["contacts"] = {
            "position": to_numpy(contacts.rigid_contact_position)[mask]
            .tolist(),
            "normal": to_numpy(contacts.rigid_contact_normal)[mask].tolist(),
            "depth": to_numpy(contacts.rigid_contact_depth)[mask].tolist(),
        }

    def log_scalar(self, name: str, value):
        super().log_scalar(name, value)
        if self.frames:
            self.frames[-1].setdefault("scalars", {})[name] = float(value)

    def log_gaussian(self, name: str, means, scales, quats=None,
                     colors=None, opacities=None):
        if not self.frames:
            return
        rec = {"means": _to_list(means), "scales": _to_list(scales)}
        for key, v in (("quats", quats), ("colors", colors),
                       ("opacities", opacities)):
            if v is not None:
                rec[key] = _to_list(v)
        self.frames[-1].setdefault("gaussians", {})[name] = rec

    def end_frame(self):
        if (self.auto_save_interval
                and len(self.frames) % self.auto_save_interval == 0):
            self.save()

    def save(self, path: Optional[str] = None):
        path = path or self.path
        data = {"header": self.header, "frames": self.frames}
        if path.endswith(".cbor"):
            try:
                import cbor2
                with open(path, "wb") as f:
                    cbor2.dump(data, f)
                return
            except ImportError:
                path = path[:-5] + ".json"
        with open(path, "w") as f:
            json.dump(data, f)

    def close(self):
        self.save()

    # -- replay -----------------------------------------------------------
    @staticmethod
    def load(path: str) -> Dict[str, Any]:
        if path.endswith(".cbor"):
            try:
                import cbor2
                with open(path, "rb") as f:
                    return cbor2.load(f)
            except ImportError:
                pass
        with open(path) as f:
            return json.load(f)

    @staticmethod
    def replay(path: str, viewer: ViewerBase):
        """Feed a recording into another viewer frame by frame."""
        data = ViewerFile.load(path)
        for frame in data["frames"]:
            viewer.begin_frame(frame["time"])
            for name, v in frame.get("scalars", {}).items():
                viewer.log_scalar(name, v)
            viewer.end_frame()
        return data
