"""Rerun viewer backend (port of ``newton_tpu/viewer/viewer_rerun.py``):
shapes logged once as primitives, states as transforms, to a rerun
recording or stream. Needs the optional ``rerun-sdk`` package, imported
when the viewer is made; without it the constructor raises naming it."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..geometry.types import GeoType
from ..math import quat_to_matrix
from .viewer import ViewerBase, to_numpy

__all__ = ["ViewerRerun"]


class ViewerRerun(ViewerBase):
    def __init__(self, app_id: str = "newton_tpu", spawn: bool = True,
                 save_path: Optional[str] = None):
        super().__init__()
        try:
            import rerun as rr
        except ImportError as e:
            raise ImportError(
                "ViewerRerun requires the 'rerun-sdk' package") from e
        self.rr = rr
        rr.init(app_id, spawn=spawn)
        if save_path:
            rr.save(save_path)

    def set_model(self, model):
        super().set_model(model)
        rr = self.rr
        st = model.structure
        scale = to_numpy(model.shape_scale)
        for s in range(st.shape_count):
            t = GeoType(int(st.shape_type[s]))
            path = f"shapes/{st.shape_key[s]}"
            if t == GeoType.SPHERE:
                rr.log(path, rr.Ellipsoids3D(half_sizes=[[scale[s, 0]] * 3]),
                       static=True)
            elif t == GeoType.BOX:
                rr.log(path, rr.Boxes3D(half_sizes=[scale[s]]), static=True)
            elif t in (GeoType.CAPSULE, GeoType.CYLINDER):
                rr.log(path, rr.Capsules3D(lengths=[2 * scale[s, 1]],
                                           radii=[scale[s, 0]]), static=True)

    def log_state(self, state):
        rr = self.rr
        st = self.model.structure
        rr.set_time_seconds("sim", self.time)
        bq = to_numpy(state.body_q)
        rot = to_numpy(quat_to_matrix(state.body_q[:, 3:7]))
        for s in range(st.shape_count):
            b = int(st.shape_body[s])
            if b < 0:
                continue
            rr.log(f"shapes/{st.shape_key[s]}",
                   rr.Transform3D(translation=bq[b, :3], mat3x3=rot[b]))
        if state.particle_q.shape[-2]:
            rr.log("particles", rr.Points3D(to_numpy(state.particle_q)))

    def log_points(self, name, points, radius=0.01, colors=None):
        self.rr.log(name, self.rr.Points3D(to_numpy(points), radii=radius,
                                           colors=colors))

    def log_lines(self, name, starts, ends, colors=None):
        seg = np.stack([to_numpy(starts), to_numpy(ends)], axis=1)
        self.rr.log(name, self.rr.LineStrips3D(seg, colors=colors))

    def log_mesh(self, name, vertices, indices, xform=None, colors=None):
        from ..core.host_math import np_transform_point
        v = to_numpy(vertices)
        if xform is not None:
            v = np.stack([np_transform_point(to_numpy(xform), p) for p in v])
        self.rr.log(name, self.rr.Mesh3D(
            vertex_positions=v,
            triangle_indices=to_numpy(indices).reshape(-1, 3)))

    def log_image(self, name, image):
        self.rr.log(name, self.rr.Image(to_numpy(image)))

    def log_scalar(self, name, value):
        super().log_scalar(name, value)
        self.rr.log(name, self.rr.Scalar(float(value)))
