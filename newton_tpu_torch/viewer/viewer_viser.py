"""Viser web viewer backend (port of ``newton_tpu/viewer/viewer_viser.py``):
shapes registered once from the model, their scene-graph frames moved each
logged state. Needs the optional ``viser`` package, imported when the
viewer is made; without it the constructor raises naming it."""

from __future__ import annotations

import numpy as np

from ..geometry.types import GeoType
from .viewer import ViewerBase, to_numpy

__all__ = ["ViewerViser"]


class ViewerViser(ViewerBase):
    """Web viewer through viser."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080):
        try:
            import viser
        except ImportError as e:
            raise ImportError(
                "ViewerViser requires the optional 'viser' package "
                "(pip install viser)") from e
        super().__init__()
        self._server = viser.ViserServer(host=host, port=port)
        self._frames = {}

    def set_model(self, model):
        super().set_model(model)
        st = model.structure
        scale = to_numpy(model.shape_scale)
        sid = st.shape_source_id
        for i in range(st.shape_count):
            t = GeoType(int(st.shape_type[i]))
            name = f"/shapes/{st.shape_key[i]}"
            if t == GeoType.SPHERE:
                self._server.scene.add_icosphere(
                    name, radius=float(scale[i, 0]))
            elif t == GeoType.BOX:
                self._server.scene.add_box(
                    name, dimensions=tuple(2.0 * scale[i]))
            elif t in (GeoType.MESH, GeoType.CONVEX) and len(sid) \
                    and sid[i] >= 0 and st.meshes:
                src = st.meshes[int(sid[i])]
                self._server.scene.add_mesh_simple(
                    name, vertices=np.asarray(src.vertices),
                    faces=np.asarray(src.indices).reshape(-1, 3))
            # other types: represented by their frame only
            self._frames[i] = self._server.scene.add_frame(
                name + "/frame", show_axes=False)

    def log_state(self, state):
        from ..geometry.raycast import shape_world_transforms
        X = to_numpy(shape_world_transforms(self.model, state))
        for i, frame in self._frames.items():
            frame.position = tuple(X[i, :3])
            q = X[i, 3:7]
            frame.wxyz = (float(q[3]), float(q[0]), float(q[1]), float(q[2]))

    def log_points(self, name, points, radius=0.01, colors=None):
        p = to_numpy(points)
        c = (to_numpy(colors) if colors is not None
             else np.full((len(p), 3), 0.8))
        self._server.scene.add_point_cloud(name, points=p, colors=c,
                                           point_size=float(radius))

    def log_lines(self, name, starts, ends, colors=None):
        seg = np.stack([to_numpy(starts), to_numpy(ends)], axis=1)
        self._server.scene.add_line_segments(name, points=seg)

    def is_running(self) -> bool:
        return True
