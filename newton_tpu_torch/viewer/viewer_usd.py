"""USD stage viewer (port of ``newton_tpu/viewer/viewer_usd.py``): writes
a time-sampled ``.usda`` text file (no pxr needed), shape prims with
UsdGeom types and per-frame ``xformOp:translate``/``xformOp:orient``
samples, the same text as the JAX package writes."""

from __future__ import annotations

from typing import Dict, List, Optional

from ..geometry.types import GeoType
from .viewer import ViewerBase, to_numpy

__all__ = ["ViewerUSD"]


class ViewerUSD(ViewerBase):
    def __init__(self, output_path: str = "stage.usda", fps: float = 60.0,
                 up_axis: str = "Z"):
        super().__init__()
        self.output_path = output_path
        self.fps = float(fps)
        self.up_axis = up_axis
        self._samples: Dict[int, List] = {}      # shape -> [(t, p, q)]
        self._particle_samples: List = []
        self._frames = 0

    def log_state(self, state):
        from ..geometry.raycast import shape_world_transforms
        st = self.model.structure
        X_ws = to_numpy(shape_world_transforms(self.model, state))
        t = self.time * self.fps
        for s in range(st.shape_count):
            self._samples.setdefault(s, []).append(
                (t, X_ws[s, :3].tolist(), X_ws[s, 3:7].tolist()))
        if state.particle_q.shape[-2]:
            self._particle_samples.append(
                (t, to_numpy(state.particle_q).tolist()))
        self._frames += 1

    def close(self):
        self.save()

    def save(self, path: Optional[str] = None):
        path = path or self.output_path
        st = self.model.structure
        scale = to_numpy(self.model.shape_scale)
        lines = ["#usda 1.0", "(", f'    upAxis = "{self.up_axis}"',
                 f"    timeCodesPerSecond = {self.fps}",
                 "    startTimeCode = 0",
                 f"    endTimeCode = {max(self._frames - 1, 0)}", ")", ""]
        lines.append('def Xform "World"')
        lines.append("{")
        for s in range(st.shape_count):
            t = GeoType(int(st.shape_type[s]))
            name = st.shape_key[s].replace("/", "_").replace(".", "_")
            geom = {GeoType.SPHERE: "Sphere", GeoType.BOX: "Cube",
                    GeoType.CAPSULE: "Capsule", GeoType.CYLINDER: "Cylinder",
                    GeoType.PLANE: "Plane", GeoType.MESH: "Mesh"}.get(t)
            if geom is None:
                continue
            lines.append(f'    def {geom} "{name}"')
            lines.append("    {")
            if t == GeoType.SPHERE:
                lines.append(f"        double radius = {scale[s, 0]}")
            elif t == GeoType.BOX:
                lines.append("        double size = 2")
                lines.append(f"        float3 xformOp:scale = "
                             f"({scale[s, 0]}, {scale[s, 1]}, {scale[s, 2]})")
            elif t in (GeoType.CAPSULE, GeoType.CYLINDER):
                lines.append(f"        double radius = {scale[s, 0]}")
                lines.append(f"        double height = {2 * scale[s, 1]}")
                lines.append('        uniform token axis = "Z"')
            samples = self._samples.get(s, [])
            if samples:
                lines.append("        double3 xformOp:translate.timeSamples"
                             " = {")
                for (tc, p, q) in samples:
                    lines.append(f"            {tc}: ({p[0]}, {p[1]}, "
                                 f"{p[2]}),")
                lines.append("        }")
                lines.append("        quatf xformOp:orient.timeSamples = {")
                for (tc, p, q) in samples:
                    lines.append(f"            {tc}: ({q[3]}, {q[0]}, "
                                 f"{q[1]}, {q[2]}),")
                lines.append("        }")
                ops = ['"xformOp:translate"', '"xformOp:orient"']
                if t == GeoType.BOX:
                    ops.append('"xformOp:scale"')
                lines.append(f"        uniform token[] xformOpOrder = "
                             f"[{', '.join(ops)}]")
            lines.append("    }")
        if self._particle_samples:
            lines.append('    def Points "particles"')
            lines.append("    {")
            lines.append("        point3f[] points.timeSamples = {")
            for (tc, pts) in self._particle_samples:
                pts_s = ", ".join(f"({p[0]}, {p[1]}, {p[2]})" for p in pts)
                lines.append(f"            {tc}: [{pts_s}],")
            lines.append("        }")
            lines.append("    }")
        lines.append("}")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
