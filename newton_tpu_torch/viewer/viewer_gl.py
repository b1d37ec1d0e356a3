"""Interactive OpenGL viewer (port of ``newton_tpu/viewer/viewer_gl.py``):
a GLFW window with an orbit camera, pause and step keys, a world filter,
and mouse picking that drags a body by a spring.

Shape geometry is tessellated once per distinct (type, scale, source) on
the host; a frame uploads one instance-matrix buffer per geometry group and
draws it with one ``glDrawElementsInstanced``. Picking goes through
``ViewerBase.pick`` (``geometry/raycast.raycast_model``). With
``offscreen=True`` the camera, instancing and picking logic run without a
GL context; otherwise ``glfw`` and ``OpenGL`` are imported when the window
opens, and a host without a display raises.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.host_math import np_transform_multiply
from ..geometry.types import GeoType
from .viewer import ViewerBase, to_numpy

__all__ = ["ViewerGL"]


# ---------------------------------------------------------------------------
# host-side tessellation of the primitive shapes
# ---------------------------------------------------------------------------

def _uv_sphere(radius=1.0, n=16):
    vs, ns, idx = [], [], []
    for i in range(n + 1):
        th = math.pi * i / n
        for j in range(2 * n):
            ph = 2 * math.pi * j / (2 * n)
            d = (math.sin(th) * math.cos(ph), math.sin(th) * math.sin(ph),
                 math.cos(th))
            vs.append([radius * c for c in d])
            ns.append(d)
    w = 2 * n
    for i in range(n):
        for j in range(w):
            a = i * w + j
            b = i * w + (j + 1) % w
            c = (i + 1) * w + j
            d = (i + 1) * w + (j + 1) % w
            idx += [a, c, b, b, c, d]
    return (np.asarray(vs, np.float32), np.asarray(ns, np.float32),
            np.asarray(idx, np.uint32))


def _box(hx, hy, hz):
    faces = []
    for axis in range(3):
        for s in (-1.0, 1.0):
            n = [0.0, 0.0, 0.0]
            n[axis] = s
            u = [0.0, 0.0, 0.0]
            v = [0.0, 0.0, 0.0]
            u[(axis + 1) % 3] = 1.0
            v[(axis + 2) % 3] = s
            faces.append((n, u, v))
    h = np.asarray([hx, hy, hz], np.float32)
    vs, ns, idx = [], [], []
    for n, u, v in faces:
        base = len(vs)
        n = np.asarray(n, np.float32)
        u = np.asarray(u, np.float32)
        v = np.asarray(v, np.float32)
        for su, sv in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            vs.append((n + su * u + sv * v) * h)
            ns.append(n)
        idx += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (np.asarray(vs, np.float32), np.asarray(ns, np.float32),
            np.asarray(idx, np.uint32))


def _capsule(radius, half_h, n=12):
    # cylinder wall + two hemisphere caps, axis +Z
    vs, ns, idx = [], [], []
    for zi, z in ((0, -half_h), (1, half_h)):
        for j in range(2 * n):
            ph = 2 * math.pi * j / (2 * n)
            d = (math.cos(ph), math.sin(ph), 0.0)
            vs.append([radius * d[0], radius * d[1], z])
            ns.append(d)
    w = 2 * n
    for j in range(w):
        a, b = j, (j + 1) % w
        idx += [a, b, w + a, b, w + b, w + a]
    sv, sn, si = _uv_sphere(radius, n)
    for sign in (1.0, -1.0):
        base = len(vs)
        off = np.asarray([0, 0, sign * half_h], np.float32)
        keep = sv[:, 2] * sign >= -1e-6
        vs.extend((sv + off).tolist())
        ns.extend(sn.tolist())
        idx.extend((si + base).tolist())
        del keep
    return (np.asarray(vs, np.float32), np.asarray(ns, np.float32),
            np.asarray(idx, np.uint32))


def _cylinder(radius, half_h, n=16, taper=1.0):
    """Cylinder (taper=1) or cone (taper=0): top radius = radius*taper."""
    vs, ns, idx = [], [], []
    for z, r in ((-half_h, radius), (half_h, radius * taper)):
        for j in range(2 * n):
            ph = 2 * math.pi * j / (2 * n)
            d = (math.cos(ph), math.sin(ph), 0.0)
            vs.append([r * d[0], r * d[1], z])
            ns.append(d)
    w = 2 * n
    for j in range(w):
        a, b = j, (j + 1) % w
        idx += [a, b, w + a, b, w + b, w + a]
    # caps
    for zi, z, nz in ((0, -half_h, -1.0), (1, half_h, 1.0)):
        base = len(vs)
        vs.append([0.0, 0.0, z])
        ns.append([0.0, 0.0, nz])
        ring = zi * w
        for j in range(w):
            a, b = ring + j, ring + (j + 1) % w
            idx += ([base, b, a] if nz < 0 else [base, a, b])
    return (np.asarray(vs, np.float32), np.asarray(ns, np.float32),
            np.asarray(idx, np.uint32))


def _plane_quad(size=50.0):
    vs = np.asarray([[-size, -size, 0], [size, -size, 0], [size, size, 0],
                     [-size, size, 0]], np.float32)
    ns = np.tile(np.asarray([[0, 0, 1]], np.float32), (4, 1))
    idx = np.asarray([0, 1, 2, 0, 2, 3], np.uint32)
    return vs, ns, idx


def _mesh_normals(verts, faces):
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    n = np.zeros_like(verts)
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    for k in range(3):
        np.add.at(n, faces[:, k], fn)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(ln, 1e-9)


def shape_geometry(model, s: int):
    """Tessellate shape ``s`` of the model: (verts, normals, indices)."""
    st = model.structure
    t = int(st.shape_type[s])
    sc = to_numpy(model.shape_scale)[s]
    if t == int(GeoType.PLANE):
        return _plane_quad()
    if t == int(GeoType.SPHERE):
        return _uv_sphere(sc[0])
    if t == int(GeoType.BOX):
        return _box(sc[0], sc[1], sc[2])
    if t == int(GeoType.CAPSULE):
        return _capsule(sc[0], sc[1])
    if t == int(GeoType.CYLINDER):
        return _cylinder(sc[0], sc[1])
    if t == int(GeoType.CONE):
        return _cylinder(sc[0], sc[1], taper=0.0)
    if t == int(GeoType.ELLIPSOID):
        v, n, i = _uv_sphere(1.0)
        return (v * sc[None, :].astype(np.float32), n, i)
    sid = st.shape_source_id
    src = int(sid[s]) if len(sid) else -1
    if t in (int(GeoType.MESH), int(GeoType.CONVEX)) and src >= 0 \
            and st.meshes:
        mesh = st.meshes[src]
        verts = mesh.vertices.astype(np.float32) * sc[None, :]
        faces = np.asarray(mesh.indices, np.int64)
        return verts, _mesh_normals(verts, faces), faces.astype(np.uint32)
    if t == int(GeoType.HFIELD) and src >= 0 and st.heightfields:
        from ..geometry.terrain import heightfield_to_mesh
        m = heightfield_to_mesh(st.heightfields[src])
        verts = np.asarray(m.vertices, np.float32)
        faces = np.asarray(m.indices, np.int64)
        return verts, _mesh_normals(verts, faces), faces.astype(np.uint32)
    # fallback: unit sphere stand-in
    return _uv_sphere(max(float(sc[0]), 0.05))


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------

class OrbitCamera:
    """Orbit camera: yaw/pitch around a target, scroll dolly, pan."""

    def __init__(self):
        self.target = np.zeros(3, np.float32)
        self.yaw = 0.8
        self.pitch = 0.5
        self.dist = 4.0
        self.fov = 45.0

    def eye(self) -> np.ndarray:
        cp = math.cos(self.pitch)
        d = np.asarray([cp * math.cos(self.yaw), cp * math.sin(self.yaw),
                        math.sin(self.pitch)], np.float32)
        return self.target + self.dist * d

    def view(self) -> np.ndarray:
        eye = self.eye()
        f = self.target - eye
        f = f / np.linalg.norm(f)
        up = np.asarray([0.0, 0.0, 1.0], np.float32)
        s = np.cross(f, up)
        s = s / max(np.linalg.norm(s), 1e-9)
        u = np.cross(s, f)
        M = np.eye(4, dtype=np.float32)
        M[0, :3], M[1, :3], M[2, :3] = s, u, -f
        M[:3, 3] = -M[:3, :3] @ eye
        return M

    def proj(self, aspect: float, near=0.02, far=500.0) -> np.ndarray:
        t = 1.0 / math.tan(math.radians(self.fov) / 2)
        M = np.zeros((4, 4), np.float32)
        M[0, 0] = t / aspect
        M[1, 1] = t
        M[2, 2] = (far + near) / (near - far)
        M[2, 3] = 2 * far * near / (near - far)
        M[3, 2] = -1.0
        return M

    def ray(self, x: float, y: float, w: int, h: int):
        """World ray through pixel (x, y)."""
        ndc = np.asarray([2 * x / w - 1, 1 - 2 * y / h], np.float32)
        t = math.tan(math.radians(self.fov) / 2)
        V = self.view()
        R = V[:3, :3].T                 # camera -> world
        d_cam = np.asarray([ndc[0] * t * (w / h), ndc[1] * t, -1.0],
                           np.float32)
        d = R @ d_cam
        return self.eye(), d / np.linalg.norm(d)


_VERT = """
#version 330 core
layout(location=0) in vec3 pos;
layout(location=1) in vec3 nrm;
layout(location=2) in mat4 inst;   // per-instance model matrix (4 attribs)
uniform mat4 view;
uniform mat4 proj;
out vec3 v_nrm;
out vec3 v_pos;
void main() {
    vec4 wp = inst * vec4(pos, 1.0);
    v_pos = wp.xyz;
    v_nrm = mat3(inst) * nrm;
    gl_Position = proj * view * wp;
}
"""

_FRAG = """
#version 330 core
in vec3 v_nrm;
in vec3 v_pos;
uniform vec3 color;
uniform vec3 eye;
out vec4 frag;
void main() {
    vec3 n = normalize(v_nrm);
    vec3 l = normalize(vec3(0.4, 0.3, 0.85));
    float diff = max(dot(n, l), 0.0) * 0.7 + 0.3;
    vec3 v = normalize(eye - v_pos);
    float spec = pow(max(dot(reflect(-l, n), v), 0.0), 24.0) * 0.2;
    frag = vec4(color * diff + vec3(spec), 1.0);
}
"""


class ViewerGL(ViewerBase):
    """Interactive GLFW/OpenGL viewer (reference viewer_gl.py:177).

    Keys: SPACE pause/resume, ``.`` single-step while paused, ``H`` toggle
    the GUI panel, ``[`` / ``]`` cycle the world filter, ESC close.
    Mouse: right-drag orbit, middle-drag pan, scroll dolly, left-drag picks
    the shape under the cursor and drags its body with a spring
    (``apply_forces``; reference viewer/picking.py).

    The on-screen panel (``viewer_gui.GuiPanel`` — the reference's shared
    ImGui panel, viewer_gui.py:33) shows run state, frame/FPS, the world
    selector, picked shape, and any ``log_scalar`` values.
    """

    def __init__(self, width: int = 1280, height: int = 720,
                 title: str = "newton_tpu_torch", offscreen: bool = False):
        super().__init__()
        self.width, self.height = int(width), int(height)
        self.camera = OrbitCamera()
        self.paused = False
        self._single_step = False
        self._running = True
        self.offscreen = bool(offscreen)
        self._window = None
        self._groups: List[Dict] = []
        self._pick: Optional[Dict] = None
        self._mouse: Tuple[float, float] = (0.0, 0.0)
        self._body_q: Optional[np.ndarray] = None
        self._state = None
        self.pick_stiffness = 40.0
        # GUI panel (reference: viewer/viewer_gui.py:33 shared ImGui panel)
        from .viewer_gui import GuiPanel
        self.gui = GuiPanel()
        self.show_gui = True
        self.world_filter: Optional[int] = None   # None = all worlds
        self._overlay = None
        self._frame = 0
        self._fps = 0.0
        self._fps_t: Optional[float] = None
        if not self.offscreen:
            self._init_gl(title)

    # -- GL bring-up ---------------------------------------------------
    def _init_gl(self, title):
        try:
            import glfw
        except ImportError as e:            # pragma: no cover
            raise RuntimeError("ViewerGL requires the 'glfw' package") from e
        if not glfw.init():
            raise RuntimeError(
                "GLFW failed to initialize — ViewerGL needs a display "
                "(X11/Wayland). Use ViewerGL(offscreen=True), ViewerViser "
                "or ViewerFile on headless hosts.")
        glfw.window_hint(glfw.CONTEXT_VERSION_MAJOR, 3)
        glfw.window_hint(glfw.CONTEXT_VERSION_MINOR, 3)
        glfw.window_hint(glfw.OPENGL_PROFILE, glfw.OPENGL_CORE_PROFILE)
        self._window = glfw.create_window(self.width, self.height, title,
                                          None, None)
        if not self._window:
            glfw.terminate()
            raise RuntimeError("GLFW window creation failed")
        glfw.make_context_current(self._window)
        glfw.set_key_callback(self._window, self._on_key)
        glfw.set_cursor_pos_callback(self._window, self._on_cursor)
        glfw.set_mouse_button_callback(self._window, self._on_button)
        glfw.set_scroll_callback(self._window, self._on_scroll)
        from OpenGL import GL
        GL.glEnable(GL.GL_DEPTH_TEST)
        self._prog = self._compile(GL)
        self._glfw = glfw
        self._GL = GL

    def _compile(self, GL):
        def sh(src, kind):
            s = GL.glCreateShader(kind)
            GL.glShaderSource(s, src)
            GL.glCompileShader(s)
            if not GL.glGetShaderiv(s, GL.GL_COMPILE_STATUS):
                raise RuntimeError(GL.glGetShaderInfoLog(s).decode())
            return s
        p = GL.glCreateProgram()
        GL.glAttachShader(p, sh(_VERT, GL.GL_VERTEX_SHADER))
        GL.glAttachShader(p, sh(_FRAG, GL.GL_FRAGMENT_SHADER))
        GL.glLinkProgram(p)
        if not GL.glGetProgramiv(p, GL.GL_LINK_STATUS):
            raise RuntimeError(GL.glGetProgramInfoLog(p).decode())
        return p

    # -- model upload --------------------------------------------------
    def set_model(self, model):
        super().set_model(model)
        st = model.structure
        S = st.shape_count
        # group shapes by identical geometry (type + scale + mesh source)
        keys: Dict[tuple, int] = {}
        self._groups = []
        shape_of_group: List[List[int]] = []
        scales = to_numpy(model.shape_scale)
        sid = st.shape_source_id
        for s in range(S):
            t = int(st.shape_type[s])
            mid = int(sid[s]) if len(sid) else -1
            key = (t, tuple(np.round(scales[s], 6)), mid)
            gi = keys.get(key)
            if gi is None:
                gi = keys[key] = len(self._groups)
                v, n, i = shape_geometry(model, s)
                self._groups.append(dict(verts=v, normals=n, indices=i,
                                         shapes=[], color=_color_for(t)))
                shape_of_group.append([])
            self._groups[gi]["shapes"].append(s)
        self._shape_body = np.asarray(st.shape_body)
        self._shape_xf = to_numpy(model.shape_transform)
        self._shape_world = np.asarray(st.shape_world)
        self._world_count = int(st.world_count or 1)
        if not self.offscreen:
            self._upload_groups()

    def _upload_groups(self):
        GL = self._GL
        for g in self._groups:
            vao = GL.glGenVertexArrays(1)
            GL.glBindVertexArray(vao)
            vbo = GL.glGenBuffers(1)
            GL.glBindBuffer(GL.GL_ARRAY_BUFFER, vbo)
            data = np.concatenate([g["verts"], g["normals"]], axis=1)
            GL.glBufferData(GL.GL_ARRAY_BUFFER, data.nbytes,
                            data.astype(np.float32), GL.GL_STATIC_DRAW)
            GL.glEnableVertexAttribArray(0)
            GL.glVertexAttribPointer(0, 3, GL.GL_FLOAT, False, 24, None)
            GL.glEnableVertexAttribArray(1)
            GL.glVertexAttribPointer(1, 3, GL.GL_FLOAT, False, 24,
                                     GL.ctypes.c_void_p(12))
            ebo = GL.glGenBuffers(1)
            GL.glBindBuffer(GL.GL_ELEMENT_ARRAY_BUFFER, ebo)
            GL.glBufferData(GL.GL_ELEMENT_ARRAY_BUFFER,
                            g["indices"].nbytes, g["indices"],
                            GL.GL_STATIC_DRAW)
            # per-instance mat4 occupies attribute slots 2..5
            ibo = GL.glGenBuffers(1)
            GL.glBindBuffer(GL.GL_ARRAY_BUFFER, ibo)
            for k in range(4):
                GL.glEnableVertexAttribArray(2 + k)
                GL.glVertexAttribPointer(2 + k, 4, GL.GL_FLOAT, False, 64,
                                         GL.ctypes.c_void_p(16 * k))
                GL.glVertexAttribDivisor(2 + k, 1)
            g["vao"], g["ibo"] = vao, ibo

    # -- frame ---------------------------------------------------------
    def log_state(self, state):
        self._state = state
        self._body_q = to_numpy(state.body_q)

    def instance_matrices(self, group) -> np.ndarray:
        """(n_inst, 4, 4) world matrices for a geometry group (honors the
        GUI world filter: only instances of the selected world render)."""
        mats = []
        ident = np.asarray([0, 0, 0, 0, 0, 0, 1.0])
        wf = self.world_filter
        for s in group["shapes"]:
            if wf is not None:
                w = int(self._shape_world[s])
                if w >= 0 and w != wf:
                    continue
            b = int(self._shape_body[s])
            Xb = (self._body_q[b] if (b >= 0 and self._body_q is not None)
                  else ident)
            X = np_transform_multiply(np.asarray(Xb, np.float64),
                                      np.asarray(self._shape_xf[s],
                                                 np.float64))
            mats.append(_transform_matrix(X))
        return np.asarray(mats, np.float32)

    def end_frame(self):
        if self.offscreen or self._window is None:
            return
        GL, glfw = self._GL, self._glfw
        if glfw.window_should_close(self._window):
            self._running = False
            return
        w, h = glfw.get_framebuffer_size(self._window)
        GL.glViewport(0, 0, w, h)
        GL.glClearColor(0.08, 0.09, 0.11, 1.0)
        GL.glClear(GL.GL_COLOR_BUFFER_BIT | GL.GL_DEPTH_BUFFER_BIT)
        GL.glUseProgram(self._prog)
        loc = lambda n: GL.glGetUniformLocation(self._prog, n)
        GL.glUniformMatrix4fv(loc("view"), 1, True, self.camera.view())
        GL.glUniformMatrix4fv(loc("proj"), 1, True,
                              self.camera.proj(w / max(h, 1)))
        GL.glUniform3f(loc("eye"), *self.camera.eye())
        for g in self._groups:
            mats = self.instance_matrices(g)
            GL.glBindVertexArray(g["vao"])
            GL.glBindBuffer(GL.GL_ARRAY_BUFFER, g["ibo"])
            m = np.ascontiguousarray(np.transpose(mats, (0, 2, 1)))
            GL.glBufferData(GL.GL_ARRAY_BUFFER, m.nbytes, m,
                            GL.GL_DYNAMIC_DRAW)
            GL.glUniform3f(loc("color"), *g["color"])
            GL.glDrawElementsInstanced(GL.GL_TRIANGLES, len(g["indices"]),
                                       GL.GL_UNSIGNED_INT, None, len(mats))
        if self.show_gui:
            self._draw_gui(GL, w, h)
        glfw.swap_buffers(self._window)
        glfw.poll_events()

    def _draw_gui(self, GL, w, h):
        import time as _time
        self._frame += 1
        now = _time.perf_counter()
        if self._fps_t is not None:
            dt = now - self._fps_t
            if dt > 1e-6:
                inst = 1.0 / dt
                self._fps = (0.9 * self._fps + 0.1 * inst
                             if self._fps > 0 else inst)
        self._fps_t = now
        if self._overlay is None:
            try:
                from .viewer_gui import GlTextOverlay
                self._overlay = GlTextOverlay(GL)
            except Exception:           # no PIL / GL limitation: disable
                self.show_gui = False
                return
        picked = (int(self._pick["shape"]) if self._pick is not None
                  and "shape" in self._pick else None)
        lines = self.gui.compose(
            self.paused, self._frame, self._fps, self.world_filter,
            getattr(self, "_world_count", 1), picked_shape=picked)
        self._overlay.draw(lines, w, h)

    def log_scalar(self, name, value):
        super().log_scalar(name, value)
        self.gui.log_scalar(name, float(np.asarray(value).reshape(-1)[0]))

    def is_running(self) -> bool:
        return self._running

    @property
    def wants_step(self) -> bool:
        """True when the sim should advance this frame (pause/step keys)."""
        if not self.paused:
            return True
        if self._single_step:
            self._single_step = False
            return True
        return False

    def close(self):
        if self._window is not None:
            self._glfw.destroy_window(self._window)
            self._glfw.terminate()
            self._window = None
        self._running = False

    # -- input ---------------------------------------------------------
    def _on_key(self, win, key, scancode, action, mods):
        glfw = self._glfw
        if action != glfw.PRESS:
            return
        if key == glfw.KEY_ESCAPE:
            self._running = False
        elif key == glfw.KEY_SPACE:
            self.paused = not self.paused
        elif key == glfw.KEY_PERIOD:
            self._single_step = True
        elif key == glfw.KEY_H:
            self.show_gui = not self.show_gui
        elif key in (glfw.KEY_LEFT_BRACKET, glfw.KEY_RIGHT_BRACKET):
            # world selector: cycles all -> 0 -> 1 -> ... -> all
            n = getattr(self, "_world_count", 1)
            cur = -1 if self.world_filter is None else self.world_filter
            step = 1 if key == glfw.KEY_RIGHT_BRACKET else -1
            cur = cur + step
            if cur < -1:
                cur = n - 1
            elif cur >= n:
                cur = -1
            self.world_filter = None if cur < 0 else cur

    def _on_cursor(self, win, x, y):
        glfw = self._glfw
        dx = x - self._mouse[0]
        dy = y - self._mouse[1]
        self._mouse = (x, y)
        if glfw.get_mouse_button(win, glfw.MOUSE_BUTTON_RIGHT):
            self.camera.yaw -= dx * 0.01
            self.camera.pitch = float(np.clip(
                self.camera.pitch + dy * 0.01, -1.5, 1.5))
        elif glfw.get_mouse_button(win, glfw.MOUSE_BUTTON_MIDDLE):
            V = self.camera.view()
            right, up = V[0, :3], V[1, :3]
            scale = self.camera.dist * 0.0015
            self.camera.target += (-dx * right + dy * up) * scale
        elif self._pick is not None:
            w, h = glfw.get_framebuffer_size(win)
            o, d = self.camera.ray(x, y, w, h)
            self._pick["target"] = o + d * self._pick["depth"]

    def _on_button(self, win, button, action, mods):
        glfw = self._glfw
        if button != glfw.MOUSE_BUTTON_LEFT:
            return
        if action == glfw.RELEASE:
            self._pick = None
            return
        if self._state is None:
            return
        x, y = glfw.get_cursor_pos(win)
        w, h = glfw.get_framebuffer_size(win)
        o, d = self.camera.ray(x, y, w, h)
        sidx, t = self.pick(self._state, o, d)
        if sidx >= 0 and np.isfinite(t):
            self.start_pick(sidx, o, d, t)

    def _on_scroll(self, win, dx, dy):
        self.camera.dist = float(np.clip(
            self.camera.dist * (0.92 ** dy), 0.1, 200.0))

    # -- picking spring (reference viewer/picking.py:17) ----------------
    def start_pick(self, shape: int, origin, direction, t: float):
        b = int(self._shape_body[shape])
        if b < 0:
            return
        hit = np.asarray(origin) + np.asarray(direction) * t
        self._pick = dict(shape=shape, body=b, depth=float(t),
                          target=hit.copy(), hit=hit.copy())

    def apply_forces(self, state):
        """Velocity-level drag spring toward the pick target (works with
        every solver because it edits body velocity directly)."""
        if self._pick is None:
            return state
        b = self._pick["body"]
        pos = state.body_q[b, 0:3]
        delta = torch.as_tensor(self._pick["target"], dtype=pos.dtype,
                                device=pos.device) - pos
        k = self.pick_stiffness
        v = state.body_qd[b, 0:3]
        body_qd = state.body_qd.clone()
        body_qd[b, 0:3] = v * 0.85 + k * delta * 0.05
        return replace(state, body_qd=body_qd)


def _transform_matrix(X) -> np.ndarray:
    """(p, q) 7-vector transform -> 4x4 row-major world matrix."""
    x, y, z, w = X[3], X[4], X[5], X[6]
    M = np.eye(4, dtype=np.float32)
    M[:3, :3] = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    M[:3, 3] = X[0:3]
    return M


def _color_for(t: int):
    palette = {
        int(GeoType.PLANE): (0.35, 0.37, 0.40),
        int(GeoType.SPHERE): (0.80, 0.45, 0.25),
        int(GeoType.BOX): (0.35, 0.55, 0.80),
        int(GeoType.CAPSULE): (0.45, 0.70, 0.45),
        int(GeoType.CYLINDER): (0.65, 0.55, 0.30),
        int(GeoType.CONE): (0.65, 0.40, 0.60),
        int(GeoType.MESH): (0.60, 0.60, 0.65),
        int(GeoType.CONVEX): (0.55, 0.65, 0.70),
    }
    return palette.get(t, (0.6, 0.6, 0.6))
