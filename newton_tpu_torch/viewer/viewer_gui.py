"""On-screen panel of the OpenGL viewer (port of
``newton_tpu/viewer/viewer_gui.py``), in two halves so the layout is
testable without a display: ``GuiPanel`` composes the panel's text lines
from the viewer's state (paused, frame, FPS, world filter, picked shape,
logged scalars) and ``layout_text`` lays them out as glyph quads;
``GlTextOverlay`` draws them over a translucent backdrop from a font atlas
that PIL rasterizes. PIL and OpenGL are needed only by the GL half.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["GuiPanel", "GlTextOverlay"]


class GuiPanel:
    """Composes the HUD text lines (pure; testable without a display).

    Mirrors the reference panel's content (viewer_gui.py: sim controls +
    status): running/paused state, frame counter and FPS, the world
    filter ("all" or a single world index), the picked shape, and the
    key map.
    """

    HELP = [
        "SPACE pause   .  step     H   panel",
        "[ ]   world   ESC quit    LMB drag-pick",
    ]

    def __init__(self):
        self.extra_rows: List[Tuple[str, str]] = []

    def log_scalar(self, name: str, value: float):
        """Show a user scalar on the panel (ViewerBase.log_scalar hook)."""
        rows = [r for r in self.extra_rows if r[0] != name]
        rows.append((name, f"{float(value):.4g}"))
        self.extra_rows = rows[-6:]          # keep the panel bounded

    def compose(self, paused: bool, frame: int, fps: float,
                world_filter: Optional[int], world_count: int,
                picked_shape: Optional[int] = None,
                sim_time: Optional[float] = None) -> List[str]:
        lines = [
            f"newton_tpu  {'PAUSED' if paused else 'running'}",
            f"frame {frame}"
            + (f"   t={sim_time:.3f}s" if sim_time is not None else "")
            + (f"   {fps:.0f} fps" if fps > 0 else ""),
            ("world: all" if world_filter is None
             else f"world: {world_filter}/{world_count}"),
        ]
        if picked_shape is not None and picked_shape >= 0:
            lines.append(f"picked shape {picked_shape}")
        for name, val in self.extra_rows:
            lines.append(f"{name}: {val}")
        lines.append("-" * 34)
        lines.extend(self.HELP)
        return lines


def _build_font_atlas(size: int = 13):
    """Rasterize ASCII 32..126 into one grayscale strip via PIL's default
    font. Returns (atlas uint8 (H, W), glyph_w, glyph_h)."""
    from PIL import Image, ImageDraw, ImageFont
    try:
        font = ImageFont.load_default(size=size)
    except TypeError:                        # older PIL: fixed-size default
        font = ImageFont.load_default()
    chars = [chr(c) for c in range(32, 127)]
    probe = Image.new("L", (4 * size, 4 * size))
    d = ImageDraw.Draw(probe)
    bbox = d.textbbox((0, 0), "M", font=font)
    gw, gh = bbox[2] - bbox[0] + 1, bbox[3] + 3
    img = Image.new("L", (gw * len(chars), gh), 0)
    d = ImageDraw.Draw(img)
    for i, ch in enumerate(chars):
        d.text((i * gw, 1), ch, fill=255, font=font)
    return np.asarray(img, dtype=np.uint8), gw, gh


def layout_text(lines: List[str], gw: int, gh: int,
                origin: Tuple[int, int] = (12, 10),
                pad: int = 8) -> Tuple[np.ndarray, Tuple[int, int, int, int]]:
    """Lay text out into per-character quads.

    Returns ``(quads, panel_rect)`` where ``quads`` is
    (n_chars, 6, 4) float32 [x_px, y_px, u_char, v] vertices (two triangles
    per glyph; u_char is the ASCII-indexed atlas column, v in {0, 1}) and
    ``panel_rect`` is the (x, y, w, h) backdrop box. Pure — unit-tested
    headless."""
    ox, oy = origin
    verts = []
    maxw = 0
    for li, line in enumerate(lines):
        y0, y1 = oy + li * gh, oy + (li + 1) * gh
        maxw = max(maxw, len(line))
        for ci, ch in enumerate(line):
            code = ord(ch)
            if code < 32 or code > 126 or ch == " ":
                continue
            u = float(code - 32)
            x0, x1 = ox + ci * gw, ox + (ci + 1) * gw
            verts.append([[x0, y0, u, 0.0], [x1, y0, u + 1.0, 0.0],
                          [x1, y1, u + 1.0, 1.0], [x0, y0, u, 0.0],
                          [x1, y1, u + 1.0, 1.0], [x0, y1, u, 1.0]])
    quads = (np.asarray(verts, dtype=np.float32)
             if verts else np.zeros((0, 6, 4), np.float32))
    rect = (ox - pad, oy - pad, maxw * gw + 2 * pad,
            len(lines) * gh + 2 * pad)
    return quads, rect


_GUI_VERT = """
#version 330 core
layout(location=0) in vec4 v;        // x_px, y_px, u_char, v
uniform vec2 screen;                 // framebuffer size
uniform float n_glyphs;
out vec2 uv;
void main() {
    vec2 ndc = vec2(v.x / screen.x * 2.0 - 1.0,
                    1.0 - v.y / screen.y * 2.0);
    gl_Position = vec4(ndc, 0.0, 1.0);
    uv = vec2(v.z / n_glyphs, v.w);
}
"""

_GUI_FRAG = """
#version 330 core
in vec2 uv;
uniform sampler2D atlas;
uniform vec4 color;                  // rgb + alpha; a<0 => solid backdrop
out vec4 frag;
void main() {
    if (color.a < 0.0) { frag = vec4(color.rgb, -color.a); return; }
    float a = texture(atlas, uv).r;
    frag = vec4(color.rgb, color.a * a);
}
"""


class GlTextOverlay:
    """GL half of the panel: atlas texture + one alpha-blended ortho pass."""

    def __init__(self, GL):
        self.GL = GL
        atlas, self.gw, self.gh = _build_font_atlas()
        self.n_glyphs = atlas.shape[1] // self.gw
        self._prog = self._compile(GL)
        self._tex = GL.glGenTextures(1)
        GL.glBindTexture(GL.GL_TEXTURE_2D, self._tex)
        GL.glPixelStorei(GL.GL_UNPACK_ALIGNMENT, 1)
        GL.glTexImage2D(GL.GL_TEXTURE_2D, 0, GL.GL_RED, atlas.shape[1],
                        atlas.shape[0], 0, GL.GL_RED, GL.GL_UNSIGNED_BYTE,
                        np.ascontiguousarray(atlas))
        for p in (GL.GL_TEXTURE_MIN_FILTER, GL.GL_TEXTURE_MAG_FILTER):
            GL.glTexParameteri(GL.GL_TEXTURE_2D, p, GL.GL_LINEAR)
        self._vao = GL.glGenVertexArrays(1)
        self._vbo = GL.glGenBuffers(1)
        GL.glBindVertexArray(self._vao)
        GL.glBindBuffer(GL.GL_ARRAY_BUFFER, self._vbo)
        GL.glEnableVertexAttribArray(0)
        GL.glVertexAttribPointer(0, 4, GL.GL_FLOAT, False, 16, None)

    def _compile(self, GL):
        def sh(src, kind):
            s = GL.glCreateShader(kind)
            GL.glShaderSource(s, src)
            GL.glCompileShader(s)
            if not GL.glGetShaderiv(s, GL.GL_COMPILE_STATUS):
                raise RuntimeError(GL.glGetShaderInfoLog(s).decode())
            return s
        p = GL.glCreateProgram()
        GL.glAttachShader(p, sh(_GUI_VERT, GL.GL_VERTEX_SHADER))
        GL.glAttachShader(p, sh(_GUI_FRAG, GL.GL_FRAGMENT_SHADER))
        GL.glLinkProgram(p)
        if not GL.glGetProgramiv(p, GL.GL_LINK_STATUS):
            raise RuntimeError(GL.glGetProgramInfoLog(p).decode())
        return p

    def draw(self, lines: List[str], w: int, h: int):
        GL = self.GL
        quads, rect = layout_text(lines, self.gw, self.gh)
        GL.glUseProgram(self._prog)
        loc = lambda n: GL.glGetUniformLocation(self._prog, n)
        GL.glUniform2f(loc("screen"), float(w), float(h))
        GL.glUniform1f(loc("n_glyphs"), float(self.n_glyphs))
        GL.glDisable(GL.GL_DEPTH_TEST)
        GL.glEnable(GL.GL_BLEND)
        GL.glBlendFunc(GL.GL_SRC_ALPHA, GL.GL_ONE_MINUS_SRC_ALPHA)
        GL.glBindVertexArray(self._vao)
        GL.glBindBuffer(GL.GL_ARRAY_BUFFER, self._vbo)
        # backdrop (negative alpha selects the solid-fill shader branch)
        x, y, bw, bh = rect
        bd = np.asarray([[x, y, 0, 0], [x + bw, y, 0, 0],
                         [x + bw, y + bh, 0, 0], [x, y, 0, 0],
                         [x + bw, y + bh, 0, 0], [x, y + bh, 0, 0]],
                        np.float32)
        GL.glUniform4f(loc("color"), 0.06, 0.07, 0.09, -0.72)
        GL.glBufferData(GL.GL_ARRAY_BUFFER, bd.nbytes, bd,
                        GL.GL_DYNAMIC_DRAW)
        GL.glDrawArrays(GL.GL_TRIANGLES, 0, 6)
        if len(quads):
            GL.glActiveTexture(GL.GL_TEXTURE0)
            GL.glBindTexture(GL.GL_TEXTURE_2D, self._tex)
            GL.glUniform1i(loc("atlas"), 0)
            GL.glUniform4f(loc("color"), 0.92, 0.94, 0.96, 1.0)
            v = np.ascontiguousarray(quads.reshape(-1, 4))
            GL.glBufferData(GL.GL_ARRAY_BUFFER, v.nbytes, v,
                            GL.GL_DYNAMIC_DRAW)
            GL.glDrawArrays(GL.GL_TRIANGLES, 0, len(v))
        GL.glDisable(GL.GL_BLEND)
        GL.glEnable(GL.GL_DEPTH_TEST)
