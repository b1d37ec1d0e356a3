"""Parity of the port's viewers with the JAX package's: ViewerNull's frame
limit, ViewerFile's JSON, ViewerUSD's text, ViewerRTX's PNG, picking,
ViewerGL's tessellation, view ray, instance matrices, world filter and
pick spring, the GUI panel's layout, ViewerPlot under matplotlib's Agg
backend, and the optional rerun and viser backends raising for their
packages."""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch import viewer as tviewer

torch.set_num_threads(1)


def pendulum(lib):
    """tests/test_utils.py's pendulum: a box link on a revolute joint."""
    b = lib.ModelBuilder()
    link = b.add_body(xform=[0.5, 0, 0, 0, 0, 0, 1])
    b.add_shape_box(link, hx=0.5, hy=0.05, hz=0.05)
    b.add_joint_revolute(parent=-1, child=link, axis="Y",
                         xform_c=[-0.5, 0, 0, 0, 0, 0, 1])
    return b


def shapes_scene(lib):
    """tests/test_viewer_gl.py's sphere, box and ground, plus a capsule, a
    cylinder, a cone, an ellipsoid, a mesh, tests/test_utils.py's Gaussian
    cloud on the sphere and a heightfield."""
    import importlib
    terrain = importlib.import_module(lib.__name__ + ".geometry.terrain")
    b = lib.ModelBuilder()
    body = b.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1])
    b.add_shape_sphere(body, radius=0.5)
    b.add_joint_free(body)
    body2 = b.add_body(xform=[1.5, 0, 0.25, 0, 0, 0, 1])
    b.add_shape_box(body2, hx=0.25, hy=0.25, hz=0.25)
    b.add_joint_free(body2)
    b.add_ground_plane()
    rest = b.add_body(xform=[0, 2.0, 0.5, 0.1, 0.0, 0.2, 0.97])
    b.add_shape_capsule(rest, radius=0.1, half_height=0.2)
    b.add_shape_cylinder(rest, xform=[0.5, 0, 0, 0, 0, 0, 1], radius=0.1,
                         half_height=0.2)
    b.add_shape_cone(rest, xform=[1.0, 0, 0, 0, 0, 0, 1], radius=0.1,
                     half_height=0.2)
    b.add_shape_ellipsoid(rest, xform=[1.5, 0, 0, 0, 0, 0, 1], rx=0.2,
                          ry=0.1, rz=0.15)
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float64)
    f = np.array([0, 2, 1, 0, 1, 3, 0, 3, 2, 1, 2, 3], np.int32)
    b.add_shape_mesh(rest, xform=[2.0, 0, 0, 0, 0, 0, 1],
                     mesh=lib.Mesh(v * 0.3, f, compute_inertia=False),
                     scale=(1.0, 2.0, 1.0))
    b.add_joint_free(rest)
    b.add_shape_gaussian(body, means=np.zeros((5, 3)),
                         scales=np.full((5, 3), 0.02))
    b.add_shape_heightfield(-1, xform=[4.0, 0, 0, 0, 0, 0, 1],
                            heightfield=terrain.generate_fractal_terrain(
                                nx=6, ny=5, size_x=1.0, size_y=1.0, seed=2))
    return b


def _state_pair(jm, tm, seed):
    """The same body poses (turned by a seeded draw) on both sides."""
    rng = np.random.RandomState(seed)
    bq = np.asarray(jm.body_q).copy()
    bq[:, :3] += 0.1 * rng.randn(len(bq), 3)
    bq[:, 3:] += 0.3 * rng.randn(len(bq), 4)
    bq[:, 3:] /= np.linalg.norm(bq[:, 3:], axis=1, keepdims=True)
    bq = bq.astype(np.float32)
    import jax.numpy as jnp
    ts = tm.state()
    ts.body_q = torch.as_tensor(bq)
    return jm.state().replace(body_q=jnp.asarray(bq)), ts


def test_viewer_null_frame_limit():
    v = tviewer.ViewerNull(max_frames=2)
    assert v.is_running()
    for t in (0.0, 0.1):
        v.begin_frame(t)
        v.end_frame()
    assert not v.is_running() and v.frame_count == 2 and v.fps > 0


def test_viewer_file_json_equals_jax(tmp_path):
    """Three frames of states, scalars and a Gaussian cloud: the JSON the
    port writes equals the JAX package's, and replay feeds the scalars."""
    import newton_tpu as jt
    from newton_tpu.viewer import ViewerFile as JF
    jm, tm = pendulum(jt).finalize(), pendulum(nt).finalize("cpu")
    paths = []
    for lib_m, cls, name in ((jm, JF, "j.json"),
                             (tm, tviewer.ViewerFile, "t.json")):
        path = str(tmp_path / name)
        v = cls(path)
        v.set_model(lib_m)
        s = lib_m.state()
        for i in range(3):
            v.begin_frame(i * 0.1)
            v.log_state(s)
            v.log_scalar("energy", float(i))
            v.log_gaussian("cloud", np.zeros((2, 3)), np.full((2, 3), 0.1),
                           opacities=np.array([0.5, 0.6]))
            v.end_frame()
        v.save()
        paths.append(path)
    with open(paths[0]) as f:
        want = json.load(f)
    with open(paths[1]) as f:
        got = json.load(f)
    assert got == want
    null = tviewer.ViewerNull()
    tviewer.ViewerFile.replay(paths[1], null)
    assert null.scalars["energy"] == [0.0, 1.0, 2.0]


def test_viewer_usd_text_equals_jax(tmp_path):
    """Two frames of the shapes scene at turned poses: the .usda text
    equals the JAX package's."""
    import newton_tpu as jt
    from newton_tpu.viewer import ViewerUSD as JU
    jm, tm = shapes_scene(jt).finalize(), shapes_scene(nt).finalize("cpu")
    texts = []
    for k, (m, cls) in enumerate(((jm, JU), (tm, tviewer.ViewerUSD))):
        path = str(tmp_path / f"{k}.usda")
        v = cls(path)
        v.set_model(m)
        for i in range(2):
            js, ts = _state_pair(jm, tm, i)
            v.begin_frame(i / 60.0)
            v.log_state(js if k == 0 else ts)
            v.end_frame()
        v.save()
        with open(path) as f:
            texts.append(f.read())
    assert texts[1] == texts[0]
    assert 'def Cube' in texts[1] and 'def Capsule' in texts[1]


def _png_pixels(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    n = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    raw = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8)
    return w, h, raw.reshape(h, 1 + 3 * w)[:, 1:].reshape(h, w, 3)


def test_viewer_rtx_png_matches_jax(tmp_path):
    """tests/test_torch_camera.py's shapes scene at 48 x 32 (the JAX
    package's eager operations at the shapes that file's renders
    compiled): both write a 48 x 32 PNG, pixels within 1/255 of each other
    except where the checker texture's floor() is ill-conditioned (a hit
    within 1e-4 of a cell's edge: every ground pixel, whose p_z is
    rounding noise, ROADMAP C.46) or where the port's own image moves more
    when the camera's pose moves 4 ulps (at most 3 such)."""
    import newton_tpu as jt
    from newton_tpu.viewer import ViewerRTX as JR
    from test_torch_camera import shapes_scene as scene
    pix = []
    for k, (m, cls) in enumerate(((scene(jt).finalize(), JR),
                                  (scene(nt).finalize("cpu"),
                                   tviewer.ViewerRTX))):
        out = tmp_path / str(k)
        v = cls(out_dir=str(out), width=48, height=32)
        v.set_model(m)
        v.begin_frame(0.0)
        v.log_state(m.state())
        v.end_frame()
        w, h, p = _png_pixels(str(out / "frame_00000.png"))
        assert (w, h) == (48, 32)
        pix.append(p.astype(int))
    from test_torch_camera import checker_edges
    off = (np.abs(pix[1] - pix[0]) > 1).any(-1)
    edges = checker_edges(v._cam, v._cam.render(m.state(), v.cam_xform[None]),
                          v.cam_xform[None])[0]
    assert edges.sum() > 0.3 * edges.size
    unstable = np.zeros_like(off)
    base = v.cam_xform.copy()
    for axis in range(7):
        for toward in (np.inf, -np.inf):
            v.cam_xform = base.copy()
            for _ in range(4):
                v.cam_xform[axis] = np.nextafter(v.cam_xform[axis],
                                                 np.float32(toward))
            v.log_state(m.state())
            moved = _png_pixels(str(out / "frame_00000.png"))[2]
            unstable |= (np.abs(moved.astype(int) - pix[1]) > 1).any(-1)
    assert (unstable | edges | ~off).all() and (off & ~edges).sum() <= 3, \
        (int(off.sum()), int((off & ~unstable & ~edges).sum()))
    assert pix[1].max() > 12


def test_pick_equals_jax():
    """The port's pick equals the JAX package's on the zoo of
    tests/test_torch_raycast.py (every GeoType, bodies turned): the JAX
    ViewerBase.pick returns (int(s[0]), float(t[0])) of raycast_model on
    its one ray, which is that ray's row of the zoo's cast (each ray's
    answer is its own), so the zoo's one cast serves. The first ray on
    each hit class and the first miss are picked; a pick with no model
    gives (-1, inf) in both."""
    from newton_tpu.viewer import ViewerNull as JN
    import test_torch_raycast as tr
    _, _, tm, ts = tr.zoo_models()
    jt_, js_, _ = tr.zoo_jax_cast()
    o, d = tr._rays(*tr.ZOO_RAYS)
    v = tviewer.ViewerNull()
    assert v.pick(ts, o[0], d[0]) == JN().pick(None, o[0], d[0]) \
        == (-1, float("inf"))
    v.set_model(tm)
    types = np.asarray(tm.structure.shape_type)
    seen = set()
    for i in range(len(o)):
        kind = int(types[js_[i]]) if js_[i] >= 0 else -1
        if kind in seen:
            continue
        seen.add(kind)
        got = v.pick(ts, o[i], d[i])
        assert got[0] == int(js_[i]) and abs(got[1] - float(jt_[i])) <= \
            1e-5 * max(1.0, abs(float(jt_[i]))), (i, got, jt_[i], js_[i])
    assert len(seen) == 11


def test_gl_tessellation_equals_jax():
    """shape_geometry of every shape (primitives, the scaled mesh, the
    heightfield) equals the JAX package's arrays."""
    import newton_tpu as jt
    from newton_tpu.viewer.viewer_gl import shape_geometry as j_geo
    from newton_tpu_torch.viewer.viewer_gl import shape_geometry as t_geo
    jm, tm = shapes_scene(jt).finalize(), shapes_scene(nt).finalize("cpu")
    for s in range(tm.structure.shape_count):
        for a, b in zip(j_geo(jm, s), t_geo(tm, s)):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6,
                                       err_msg=f"shape {s}")
            assert a.dtype == b.dtype and a.shape == b.shape


def test_gl_camera_ray_instances_and_pick_spring_equal_jax():
    """OrbitCamera's view, projection and pixel ray, the grouped instance
    matrices (world filter included) and the pick spring's velocities
    equal the JAX package's (both springs start from the port's pick of
    the sphere; test_pick_equals_jax holds the picks themselves to the
    JAX package's)."""
    import newton_tpu as jt
    from newton_tpu.viewer import viewer_gl as jgl
    from newton_tpu_torch.viewer import viewer_gl as tgl
    jm, tm = shapes_scene(jt).finalize(), shapes_scene(nt).finalize("cpu")
    js, ts = _state_pair(jm, tm, 3)
    jc, tc = jgl.OrbitCamera(), tgl.OrbitCamera()
    for c in (jc, tc):
        c.target = np.asarray([0.2, 0.1, 1.0], np.float32)
        c.yaw, c.pitch, c.dist = 0.4, 0.3, 5.0
    np.testing.assert_array_equal(tc.view(), jc.view())
    np.testing.assert_array_equal(tc.proj(1.5), jc.proj(1.5))
    for a, b in zip(jc.ray(310, 200, 800, 600), tc.ray(310, 200, 800, 600)):
        np.testing.assert_array_equal(b, a)
    jv, tv = jgl.ViewerGL(offscreen=True), tgl.ViewerGL(offscreen=True)
    jv.set_model(jm)
    tv.set_model(tm)
    jv.log_state(js)
    tv.log_state(ts)
    assert len(jv._groups) == len(tv._groups)
    for jg, tg in zip(jv._groups, tv._groups):
        assert jg["shapes"] == tg["shapes"] and jg["color"] == tg["color"]
        np.testing.assert_allclose(tv.instance_matrices(tg),
                                   jv.instance_matrices(jg), atol=1e-6)
    origin, direction = np.asarray([0, 0, 5.0]), np.asarray([0, 0, -1.0])
    tp = tv.pick(ts, origin, direction)
    assert tp[0] == 0 and 3.0 < tp[1] < 4.0
    jv.start_pick(tp[0], origin, direction, tp[1])
    tv.start_pick(tp[0], origin, direction, tp[1])
    for v in (jv, tv):
        v._pick["target"] = np.asarray([1.0, 0, 1.5])
    jq = np.asarray(jv.apply_forces(js).body_qd)
    tq = tv.apply_forces(ts).body_qd.numpy()
    np.testing.assert_allclose(tq, jq, atol=1e-6)
    assert tq[0, 0] > 0.01


def test_gl_world_filter_equals_jax():
    """tests/test_viewer_gl.py's four replicated spheres: the world filter
    keeps one instance, as in the JAX package."""
    import newton_tpu as jt
    from newton_tpu.viewer import viewer_gl as jgl
    from newton_tpu_torch.viewer import viewer_gl as tgl

    def scene(lib):
        sub = lib.ModelBuilder()
        bb = sub.add_body(xform=[0, 0, 1.0, 0, 0, 0, 1])
        sub.add_shape_sphere(bb, radius=0.3)
        sub.add_joint_free(bb)
        b = lib.ModelBuilder()
        b.replicate(sub, 4)
        return b
    counts = []
    for lib, gl, dev in ((jt, jgl, None), (nt, tgl, "cpu")):
        m = scene(lib).finalize(*(() if dev is None else (dev,)))
        v = gl.ViewerGL(offscreen=True)
        v.set_model(m)
        v.log_state(m.state())
        g = v._groups[0]
        c = [len(v.instance_matrices(g))]
        v.world_filter = 2
        c.append(len(v.instance_matrices(g)))
        counts.append(c)
    assert counts[0] == counts[1] == [4, 1]


def test_gl_init_fails_loudly_headless():
    with pytest.raises(RuntimeError, match="display|GLFW"):
        tviewer.ViewerGL()


def test_gui_panel_and_layout_equal_jax():
    """GuiPanel's lines and layout_text's quads and backdrop, and the font
    atlas, equal the JAX package's."""
    from newton_tpu.viewer import viewer_gui as jgui
    from newton_tpu_torch.viewer import viewer_gui as tgui
    out = []
    for gui in (jgui, tgui):
        p = gui.GuiPanel()
        p.log_scalar("energy", 12.5)
        p.log_scalar("energy", 13.0)
        lines = p.compose(paused=True, frame=42, fps=60.0, world_filter=2,
                          world_count=8, picked_shape=3, sim_time=0.175)
        out.append((lines, *gui.layout_text(lines, gw=7, gh=13)))
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])
    assert out[1][2] == out[0][2]
    a, b = jgui._build_font_atlas(), tgui._build_font_atlas()
    np.testing.assert_array_equal(b[0], a[0])
    assert b[1:] == a[1:]


def test_viewer_plot_agg(tmp_path):
    """Frames and a logged image as PNG files under the Agg backend."""
    m = pendulum(nt).finalize("cpu")
    v = tviewer.ViewerPlot(out_dir=str(tmp_path), every=1)
    v.set_model(m)
    for i in range(2):
        v.begin_frame(i * 0.1)
        v.log_state(m.state())
        v.end_frame()
    v.log_image("cam/rgb", np.zeros((8, 8, 3)))
    names = sorted(os.listdir(tmp_path))
    assert names == ["cam_rgb_00001.png", "frame_00000.png",
                     "frame_00001.png"]


@pytest.mark.parametrize("name, package", [("ViewerRerun", "rerun-sdk"),
                                           ("ViewerViser", "viser")])
def test_optional_backends_raise_naming_their_package(name, package):
    import importlib.util
    if importlib.util.find_spec(package.split("-")[0]) is not None:
        pytest.skip(f"{package} is installed here")
    with pytest.raises(ImportError, match=package):
        getattr(tviewer, name)()


def test_viewer_package_lazy_names():
    """Every name of the package resolves (the optional backends load at
    first use); an unknown name raises."""
    for name in tviewer.__all__:
        assert getattr(tviewer, name).__name__ == name
    with pytest.raises(AttributeError):
        getattr(tviewer, "ViewerNothing")
