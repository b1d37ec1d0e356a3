"""Parity of the port's tiled camera with the JAX package's: every
channel (depth, normal, shape index, color, albedo, hdr) at 48 x 32 with
and without shadows and the checker texture (whose z term on the ground
reads rounding noise, ROADMAP C.46), the Gaussian splat channel,
the two golden images at tests/test_sensors.py's gates, the splat shapes
of ``add_shape_gaussian`` through finalize and the bridge, and the slice's
main path at a small size (the ant x 4 filmed by its track cameras)."""

import os
import sys

import numpy as np
import pytest
import torch

import newton_tpu_torch as nt
from newton_tpu_torch.sensors import SensorTiledCamera

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke as cs  # noqa: E402  (the scenes and the main loop)

torch.set_num_threads(1)
T_TOL, N_TOL, C_TOL = 1e-5, 1e-4, 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden_data")
CAM = np.asarray([0.0, -2.5, 1.5, 0.46, 0.0, 0.0, 0.888], np.float32)


def shapes_scene(lib):
    """A sphere, a flat box hovering over the ground and a capsule, each
    body turned a little (the shadow scene of tests/test_sensors.py with
    two more shapes)."""
    rng = np.random.RandomState(2)
    b = lib.ModelBuilder()
    for kind, x, z in (("sphere", -0.8, 0.4), ("box", 0.0, 0.6),
                       ("capsule", 0.8, 0.35)):
        q = np.r_[0.2 * rng.randn(3), 1.0]
        body = b.add_body(xform=[x, 0.3, z, *(q / np.linalg.norm(q))])
        if kind == "sphere":
            b.add_shape_sphere(body, radius=0.3)
        elif kind == "box":
            b.add_shape_box(body, hx=0.3, hy=0.3, hz=0.05)
        else:
            b.add_shape_capsule(body, radius=0.15, half_height=0.25)
        b.add_joint_free(body)
    b.add_ground_plane()
    return b


def splat_scene(lib):
    """tests/test_sensors.py:150-196's sphere and two splats, and a site on
    the sphere, which no ray hits: four shapes, as in ``shapes_scene``, so
    that the JAX package's eager operations meet the shapes that scene's
    renders compiled."""
    b = lib.ModelBuilder()
    body = b.add_body(xform=[0, 0, 0.5, 0, 0, 0, 1])
    b.add_shape_sphere(body, radius=0.2)
    b.add_joint_free(body)
    b.add_shape_gaussian(-1, means=[[0.6, 0, 0.5], [0.8, 0.1, 0.6]],
                         scales=[[0.1, 0.1, 0.1], [0.08, 0.15, 0.05]],
                         quats=[[0, 0, 0, 1], [0, 0, 0, 1]],
                         colors=[[1, 0, 0], [0, 1, 0]],
                         opacities=[0.8, 0.7])
    b.add_site(body, key="site")
    b.add_ground_plane()
    return b


def _off(a, b, k):
    """Per pixel: channel k of b differs from a beyond its tolerance."""
    if k == "shape_index":
        return a != b
    if k == "depth":
        return np.abs(b - a) > T_TOL * np.maximum(1.0, a)
    d = np.abs(b - a)
    d = d.max(-1) if d.ndim == 4 else d
    return d > (N_TOL if k == "normal" else C_TOL)


def checker_edges(sensor, out, cams):
    """Pixels whose hit point lies within 1e-4 of a checker cell's edge
    (a coordinate of 4 p within 1e-4 of an integer): the texture's floor()
    takes either side there, as on the z = 0 ground, where p_z is rounding
    noise (ROADMAP C.46)."""
    o, d = sensor.rays(cams)
    p = 4.0 * (o + d * out["depth"].reshape(-1, 1)).double()
    edge = ((p - p.round()).abs() < 1e-4).any(-1)
    return (edge & (out["shape_index"].reshape(-1) >= 0)).reshape(
        out["depth"].shape).numpy()


def _channels_match(jout, tout, label, render, cam, body_q, edges=None):
    """Every channel of two renders: the shape index equal, depth within
    1e-5 max(1, depth), normals within 1e-4, colors within 1e-5, except
    at ill-conditioned pixels (grazing hits, shapes that meet, where the
    two packages' last-bit differences in the rays' local frames are
    amplified): pixels that the port itself moves beyond the tolerance
    when one component of the cameras' poses, or of every body's pose,
    moves ``NUDGE_ULPS`` ulps either way (``render(cams, body_q, pixels)``
    renders the port's flat pixels ``pixels``), and the checker's
    ``edges``. Returns the count of such pixels."""
    assert set(jout) == set(tout), label
    off = np.zeros(tout["depth"].shape, bool)
    for k in jout:
        a, b = np.asarray(jout[k]), tout[k].numpy()
        assert a.shape == b.shape, (label, k)
        off |= _off(a, b, k)
    if off.any():
        unstable = np.zeros_like(off) if edges is None else edges.copy()
        pixels = np.flatnonzero(off)
        moved_off = np.zeros(len(pixels), bool)
        for axis in range(7):
            for toward in (np.inf, -np.inf):
                for moved in (render(_nudged(cam, axis, toward), body_q,
                                     pixels),
                              render(cam, _nudged(body_q, axis, toward),
                                     pixels)):
                    for k in tout:
                        mine = tout[k].numpy().reshape(
                            off.size, -1)[pixels].reshape(
                                moved[k].shape)
                        m = _off(mine, moved[k].numpy(), k)
                        moved_off |= m.reshape(len(pixels), -1).any(-1)
        unstable.reshape(-1)[pixels] |= moved_off
        assert (unstable | ~off).all(), \
            f"{label}: {int((off & ~unstable).sum())} stable pixels differ"
    return int(off.sum())


NUDGE_ULPS = 4


def _nudged(x, axis, toward):
    """Poses (..., 7) with component ``axis`` (position 0-2, quaternion
    3-6) moved NUDGE_ULPS ulps toward ``toward``."""
    x = np.array(x, np.float32)
    for _ in range(NUDGE_ULPS):
        x[..., axis] = np.nextafter(x[..., axis], np.float32(toward))
    return x


def _port_render(cam_sensor, state):
    """render(cams, body_q, pixels): the flat channels of ``cam_sensor``'s
    pixels ``pixels`` (indices into every camera's pixels in order) on
    ``state``'s other fields."""
    import dataclasses

    def render(cams, body_q, pixels):
        s = dataclasses.replace(state, body_q=torch.as_tensor(body_q))
        o, d = cam_sensor.rays(cams)
        sel = torch.as_tensor(pixels)
        return cam_sensor.render_rays(s, o[sel], d[sel])
    return render


def test_every_channel_matches_jax():
    """The shapes scene at 48 x 32: plain, with shadows (light from above:
    the box's shadow darkens the ground) and with the checker texture."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sensors.sensor_tiled_camera import SensorTiledCamera as JC
    jm, tm = shapes_scene(jt).finalize(), shapes_scene(nt).finalize("cpu")
    js, ts = jm.state(), tm.state()
    ts.body_q = torch.as_tensor(np.array(js.body_q))
    outs = {}
    for label, kw in (("plain", {}), ("shadows", dict(shadows=True)),
                      ("checker", dict(checker_texture=True))):
        kw.update(width=48, height=32, light_dir=(0.0, 0.1, -1.0))
        jo = JC(jm, **kw).render(js, jnp.asarray(CAM[None]))
        cam = SensorTiledCamera(tm, **kw)
        to = cam.render(ts, CAM[None])
        edges = checker_edges(cam, to, CAM[None]) \
            if kw.get("checker_texture") else None
        n_off = _channels_match(jo, to, label, _port_render(cam, ts),
                                CAM[None], ts.body_q.numpy(), edges)
        assert n_off <= (8 if edges is None else 8 + edges.sum()), \
            (label, n_off)
        outs[label] = to
    hit = outs["plain"]["shape_index"] >= 0
    assert hit.float().mean() > 0.5
    assert float(outs["shadows"]["hdr"].mean()) < \
        float(outs["plain"]["hdr"].mean()) - 1e-4
    assert not torch.equal(outs["checker"]["albedo"], outs["plain"]["albedo"])


def test_splat_channel_matches_jax():
    """The splat scene from y = -2.2 looking along +y: color and
    splat_alpha equal the JAX package's, and tests/test_sensors.py's
    gates hold (splats seen, the background untouched, the red splat
    red)."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sensors.sensor_tiled_camera import SensorTiledCamera as JC
    jm, tm = splat_scene(jt).finalize(), splat_scene(nt).finalize("cpu")
    q = [np.sin(np.pi / 4), 0, 0, np.cos(np.pi / 4)]
    cam = np.asarray([[0.3, -2.2, 0.5] + q], np.float32)
    jo = JC(jm, width=48, height=32).render(jm.state(), jnp.asarray(cam))
    tc = SensorTiledCamera(tm, width=48, height=32)
    to = tc.render(tm.state(), cam)
    assert _channels_match(jo, to, "splats", _port_render(tc, tm.state()),
                           cam, tm.body_q.numpy()) <= 8
    sa, col = to["splat_alpha"][0].numpy(), to["color"][0].numpy()
    assert sa.max() > 0.3 and sa.min() == 0.0
    py, px = np.unravel_index(sa.argmax(), sa.shape)
    assert col[py, px, 0] > col[py, px, 2]


@pytest.mark.parametrize("which", ["sphere_box", "mesh"])
def test_golden_images(which):
    """The port renders the stored golden images within
    tests/test_sensors.py's gates (chip_smoke.golden_render, on the
    CPU)."""
    g = cs.golden_render(torch.device("cpu"), which, GOLDEN)
    assert g["shape_match"] > 0.98 and g["depth_err_median"] < 5e-3


def test_gaussian_shapes_finalize_and_bridge():
    """add_shape_gaussian and finalize's gaussians list equal the JAX
    package's; the bridge carries a JAX model's splat sources across."""
    import newton_tpu as jt
    from newton_tpu_torch.utils import bridge
    jm, tm = splat_scene(jt).finalize(), splat_scene(nt).finalize("cpu")
    jg, tg = jm.structure.gaussians, tm.structure.gaussians
    assert [s for s, _ in jg] == [s for s, _ in tg] == [1]
    for (_, a), (_, b) in zip(jg, tg):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert int(tm.structure.shape_type[1]) == int(nt.GeoType.GAUSSIAN)
    assert not tm.structure.shape_flags[1] & int(nt.ShapeFlags.COLLIDE_SHAPES)
    leaves, st = bridge.model_to_numpy(tm)
    st["gaussians"] = jm.structure.gaussians
    back = bridge.model_from_numpy(leaves, st, "cpu")
    assert back.structure.gaussians[0][0] == 1
    np.testing.assert_array_equal(back.structure.gaussians[0][1]["means"],
                                  np.asarray(jg[0][1]["means"]))
    ref = SensorTiledCamera(tm, width=16, height=12).render(
        tm.state(), CAM[None])
    got = SensorTiledCamera(back, width=16, height=12).render(
        back.state(), CAM[None])
    assert torch.equal(ref["color"], got["color"])


def test_main_path_small():
    """The slice's main path at 4 worlds on the CPU: 2 frames of the ant
    filmed by its track cameras (chip_smoke.CameraAnt: 4 substeps and one
    render a frame); the torso gate holds, and the JAX package's camera on
    the same poses gives the same channels."""
    import jax.numpy as jnp
    import newton_tpu as jt
    from newton_tpu.sensors.sensor_tiled_camera import SensorTiledCamera as JC
    n = 4
    tm = cs.camera_ant_scene(nt, n).finalize("cpu")
    loop = cs.CameraAnt(nt, tm, n, torch.device("cpu"))
    state = loop.start()
    for _ in range(2):
        state, out = loop.frame(state)
    g = cs.torso_gate(loop, state, out, "camera ant x 4")
    assert g["seen_share"] == 1.0
    jm = cs.camera_ant_scene(jt, n).finalize()
    js = jm.state().replace(body_q=jnp.asarray(state.body_q.numpy()))
    poses = loop.poses(state).numpy()
    jo = JC(jm, width=cs.CAM_RES, height=cs.CAM_RES,
            fov_y=cs.CAM_FOV).render(js, jnp.asarray(poses))
    n_off = _channels_match(jo, out, "main path",
                            _port_render(loop.cam, state), poses,
                            state.body_q.numpy())
    assert n_off <= 0.02 * out["depth"].numel(), n_off
