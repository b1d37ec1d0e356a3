"""Tiled ray-traced camera (port of
``newton_tpu/sensors/sensor_tiled_camera.py``).

Every camera's (H x W) pixel rays go through one ``raycast_model`` call
(``geometry/raycast.py``: the analytic shapes through kernel K1 on the
card, meshes through their BVHs, K2) and become the channels depth,
normal, shape index, Lambert-shaded color, albedo and hdr; with
``shadows`` a second ray cast toward the light darkens occluded hits, and
Gaussian splat clouds (``ModelBuilder.add_shape_gaussian``) are composited
front to back into the color, with a ``splat_alpha`` channel. As in the
JAX package, the camera has no world axis: every camera's rays meet every
world's shapes (ROADMAP C.43).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry.raycast import raycast_model, shape_world_transforms
from ..math import quat_rotate, quat_to_matrix

__all__ = ["SensorTiledCamera", "SPLAT_PAIR_BUDGET"]

# (ray, splat) pairs per chunk of the compositing
SPLAT_PAIR_BUDGET = 1 << 23


class SensorTiledCamera:
    """Batched pinhole cameras.

    Args:
        model: a finalized model (the sensor follows its device).
        width/height: image resolution.
        fov_y: vertical field of view (radians).
        light_dir: world-frame direction of the light.
        max_dist: farthest hit.
        shadows: a second ray cast toward the light per hit.
        checker_texture: a world-space checker modulates the albedo.

    ``render(state, cam_xforms)`` takes (n, 7) camera world transforms
    (the camera looks along its -Z, +Y up) and returns channels depth
    (n, H, W), normal (n, H, W, 3), shape_index (n, H, W) int32, color,
    albedo and hdr (n, H, W, 3), and splat_alpha (n, H, W) where the model
    has splats.
    """

    def __init__(self, model, width: int = 64, height: int = 64,
                 fov_y: float = 1.0, light_dir=(0.3, 0.2, -0.9),
                 max_dist: float = 100.0, shadows: bool = False,
                 checker_texture: bool = False,
                 light_intensity: float = 1.0, ambient: float = 0.15):
        self.model = model
        self.width, self.height = int(width), int(height)
        self.fov_y = float(fov_y)
        self.max_dist = float(max_dist)
        self.shadows = bool(shadows)
        self.checker_texture = bool(checker_texture)
        self.light_intensity = float(light_intensity)
        self.ambient = float(ambient)
        ld = np.asarray(light_dir, dtype=np.float64)
        self.light_dir = ld / np.linalg.norm(ld)
        dev = model.device

        # pixel ray directions in the camera frame (H W, 3), along -Z
        aspect = self.width / self.height
        tan_y = np.tan(0.5 * self.fov_y)
        ys = np.linspace(tan_y, -tan_y, self.height)
        xs = np.linspace(-tan_y * aspect, tan_y * aspect, self.width)
        gx, gy = np.meshgrid(xs, ys)
        dirs = np.stack([gx, gy, -np.ones_like(gx)], axis=-1)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        self._pixel_dirs = torch.as_tensor(
            dirs.reshape(-1, 3).astype(np.float32), device=dev)
        self._light = torch.as_tensor(self.light_dir, dtype=torch.float32,
                                      device=dev)
        self._palette = _shape_palette(model.structure.shape_count, dev)
        self._splats = _flatten_splats(model)

    def rays(self, cam_xforms):
        """The pixel rays of cameras (n, 7) or (7,): world origins and unit
        directions (n H W, 3), camera-major, rows top to bottom."""
        cam = torch.as_tensor(cam_xforms, dtype=torch.float32,
                              device=self.model.device)
        if cam.dim() == 1:
            cam = cam[None]
        d = quat_rotate(cam[:, None, 3:7], self._pixel_dirs[None])
        o = cam[:, None, 0:3].expand_as(d)
        return o.reshape(-1, 3), d.reshape(-1, 3)

    def render(self, state, cam_xforms) -> dict:
        o, d = self.rays(cam_xforms)
        H, W = self.height, self.width
        n = o.shape[0] // (H * W)
        return {k: v.reshape(n, H, W, *v.shape[1:])
                for k, v in self.render_rays(state, o, d).items()}

    def render_rays(self, state, o, d) -> dict:
        """The channels of ``render`` for rays o, d (R, 3), flat: depth
        (R,), normal (R, 3), shape_index (R,), color, albedo and hdr (R, 3),
        splat_alpha (R,) where the model has splats."""
        model = self.model
        shapes = {}         # world transforms and cull tables, made once
        t, shape, nrm = raycast_model(model, state, o, d,
                                      max_dist=self.max_dist, cache=shapes)
        hit = shape >= 0
        out = dict(depth=torch.where(hit, t, 0.0),
                   normal=torch.where(hit[:, None], nrm, 0.0),
                   shape_index=shape)
        base = torch.where(hit[:, None],
                           self._palette[torch.clamp(shape, min=0).long()],
                           0.0)
        p_hit = o + d * t[:, None]
        if self.checker_texture:
            ck = torch.floor(p_hit * 4.0).sum(-1) % 2.0
            base = base * (0.6 + 0.4 * ck)[:, None]
        lam = torch.clamp(-(nrm[:, 0] * self._light[0]
                            + nrm[:, 1] * self._light[1]
                            + nrm[:, 2] * self._light[2]), min=0.1)
        if self.shadows:
            so = p_hit + nrm * 1e-3
            _, s_shape, _ = raycast_model(model, state, so,
                                          (-self._light).expand_as(so),
                                          max_dist=self.max_dist,
                                          cache=shapes)
            lam = torch.where((s_shape < 0) | ~hit, lam, 0.0)
        hdr = base * (self.light_intensity * lam[:, None] + self.ambient)
        color = base * lam[:, None] if not self.shadows \
            else hdr / (1.0 + hdr)
        out.update(color=color, albedo=base, hdr=hdr)
        if self._splats is not None:
            out["color"], out["splat_alpha"] = self._composite_splats(
                state, o, d, torch.where(hit, t, self.max_dist), color)
        return out

    def _composite_splats(self, state, o, d, t_bg, bg_color):
        """Front-to-back alpha compositing of the Gaussians along each ray:
        each splat's peak density on the ray in closed form, splats behind
        the surface hit left out, depth order by a stable sort; chunked
        over rays."""
        sp = self._splats
        X_ws = shape_world_transforms(self.model, state)[sp["shape"]]
        mu = X_ws[:, 0:3] + quat_rotate(X_ws[:, 3:7], sp["mean"])
        W_ = quat_to_matrix(X_ws[:, 3:7]) @ sp["rot"]
        inv_cov = torch.einsum("gij,gj,gkj->gik", W_, sp["inv_s2"], W_)
        G = mu.shape[0]
        cs, als = [], []
        step = max(1, SPLAT_PAIR_BUDGET // G)
        for a0 in range(0, o.shape[0], step):
            oc, dc = o[a0:a0 + step], d[a0:a0 + step]
            do = oc[:, None, :] - mu[None]                     # (P, G, 3)
            Sd = torch.einsum("gij,pj->pgi", inv_cov, dc)
            a = torch.clamp(torch.einsum("pgi,pi->pg", Sd, dc), min=1e-9)
            Sdo = torch.einsum("gij,pgj->pgi", inv_cov, do)
            b = torch.einsum("pgi,pi->pg", Sdo, dc)
            t_star = -b / a
            q0 = torch.einsum("pgi,pgi->pg", do, Sdo)
            dens = torch.exp(-0.5 * torch.clamp(q0 - b * b / a, min=0.0))
            alpha = torch.clamp(sp["alpha"][None] * dens, 0.0, 0.99)
            valid = (t_star > 1e-3) & (t_star < t_bg[a0:a0 + step, None])
            alpha = torch.where(valid, alpha, 0.0)
            order = torch.argsort(torch.where(valid, t_star, self.max_dist),
                                  dim=1, stable=True)
            alpha_s = alpha.gather(1, order)
            trans = torch.cumprod(1.0 - alpha_s, dim=1)
            before = torch.cat([torch.ones_like(trans[:, :1]),
                                trans[:, :-1]], 1)
            w_ = alpha_s * before
            cs.append(torch.einsum("pg,pgc->pc", w_, sp["color"][order])
                      + trans[:, -1:] * bg_color[a0:a0 + step])
            als.append(1.0 - trans[:, -1])
        return torch.cat(cs, 0), torch.cat(als, 0)


def _flatten_splats(model):
    """Every GAUSSIAN shape's splats as per-splat tensors on the model's
    device (None without splats)."""
    st = model.structure
    sh, mean, rot, inv_s2, col, alp = [], [], [], [], [], []
    for s, src in getattr(st, "gaussians", []):
        means = np.asarray(src["means"], dtype=np.float64)
        if len(means) == 0:
            continue
        scales = np.maximum(np.asarray(src["scales"], dtype=np.float64),
                            1e-4)
        quats = np.asarray(src["quats"], dtype=np.float64)
        if quats.shape != means.shape[:1] + (4,):
            quats = np.tile([0.0, 0, 0, 1.0], (len(means), 1))
        colors = src.get("colors")
        colors = (np.full((len(means), 3), 0.9) if colors is None
                  else np.asarray(colors))
        ops = src.get("opacities")
        ops = np.full(len(means), 0.6) if ops is None else np.asarray(ops)
        x_, y_, z_, w_ = quats.T
        R_ = np.stack([
            np.stack([1 - 2 * (y_ * y_ + z_ * z_), 2 * (x_ * y_ - z_ * w_),
                      2 * (x_ * z_ + y_ * w_)], -1),
            np.stack([2 * (x_ * y_ + z_ * w_), 1 - 2 * (x_ * x_ + z_ * z_),
                      2 * (y_ * z_ - x_ * w_)], -1),
            np.stack([2 * (x_ * z_ - y_ * w_), 2 * (y_ * z_ + x_ * w_),
                      1 - 2 * (x_ * x_ + y_ * y_)], -1)], 1)
        sh += [s] * len(means)
        mean.append(means)
        rot.append(R_)
        inv_s2.append(1.0 / scales ** 2)
        col.append(np.asarray(colors, dtype=np.float64).reshape(-1, 3))
        alp.append(np.asarray(ops, dtype=np.float64).reshape(-1))
    if not sh:
        return None
    dev = model.device

    def f32(parts):
        return torch.as_tensor(np.concatenate(parts).astype(np.float32),
                               device=dev)
    return dict(shape=torch.as_tensor(sh, device=dev),
                mean=f32(mean), rot=f32(rot), inv_s2=f32(inv_s2),
                color=f32(col), alpha=f32(alp))


def _shape_palette(n_shapes: int, device) -> torch.Tensor:
    """Each shape's key color (S, 3)."""
    i = torch.arange(max(n_shapes, 1), dtype=torch.float32, device=device)
    return torch.stack([0.5 + 0.5 * torch.sin(0.9 * i + 0.0),
                        0.5 + 0.5 * torch.sin(0.9 * i + 2.1),
                        0.5 + 0.5 * torch.sin(0.9 * i + 4.2)], -1)
