"""Mass properties of the primitives the port builds (host numpy; port of
``newton_tpu/geometry/inertia.py``). Inertia tensors are about the shape's
center of mass, in the shape frame."""

from __future__ import annotations

import numpy as np

__all__ = ["compute_sphere_inertia", "compute_box_inertia",
           "compute_capsule_inertia", "compute_cylinder_inertia",
           "compute_cone_inertia", "compute_ellipsoid_inertia",
           "transform_inertia"]


def compute_sphere_inertia(density: float, r: float):
    """Solid sphere. Returns (mass, com, inertia 3x3)."""
    m = density * (4.0 / 3.0) * np.pi * r**3
    Ia = (2.0 / 5.0) * m * r * r
    return m, np.zeros(3), np.diag([Ia, Ia, Ia])


def compute_box_inertia(density: float, hx: float, hy: float, hz: float):
    """Solid box with half-extents (hx, hy, hz)."""
    lx, ly, lz = 2 * hx, 2 * hy, 2 * hz
    m = density * lx * ly * lz
    Ixx = m / 12.0 * (ly * ly + lz * lz)
    Iyy = m / 12.0 * (lx * lx + lz * lz)
    Izz = m / 12.0 * (lx * lx + ly * ly)
    return m, np.zeros(3), np.diag([Ixx, Iyy, Izz])


def compute_capsule_inertia(density: float, r: float, h: float):
    """Solid capsule: cylinder of half-height h along Z plus two
    hemispherical caps of radius r."""
    mc = density * np.pi * r * r * (2.0 * h)
    ms = density * (4.0 / 3.0) * np.pi * r**3
    m = mc + ms
    Izz_c = 0.5 * mc * r * r
    Ixx_c = mc * ((2 * h) ** 2 / 12.0 + r * r / 4.0)
    Izz_s = 0.4 * ms * r * r
    Ixx_s = 0.4 * ms * r * r + ms * (h * h + 3.0 * h * r / 4.0)
    Ixx = Ixx_c + Ixx_s
    Izz = Izz_c + Izz_s
    return m, np.zeros(3), np.diag([Ixx, Ixx, Izz])


def compute_cylinder_inertia(density: float, r: float, h: float):
    """Solid cylinder of half-height h along Z."""
    m = density * np.pi * r * r * (2.0 * h)
    Izz = 0.5 * m * r * r
    Ixx = m * ((2 * h) ** 2 / 12.0 + r * r / 4.0)
    return m, np.zeros(3), np.diag([Ixx, Ixx, Izz])


def compute_cone_inertia(density: float, r: float, h: float):
    """Solid cone of half-height h along Z, apex at +h, base at -h; its
    center of mass lies at -h/2 (a quarter of the height above the
    base)."""
    H = 2.0 * h
    m = density * np.pi * r * r * H / 3.0
    Izz = (3.0 / 10.0) * m * r * r
    Ixx = m * (3.0 / 20.0 * r * r + 3.0 / 80.0 * H * H)
    return m, np.array([0.0, 0.0, -h / 2.0]), np.diag([Ixx, Ixx, Izz])


def compute_ellipsoid_inertia(density: float, a: float, b: float,
                              c: float):
    """Solid ellipsoid with radii (a, b, c) along the shape axes."""
    m = density * (4.0 / 3.0) * np.pi * a * b * c
    return m, np.zeros(3), np.diag([m / 5.0 * (b * b + c * c),
                                    m / 5.0 * (a * a + c * c),
                                    m / 5.0 * (a * a + b * b)])


def transform_inertia(m: float, I: np.ndarray, p: np.ndarray,
                      q_xyzw: np.ndarray) -> np.ndarray:
    """Rotate inertia by quaternion q and shift it by p (parallel axis)."""
    x, y, z, w = q_xyzw
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    I_rot = R @ I @ R.T
    p = np.asarray(p, dtype=np.float64)
    return I_rot + m * ((p @ p) * np.eye(3) - np.outer(p, p))
