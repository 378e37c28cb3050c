"""Camera rays of the scene description's perspective camera under the
reference renderer's conventions (Trace.jl): the transposed projection,
``look_at`` with its z axis pointing from the target to the eye, and the
raster chain whose inverse slot multiplies in the forward order."""
from __future__ import annotations

import numpy as np

F64 = np.float64


def _translate(v):
    m = np.eye(4, dtype=F64)
    m[:3, 3] = v
    return m


def _scale(x, y, z):
    return np.diag(np.array([x, y, z, 1.0], F64))


def camera_to_world(position, target, up) -> np.ndarray:
    p, t, u = (np.asarray(v, np.float32).astype(F64)
               for v in (position, target, up))
    z = p - t
    z = z / np.linalg.norm(z)
    x = np.cross(u, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    rot = np.eye(4, dtype=F64)
    rot[:3, 0], rot[:3, 1], rot[:3, 2] = x, y, z
    return _translate(p) @ rot


def raster_to_camera(fov, near, far, screen_window, resolution) -> np.ndarray:
    """The matrix the reference applies (with the projective divide) to a
    raster point (x, y, 0): the inverse projection after the raster chain's
    literal inverse slot."""
    a = far / (far - near)
    b = -far * near / (far - near)
    proj = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, a, 1], [0, 0, b, 0]],
                    F64)
    inv_tan = 1.0 / np.tan(np.deg2rad(fov) / 2.0)
    inv_proj = np.linalg.inv(proj) @ _scale(1.0 / inv_tan, 1.0 / inv_tan, 1.0)
    (sx0, sy0), (sx1, sy1) = screen_window
    rx, ry = resolution
    # screen_to_raster's inverse slot: (S(rx, ry) S(1/w, 1/h))^-1-slot times
    # T(-sx0, -sy1)'s, multiplied in the forward order.
    s2r_inv = (_scale(1.0 / rx, 1.0 / ry, 1.0)
               @ _scale(sx1 - sx0, sy1 - sy0, 1.0)
               @ _translate([sx0, sy1, 0.0]))
    return inv_proj @ s2r_inv


def _apply_point(m, p):
    r = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return np.where((w == 1.0)[:, None], r, r / w[:, None])


def generate_rays(cam: dict, resolution, p_film):
    """World-space (origin, unit direction) [N, 3] float64 of film points
    ``p_film`` [N, 2] (1-based continuous raster coordinates); a pinhole."""
    r2c = raster_to_camera(cam["fov"], 1e-2, 1000.0, cam["screen_window"],
                           resolution)
    c2w = camera_to_world(cam["position"], cam["target"], cam["up"])
    pf = np.asarray(p_film, F64)
    p_cam = _apply_point(r2c, np.concatenate(
        [pf, np.zeros((pf.shape[0], 1))], axis=1))
    d_cam = p_cam / np.linalg.norm(p_cam, axis=1, keepdims=True)
    o = np.broadcast_to(c2w[:3, 3], d_cam.shape).copy()
    d = d_cam @ c2w[:3, :3].T
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)
