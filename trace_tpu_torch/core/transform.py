"""Host-side 4x4 transforms with cached inverses (port of
trace_tpu/core/transform.py).

Transforms are scene-build data: numpy float32 matrices on the host.
``apply_point``/``apply_vec`` apply one to a tensor of points on any
device, in written-out component arithmetic.

Reference quirks kept on purpose (PARITY.md, the verify skill's
"Gotchas"): ``compose_ref`` multiplies the cached inverses in the SAME
order as the forward matrices (the reference's wrong-order inverse), and
``perspective`` is the transposed projective-divide matrix. The ``pbrt``
camera convention uses ``compose`` and ``perspective_pbrt`` instead.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Transform(NamedTuple):
    m: np.ndarray      # [4, 4] float32
    inv_m: np.ndarray  # [4, 4] float32


def identity() -> Transform:
    i = np.eye(4, dtype=np.float32)
    return Transform(i, i)


def from_matrix(mat) -> Transform:
    mat = np.asarray(mat, np.float32)
    return Transform(mat, np.linalg.inv(mat).astype(np.float32))


def inverse(t: Transform) -> Transform:
    return Transform(t.inv_m, t.m)


def compose(t1: Transform, t2: Transform, *rest: Transform) -> Transform:
    """t1 * t2 * ... (the rightmost applies first), multiplied left to
    right."""
    out = Transform(t1.m @ t2.m, t2.inv_m @ t1.inv_m)
    for t in rest:
        out = Transform(out.m @ t.m, t.inv_m @ out.inv_m)
    return out


def compose_ref(t1: Transform, t2: Transform) -> Transform:
    """The reference's literal composition: the inverse slot multiplies
    in the same order as the forward one (not a true inverse unless the
    factors commute). The reference camera chain depends on it."""
    return Transform(
        np.asarray(t1.m @ t2.m, np.float32),
        np.asarray(t1.inv_m @ t2.inv_m, np.float32),
    )


def dir_to_z(d) -> Transform:
    """World-to-local frame that maps direction ``d`` onto +z (the spot
    light aiming frame of the reference scenes); rows from the
    coordinate_system branch, the inverse is the transpose."""
    d = np.asarray(d, np.float32)
    d = d / np.linalg.norm(d)
    if abs(d[0]) > abs(d[1]):
        du = np.array([-d[2], 0.0, d[0]], np.float32)
        du /= np.sqrt(d[0] * d[0] + d[2] * d[2])
    else:
        du = np.array([0.0, d[2], -d[1]], np.float32)
        du /= np.sqrt(d[1] * d[1] + d[2] * d[2])
    dv = np.cross(d, du)
    mat = np.eye(4, dtype=np.float32)
    mat[0, :3] = du
    mat[1, :3] = dv
    mat[2, :3] = d
    return Transform(mat, mat.T.copy())


def translate(delta) -> Transform:
    d = np.asarray(delta, np.float32)
    mat = np.eye(4, dtype=np.float32)
    mat[:3, 3] = d
    inv = np.eye(4, dtype=np.float32)
    inv[:3, 3] = -d
    return Transform(mat, inv)


def scale(x, y, z) -> Transform:
    mat = np.diag(np.array([x, y, z, 1.0], np.float32))
    inv = np.diag(np.array([1.0 / x, 1.0 / y, 1.0 / z, 1.0], np.float32))
    return Transform(mat, inv)


def _rot(mat3: np.ndarray) -> Transform:
    mat = np.eye(4, dtype=np.float32)
    mat[:3, :3] = mat3
    return Transform(mat, mat.T.copy())


def rotate_x(deg: float) -> Transform:
    """Rotation about +x; the inverse is the transpose."""
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    return _rot(np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32))


def rotate_y(deg: float) -> Transform:
    """Rotation about +y; the inverse is the transpose."""
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    return _rot(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32))


def rotate_z(deg: float) -> Transform:
    """Rotation about +z; the inverse is the transpose."""
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    return _rot(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32))


def look_at(position, target, up) -> Transform:
    """Camera-to-world transform (z axis = position - target)."""
    position = np.asarray(position, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    z_axis = position - target
    z_axis = z_axis / np.linalg.norm(z_axis)
    x_axis = np.cross(up, z_axis)
    x_axis = x_axis / np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    rot = np.eye(4, dtype=np.float32)
    rot[:3, 0] = x_axis
    rot[:3, 1] = y_axis
    rot[:3, 2] = z_axis
    return compose(translate(position), Transform(rot, rot.T.copy()))


def perspective(fov: float, near: float, far: float) -> Transform:
    """The reference's projection: the transpose of the matrix its source
    reads as (column-major constructor), i.e. a telephoto view with rays
    toward -z."""
    a = far / (far - near)
    b = -far * near / (far - near)
    p = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, a, 1], [0, 0, b, 0]],
        np.float32,
    )
    inv_tan = 1.0 / np.tan(np.deg2rad(fov) / 2.0)
    return compose(scale(inv_tan, inv_tan, 1.0), from_matrix(p))


def perspective_pbrt(fov: float, near: float, far: float) -> Transform:
    """The standard PBRT projection (rays toward +z): ``perspective``
    without the transposition, for the ``pbrt`` camera convention."""
    a = far / (far - near)
    b = -far * near / (far - near)
    p = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, a, b], [0, 0, 1, 0]],
        np.float32,
    )
    inv_tan = 1.0 / np.tan(np.deg2rad(fov) / 2.0)
    return compose(scale(inv_tan, inv_tan, 1.0), from_matrix(p))


def apply_point(t: Transform, p: torch.Tensor) -> torch.Tensor:
    """Points [..., 3] with the projective divide where w != 1."""
    mm = [[float(v) for v in row] for row in np.asarray(t.m, np.float32)]
    p0, p1, p2 = p[..., 0], p[..., 1], p[..., 2]
    r = [mm[i][0] * p0 + mm[i][1] * p1 + mm[i][2] * p2 + mm[i][3]
         for i in range(3)]
    w = mm[3][0] * p0 + mm[3][1] * p1 + mm[3][2] * p2 + mm[3][3]
    affine = w == 1.0
    return torch.stack([torch.where(affine, ri, ri / w) for ri in r], dim=-1)


def apply_vec(t: Transform, v: torch.Tensor) -> torch.Tensor:
    mm = [[float(x) for x in row] for row in np.asarray(t.m, np.float32)]
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [mm[i][0] * v0 + mm[i][1] * v1 + mm[i][2] * v2 for i in range(3)],
        dim=-1)
