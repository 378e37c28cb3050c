"""Host-side 4x4 transforms with cached inverses (port of
trace_tpu/core/transform.py).

Transforms are scene-build data: numpy float32 matrices on the host.
``apply_point``/``apply_vec``/``apply_normal``/``apply_bounds`` apply one
to tensors on any device, in written-out component arithmetic. The
predicates (``swaps_handedness``, ``has_scale``) and the quaternions
(``Quaternion``, ``slerp``) are host numpy float32, as the JAX twin
computes them on its host matrices.

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


def rotate(deg: float, axis) -> Transform:
    """Rotation by ``deg`` about an arbitrary ``axis`` (normalized here);
    the inverse is the transpose."""
    a = np.asarray(axis, np.float32)
    a = a / np.linalg.norm(a)
    s, c = np.sin(np.deg2rad(deg)), np.cos(np.deg2rad(deg))
    m3 = np.array([
        [a[0] * a[0] + (1 - a[0] * a[0]) * c,
         a[0] * a[1] * (1 - c) - a[2] * s,
         a[0] * a[2] * (1 - c) + a[1] * s],
        [a[0] * a[1] * (1 - c) + a[2] * s,
         a[1] * a[1] + (1 - a[1] * a[1]) * c,
         a[1] * a[2] * (1 - c) - a[0] * s],
        [a[0] * a[2] * (1 - c) - a[1] * s,
         a[1] * a[2] * (1 - c) + a[0] * s,
         a[2] * a[2] + (1 - a[2] * a[2]) * c]], np.float32)
    return _rot(m3)


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


def apply_normal(t: Transform, n: torch.Tensor) -> torch.Tensor:
    """Normals [..., 3] by the inverse transpose."""
    mi = [[float(x) for x in row] for row in np.asarray(t.inv_m, np.float32)]
    n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
    return torch.stack(
        [mi[0][i] * n0 + mi[1][i] * n1 + mi[2][i] * n2 for i in range(3)],
        dim=-1)


def apply_bounds(t: Transform, b):
    """The box around the eight transformed corners of ``b``
    (core.bounds.Bounds3)."""
    from . import bounds as B

    out = B.from_point(apply_point(t, B.corner(b, 0)))
    for c in range(1, 8):
        out = B.union_point(out, apply_point(t, B.corner(b, c)))
    return out


def swaps_handedness(t: Transform):
    """Whether the linear part has a negative determinant."""
    return np.linalg.det(np.asarray(t.m, np.float32)[..., :3, :3]) < 0


def has_scale(t: Transform):
    """Whether a unit axis changes its length by more than 1e-4."""
    m3 = np.asarray(t.m, np.float32)[..., :3, :3]
    out = False
    for k in range(3):
        col = m3[..., :, k]
        n = np.sqrt(col[..., 0] * col[..., 0] + col[..., 1] * col[..., 1]
                    + col[..., 2] * col[..., 2])
        out = out | (np.abs(n - np.float32(1)) > np.float32(1e-4))
    return out


# -- quaternions (host numpy float32) --------------------------------------


class Quaternion(NamedTuple):
    v: np.ndarray  # [..., 3] float32
    w: np.ndarray  # [...] float32


def _f32(x):
    return np.asarray(x, np.float32)


def quat_identity() -> Quaternion:
    return Quaternion(np.zeros(3, np.float32), _f32(1.0))


def quat_from_transform(t: Transform) -> Quaternion:
    """Matrix -> quaternion: the trace > 0 branch, else the branch of the
    largest diagonal element."""
    m = _f32(t.m)
    one, half, eps = np.float32(1), np.float32(0.5), np.float32(1e-12)
    tr = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    s_a = np.sqrt(np.maximum(tr + one, eps))
    w_a = s_a / np.float32(2)
    k_a = half / s_a
    v_a = np.stack([(m[..., 2, 1] - m[..., 1, 2]) * k_a,
                    (m[..., 0, 2] - m[..., 2, 0]) * k_a,
                    (m[..., 1, 0] - m[..., 0, 1]) * k_a], -1)

    def branch(i):
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(np.maximum(m[..., i, i] - (m[..., j, j] + m[..., k, k])
                               + one, eps))
        q = [None] * 3
        q[i] = s * half
        with np.errstate(divide="ignore"):
            ks = np.where(s != 0, half / s, np.float32(0))
        q[j] = (m[..., j, i] + m[..., i, j]) * ks
        q[k] = (m[..., k, i] + m[..., i, k]) * ks
        return np.stack(q, -1), (m[..., k, j] - m[..., j, k]) * ks

    i0 = np.where(m[..., 1, 1] > m[..., 0, 0],
                  np.where(m[..., 2, 2] > m[..., 1, 1], 2, 1),
                  np.where(m[..., 2, 2] > m[..., 0, 0], 2, 0))
    (vb0, wb0), (vb1, wb1), (vb2, wb2) = branch(0), branch(1), branch(2)
    v_b = np.where((i0 == 0)[..., None], vb0,
                   np.where((i0 == 1)[..., None], vb1, vb2))
    w_b = np.where(i0 == 0, wb0, np.where(i0 == 1, wb1, wb2))
    pos = tr > 0
    return Quaternion(_f32(np.where(pos[..., None], v_a, v_b)),
                      _f32(np.where(pos, w_a, w_b)))


def quat_to_transform(q: Quaternion) -> Transform:
    """The rotation of a unit quaternion; the inverse is the transpose."""
    v, w = _f32(q.v), _f32(q.w)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    one, two = np.float32(1), np.float32(2)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    zero = np.zeros_like(w)
    mat = np.stack([
        np.stack([one - two * (yy + zz), two * (xy - wz), two * (xz + wy),
                  zero], -1),
        np.stack([two * (xy + wz), one - two * (xx + zz), two * (yz - wx),
                  zero], -1),
        np.stack([two * (xz - wy), two * (yz + wx), one - two * (xx + yy),
                  zero], -1),
        np.stack([zero, zero, zero, np.ones_like(w)], -1)], -2)
    return Transform(mat, np.swapaxes(mat, -1, -2).copy())


def quat_dot(q1: Quaternion, q2: Quaternion):
    a, b = _f32(q1.v), _f32(q2.v)
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2]) + _f32(q1.w) * _f32(q2.w)


def quat_normalize(q: Quaternion) -> Quaternion:
    n = np.sqrt(quat_dot(q, q))
    return Quaternion(_f32(q.v) / n[..., None], _f32(q.w) / n)


def slerp(q1: Quaternion, q2: Quaternion, t):
    """Spherical interpolation; a plain normalized lerp where the two are
    nearly parallel (cos > 0.9995)."""
    t = _f32(t)
    v1, w1, v2, w2 = _f32(q1.v), _f32(q1.w), _f32(q2.v), _f32(q2.w)
    one = np.float32(1)
    cos_t = _f32(quat_dot(q1, q2))
    tv = t[..., None] if t.ndim else t
    lin = quat_normalize(Quaternion((one - tv) * v1 + tv * v2,
                                    (one - t) * w1 + t * w2))
    theta = np.arccos(np.clip(cos_t, -one, one))
    theta_p = theta * t
    perp = Quaternion(v2 - v1 * cos_t[..., None], w2 - w1 * cos_t)
    nperp = np.sqrt(np.maximum(quat_dot(perp, perp), np.float32(1e-12)))
    perp = Quaternion(perp.v / nperp[..., None], perp.w / nperp)
    c, s = np.cos(theta_p), np.sin(theta_p)
    sph = Quaternion(v1 * c[..., None] + perp.v * s[..., None],
                     w1 * c + perp.w * s)
    near = cos_t > np.float32(0.9995)
    return Quaternion(_f32(np.where(near[..., None], lin.v, sph.v)),
                      _f32(np.where(near, lin.w, sph.w)))
