"""Planar 3-vectors: three flat component tensors instead of [N, 3].

Port of trace_tpu/core/vec.py. A ``V3`` is a NamedTuple of three tensors
of one shape (typically flat [N]); every op is elementwise in float32,
in the same association order as the JAX twin so results agree to the
last bit wherever the elementwise kernels round alike.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32 = torch.float32
# The JAX package's np.float32 constants, carried as Python floats that
# hold the float32 value exactly (a float32 op casts them back losslessly).
PI = float(np.float32(3.1415926535897932))
INV_PI = float(np.float32(1.0 / 3.1415926535897932))
EPS = float(np.float32(1e-8))


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def of(arr: torch.Tensor) -> "V3":
        """[..., 3] -> V3."""
        return V3(arr[..., 0], arr[..., 1], arr[..., 2])

    @staticmethod
    def full(shape, x, y, z, device, dtype=F32) -> "V3":
        return V3(torch.full(shape, float(x), dtype=dtype, device=device),
                  torch.full(shape, float(y), dtype=dtype, device=device),
                  torch.full(shape, float(z), dtype=dtype, device=device))

    @staticmethod
    def zeros(shape, device, dtype=F32) -> "V3":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return V3(z, z, z)

    def arr(self) -> torch.Tensor:
        """V3 -> [..., 3]."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def dot(self, o: "V3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self) -> torch.Tensor:
        return self.x * self.x + self.y * self.y + self.z * self.z

    def length(self) -> torch.Tensor:
        return torch.sqrt(self.length_squared())

    def normalize(self) -> "V3":
        """Zero-guarded (n == 0 passes through)."""
        n = self.length()
        inv = 1.0 / torch.where(n == 0.0, 1.0, n)
        return self * inv

    def abs(self) -> "V3":
        return V3(self.x.abs(), self.y.abs(), self.z.abs())

    def max_component(self) -> torch.Tensor:
        return torch.maximum(torch.maximum(self.x, self.y), self.z)

    def is_black(self) -> torch.Tensor:
        return (self.x == 0.0) & (self.y == 0.0) & (self.z == 0.0)


def _parts(a):
    return (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)


def where(c, a, b) -> V3:
    """Componentwise select; ``a``/``b`` are V3 or scalars."""
    ax, ay, az = _parts(a)
    bx, by, bz = _parts(b)
    return V3(torch.where(c, ax, bx), torch.where(c, ay, by),
              torch.where(c, az, bz))


def maximum(a: V3, lo: float) -> V3:
    return V3(a.x.clamp_min(lo), a.y.clamp_min(lo), a.z.clamp_min(lo))


def face_forward(n: V3, v: V3) -> V3:
    return where(n.dot(v) < 0.0, -n, n)


def refract(wi: V3, n: V3, eta):
    """(valid, wt); zero where total internal reflection."""
    cos_ti = n.dot(wi)
    sin2_ti = (1.0 - cos_ti * cos_ti).clamp_min(0.0)
    sin2_tt = eta * eta * sin2_ti
    valid = sin2_tt < 1.0
    cos_tt = torch.sqrt((1.0 - sin2_tt).clamp_min(0.0))
    wt = wi * (-eta) + n * (eta * cos_ti - cos_tt)
    return valid, where(valid, wt, 0.0)


def coordinate_system(v1: V3):
    c = v1.x.abs() > v1.y.abs()
    inv_a = 1.0 / torch.sqrt(
        torch.where(c, v1.x * v1.x + v1.z * v1.z, v1.y * v1.y + v1.z * v1.z))
    zeros = torch.zeros_like(inv_a)
    v2 = where(c, V3(-v1.z * inv_a, zeros, v1.x * inv_a),
               V3(zeros, v1.z * inv_a, -v1.y * inv_a))
    return v1, v2, v1.cross(v2)


def mat3_apply(r, v: V3) -> V3:
    """``r`` is a nested 3x3 sequence of tensors or scalars (row-major)."""
    return V3(
        r[0][0] * v.x + r[0][1] * v.y + r[0][2] * v.z,
        r[1][0] * v.x + r[1][1] * v.y + r[1][2] * v.z,
        r[2][0] * v.x + r[2][1] * v.y + r[2][2] * v.z,
    )


def mat3_apply_t(r, v: V3) -> V3:
    """Transpose apply (normals' inverse-transpose rule)."""
    return V3(
        r[0][0] * v.x + r[1][0] * v.y + r[2][0] * v.z,
        r[0][1] * v.x + r[1][1] * v.y + r[2][1] * v.z,
        r[0][2] * v.x + r[1][2] * v.y + r[2][2] * v.z,
    )


def concentric_sample_disk(u1, u2):
    ox = 2.0 * u1 - 1.0
    oy = 2.0 * u2 - 1.0
    degenerate = (ox.abs() < EPS) & (oy.abs() < EPS)
    use_x = ox.abs() > oy.abs()
    safe_ox = torch.where(ox.abs() < EPS, 1.0, ox)
    safe_oy = torch.where(oy.abs() < EPS, 1.0, oy)
    r = torch.where(use_x, ox, oy)
    theta = torch.where(use_x, (oy / safe_ox) * (PI / 4.0),
                        PI / 2.0 - (ox / safe_oy) * (PI / 4.0))
    px = r * torch.cos(theta)
    py = r * torch.sin(theta)
    return (torch.where(degenerate, 0.0, px), torch.where(degenerate, 0.0, py))


def cosine_sample_hemisphere(u1, u2) -> V3:
    dx, dy = concentric_sample_disk(u1, u2)
    z = torch.sqrt((1.0 - dx * dx - dy * dy).clamp_min(0.0))
    return V3(dx, dy, z)


def uniform_sample_sphere(u1, u2) -> V3:
    z = 1.0 - 2.0 * u1
    r = torch.sqrt((1.0 - z * z).clamp_min(0.0))
    phi = 2.0 * PI * u2
    return V3(r * torch.cos(phi), r * torch.sin(phi), z)


def uniform_sample_cone(u1, u2, cos_t_max) -> V3:
    cos_t = 1.0 - u1 + u1 * cos_t_max
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
    phi = u2 * 2.0 * PI
    return V3(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t)


# Shading-frame trig on local-frame vectors (normal = +z).

def cos_theta(w: V3):
    return w.z


def sin2_theta(w: V3):
    return (1.0 - w.z * w.z).clamp_min(0.0)


def sin_theta(w: V3):
    return torch.sqrt(sin2_theta(w))


def cos_phi(w: V3):
    s = sin_theta(w)
    small = s < 1e-8
    return torch.where(small, 1.0,
                       (w.x / torch.where(small, 1.0, s)).clamp(-1.0, 1.0))


def sin_phi(w: V3):
    s = sin_theta(w)
    small = s < 1e-8
    return torch.where(small, 1.0,
                       (w.y / torch.where(small, 1.0, s)).clamp(-1.0, 1.0))


def same_hemisphere(w: V3, wp: V3):
    return w.z * wp.z > 0


def tree_gather(tree: dict, idx: torch.Tensor) -> dict:
    """Gather every [N] leaf of a dict by ``idx``."""
    return {k: v[idx] for k, v in tree.items()}
