"""Axis-aligned bounding boxes, Bounds3 and Bounds2 (port of
trace_tpu/core/bounds.py).

A box is a pair of tensors ``p_min``/``p_max`` [..., 3] (or [..., 2]) on
any device, broadcasting over leading batch dims; ``empty3`` takes its
device explicitly. The slab tests keep the JAX package's NaN handling: a
ray whose origin lies on a slab plane with a parallel direction gives
(p - o) * inv_d = 0 * inf = NaN on that axis, and ``torch.minimum`` /
``maximum`` propagate it as ``jnp.minimum`` / ``maximum`` do, before the
axis is taken as overlapping everywhere (lo -inf, hi +inf).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

F32 = torch.float32
INF = float("inf")


class Bounds3(NamedTuple):
    p_min: torch.Tensor  # [..., 3]
    p_max: torch.Tensor  # [..., 3]


class Bounds2(NamedTuple):
    p_min: torch.Tensor  # [..., 2]
    p_max: torch.Tensor  # [..., 2]


def empty3(device="cuda") -> Bounds3:
    """Invalid (empty) bounds: p_min +inf, p_max -inf."""
    return Bounds3(torch.full((3,), INF, dtype=F32, device=device),
                   torch.full((3,), -INF, dtype=F32, device=device))


def from_point(p) -> Bounds3:
    return Bounds3(p, p)


def from_points(p1, p2) -> Bounds3:
    return Bounds3(torch.minimum(p1, p2), torch.maximum(p1, p2))


def union(b1, b2):
    return type(b1)(torch.minimum(b1.p_min, b2.p_min),
                    torch.maximum(b1.p_max, b2.p_max))


def union_point(b, p):
    return type(b)(torch.minimum(b.p_min, p), torch.maximum(b.p_max, p))


def intersect_bounds(b1, b2):
    return type(b1)(torch.maximum(b1.p_min, b2.p_min),
                    torch.minimum(b1.p_max, b2.p_max))


def is_valid(b) -> torch.Tensor:
    return (b.p_min != INF).all(-1) & (b.p_max != -INF).all(-1)


def inside(b, p) -> torch.Tensor:
    return (p >= b.p_min).all(-1) & (p <= b.p_max).all(-1)


def expand(b, delta) -> Bounds3:
    return Bounds3(b.p_min - delta, b.p_max + delta)


def diagonal(b) -> torch.Tensor:
    return b.p_max - b.p_min


def surface_area(b) -> torch.Tensor:
    d = diagonal(b)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                  + d[..., 1] * d[..., 2])


def volume(b) -> torch.Tensor:
    d = diagonal(b)
    return d[..., 0] * d[..., 1] * d[..., 2]


def maximum_extent(b) -> torch.Tensor:
    """Index of the longest axis (int64, 0-based); ties go to the later
    axis."""
    d = diagonal(b)
    two = torch.full_like(d[..., 0], 2, dtype=torch.int64)
    return torch.where((d[..., 0] > d[..., 1]) & (d[..., 0] > d[..., 2]),
                       torch.zeros_like(two),
                       torch.where(d[..., 1] > d[..., 2],
                                   torch.ones_like(two), two))


def offset(b, p) -> torch.Tensor:
    """Relative position of ``p`` within the box (an empty axis: p -
    p_min)."""
    extent = b.p_max - b.p_min
    return (p - b.p_min) / torch.where(extent > 0, extent, 1.0)


def lerp(b, t) -> torch.Tensor:
    return (1.0 - t) * b.p_min + t * b.p_max


def _length(v) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def bounding_sphere(b):
    """(center, radius); radius 0 where the center falls outside (an
    empty box)."""
    center = (b.p_min + b.p_max) / 2.0
    radius = torch.where(inside(b, center), _length(center - b.p_max), 0.0)
    return center, radius


def corner(b, c: int) -> torch.Tensor:
    """One of the 8 corners, c in [0, 8): bit k picks p_max on axis k."""
    return torch.stack([(b.p_max if c & (1 << k) else b.p_min)[..., k]
                        for k in range(3)], dim=-1)


def _slab_lo_hi(t_a, t_b):
    """Per-axis slab interval; a NaN axis (origin on the plane, direction
    parallel) overlaps everywhere."""
    lo = torch.minimum(t_a, t_b)
    hi = torch.maximum(t_a, t_b)
    return (torch.where(torch.isnan(lo), -INF, lo),
            torch.where(torch.isnan(hi), INF, hi))


def ray_intersect(b, o, d, t_max):
    """Slab test -> (hit, t0, t1)."""
    inv_d = torch.ones_like(d) / d
    lo, hi = _slab_lo_hi((b.p_min - o) * inv_d, (b.p_max - o) * inv_d)
    t0 = lo.amax(-1).clamp_min(0.0)
    t1 = torch.minimum(hi.amin(-1), torch.as_tensor(t_max, dtype=hi.dtype,
                                                    device=hi.device))
    return t0 <= t1, t0, t1


def ray_intersect_p(b, o, inv_d, t_max) -> torch.Tensor:
    """Slab predicate on precomputed reciprocals: min/max of the two slab
    distances per axis in place of the reference's sign selection."""
    lo, hi = _slab_lo_hi((b.p_min - o) * inv_d, (b.p_max - o) * inv_d)
    t0 = lo.amax(-1)
    t1 = hi.amin(-1)
    return (t0 <= t1) & (t0 < t_max) & (t1 > 0)
