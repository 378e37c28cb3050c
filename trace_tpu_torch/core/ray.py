"""Ray batches with one-pixel differentials (port of trace_tpu/core/ray.py)."""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

SPAWN_EPS = float(np.float32(1e-6))
# A continuation leaves its surface along the geometric normal by this
# share of max|p| (clamped below at 1). The sweep tests a plane in absolute
# coordinates, o . n - n . v0, and its certified bound on that rounding is
# 8 u (|o| . |n| + |n . v0|) with u = 2^-24 (accel/mxu.py, MT_ERR_EPS): at
# most ~28 u max|p| as a distance. 2^-18 = 64 u clears it twice over, and
# at the heightfield's |p| <= 15 it is under 6e-5, far inside any gather
# radius (pbrt's OffsetRayOrigin, sized for this test).
SPAWN_OFFSET = float(np.float32(2.0 ** -18))


def spawn_offset(p) -> torch.Tensor:
    """The spawn offset [N] at points ``p`` (a planar V3)."""
    return SPAWN_OFFSET * p.abs().max_component().clamp_min(1.0)


def spawn(p, n_geom, wi):
    """Origin of the ray that leaves the surface point ``p`` along ``wi``:
    ``p`` moved along the unit geometric normal ``n_geom`` to ``wi``'s side
    by :func:`spawn_offset`, so that the ray cannot meet the surface it
    left (a refraction starts on the far side). Planar V3s."""
    side = torch.where(n_geom.dot(wi) < 0.0, -1.0, 1.0)
    return p + n_geom * (spawn_offset(p) * side)


def self_hits(live, prim_id, t, left_id, o) -> torch.Tensor:
    """Of the continuations ``live``, those whose closest hit lies on the
    primitive ``left_id`` they left, at most :func:`spawn_offset` from
    their origin ``o`` (unit directions): a device int64 scalar."""
    return (live & (prim_id == left_id) & (t <= spawn_offset(o))).sum()


@dataclass
class RayDifferentials:
    """Primary rays [N, 3] plus one-pixel-shifted x/y rays."""
    o: torch.Tensor
    d: torch.Tensor
    t_max: torch.Tensor
    time: torch.Tensor
    has_differentials: torch.Tensor  # bool [N]
    rx_origin: torch.Tensor
    ry_origin: torch.Tensor
    rx_direction: torch.Tensor
    ry_direction: torch.Tensor


def scale_differentials(rd: RayDifferentials, s: float) -> RayDifferentials:
    """Narrow the differential rays for spp > 1. Like the JAX twin this
    scales both directions (the reference writes rx_direction twice)."""
    return replace(
        rd,
        rx_origin=rd.o + (rd.rx_origin - rd.o) * s,
        ry_origin=rd.o + (rd.ry_origin - rd.o) * s,
        rx_direction=rd.d + (rd.rx_direction - rd.d) * s,
        ry_direction=rd.d + (rd.ry_direction - rd.d) * s,
    )
