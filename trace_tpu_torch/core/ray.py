"""Ray batches with one-pixel differentials (port of trace_tpu/core/ray.py)."""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

SPAWN_EPS = float(np.float32(1e-6))


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
