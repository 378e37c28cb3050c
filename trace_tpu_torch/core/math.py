"""Packed [..., 3] vector helpers (port of trace_tpu/core/math.py, the
part the camera and film need). Component arithmetic is written out, as
in the JAX twin, so no 3-vector op goes through a matrix product."""
from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Zero-guarded: a zero vector passes through unchanged."""
    n = length(a)
    return a / torch.where(n == 0.0, 1.0, n)[..., None]


def lerp(a, b, t):
    return (1.0 - t) * a + t * b

