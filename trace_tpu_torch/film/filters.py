"""Reconstruction filters (port of trace_tpu/film/filters.py).

A filter is a small static object: ``radius`` an (x, y) pair of floats and
``filter(px, py)`` its weight at per-axis offsets (tensors of one shape).
The film evaluates it at the 16-entry table's quantized points.
"""
from __future__ import annotations

import math

import torch

PI = 3.1415926535897932


def _sinc(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    xp = x * PI
    small = x < 1e-5
    return torch.where(small, 1.0, torch.sin(xp) / torch.where(small, 1.0, xp))


def _radius(radius) -> tuple:
    if isinstance(radius, (int, float)):
        radius = (radius, radius)
    return (float(radius[0]), float(radius[1]))


class LanczosSincFilter:
    """Windowed-sinc product filter; ``radius`` is a static (x, y) pair."""

    def __init__(self, radius=(1.0, 1.0), tau=3.0):
        self.radius = _radius(radius)
        self.tau = float(tau)

    def _windowed(self, x: torch.Tensor, r: float) -> torch.Tensor:
        x = x.abs()
        return torch.where(x > r, 0.0, _sinc(x) * _sinc(x / self.tau))

    def __call__(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        return (self._windowed(px, self.radius[0])
                * self._windowed(py, self.radius[1]))


class BoxFilter:
    def __init__(self, radius=(0.5, 0.5)):
        self.radius = _radius(radius)

    def __call__(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(px)


class TriangleFilter:
    def __init__(self, radius=(2.0, 2.0)):
        self.radius = _radius(radius)

    def __call__(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        return ((self.radius[0] - px.abs()).clamp_min(0.0)
                * (self.radius[1] - py.abs()).clamp_min(0.0))


class GaussianFilter:
    """exp(-alpha d^2) - exp(-alpha r^2), clamped at 0, per axis; the
    second term is a Python double, as in the JAX twin."""

    def __init__(self, radius=(2.0, 2.0), alpha=2.0):
        self.radius = _radius(radius)
        self.alpha = float(alpha)

    def _g(self, d: torch.Tensor, r: float) -> torch.Tensor:
        exp_r = math.exp(-self.alpha * r * r)
        return (torch.exp(-self.alpha * d * d) - exp_r).clamp_min(0.0)

    def __call__(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        return self._g(px, self.radius[0]) * self._g(py, self.radius[1])
