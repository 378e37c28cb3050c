"""Reconstruction filters (port of trace_tpu/film/filters.py).

A filter is a small static object: ``radius`` an (x, y) pair of floats,
and its weight at offsets from the sample: ``filter(p)`` with ``p`` the
offsets stacked [..., 2], as the JAX package's filters take them, or
``filter(px, py)`` per axis (tensors of one shape). The film evaluates it
at the 16-entry table's quantized points, through :func:`weights`.
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


class Filter:
    """The filters' base class. A subclass gives ``radius`` and its weight
    in one of two forms: ``weight(px, py)`` per axis (the port's filters),
    or ``__call__(self, p)`` over offsets stacked [..., 2] (the JAX
    package's form); each form reaches the other."""

    radius: tuple

    def weight(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        return self(torch.stack([px, py], dim=-1))

    def __call__(self, p: torch.Tensor, py: torch.Tensor | None = None):
        if type(self).weight is Filter.weight:
            raise NotImplementedError(
                f"{type(self).__name__} defines neither weight(px, py) nor "
                f"__call__(p)")
        if py is None:
            return self.weight(p[..., 0], p[..., 1])
        return self.weight(p, py)


def weights(filt, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """``filt``'s weight at per-axis offsets: a :class:`Filter` through
    its ``weight``, any other object called as ``filt(px, py)``."""
    if isinstance(filt, Filter):
        return filt.weight(px, py)
    return filt(px, py)


class LanczosSincFilter(Filter):
    """Windowed-sinc product filter; ``radius`` is a static (x, y) pair."""

    def __init__(self, radius=(1.0, 1.0), tau=3.0):
        self.radius = _radius(radius)
        self.tau = float(tau)

    def _windowed(self, x: torch.Tensor, r: float) -> torch.Tensor:
        x = x.abs()
        return torch.where(x > r, 0.0, _sinc(x) * _sinc(x / self.tau))

    def weight(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        return (self._windowed(px, self.radius[0])
                * self._windowed(py, self.radius[1]))


class BoxFilter(Filter):
    def __init__(self, radius=(0.5, 0.5)):
        self.radius = _radius(radius)

    def weight(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(px)


class TriangleFilter(Filter):
    def __init__(self, radius=(2.0, 2.0)):
        self.radius = _radius(radius)

    def weight(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        return ((self.radius[0] - px.abs()).clamp_min(0.0)
                * (self.radius[1] - py.abs()).clamp_min(0.0))


class GaussianFilter(Filter):
    """exp(-alpha d^2) - exp(-alpha r^2), clamped at 0, per axis; the
    second term is a Python double, as in the JAX twin."""

    def __init__(self, radius=(2.0, 2.0), alpha=2.0):
        self.radius = _radius(radius)
        self.alpha = float(alpha)

    def _g(self, d: torch.Tensor, r: float) -> torch.Tensor:
        exp_r = math.exp(-self.alpha * r * r)
        return (torch.exp(-self.alpha * d * d) - exp_r).clamp_min(0.0)

    def weight(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        return self._g(px, self.radius[0]) * self._g(py, self.radius[1])
