"""Reconstruction filters (port of trace_tpu/film/filters.py; the slice
needs the Lanczos windowed sinc)."""
from __future__ import annotations

import torch

PI = 3.1415926535897932


def _sinc(x: torch.Tensor) -> torch.Tensor:
    x = x.abs()
    xp = x * PI
    small = x < 1e-5
    return torch.where(small, 1.0, torch.sin(xp) / torch.where(small, 1.0, xp))


class LanczosSincFilter:
    """Windowed-sinc product filter; ``radius`` is a static (x, y) pair."""

    def __init__(self, radius=(1.0, 1.0), tau=3.0):
        if isinstance(radius, (int, float)):
            radius = (float(radius), float(radius))
        self.radius = (float(radius[0]), float(radius[1]))
        self.tau = float(tau)

    def _windowed(self, x: torch.Tensor, r: float) -> torch.Tensor:
        x = x.abs()
        return torch.where(x > r, 0.0, _sinc(x) * _sinc(x / self.tau))

    def __call__(self, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
        return (self._windowed(px, self.radius[0])
                * self._windowed(py, self.radius[1]))
