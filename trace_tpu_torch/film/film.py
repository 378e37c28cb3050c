"""Film: deterministic stencil splatting (port of trace_tpu/film/film.py).

Reference conventions kept as in the JAX twin: 1-based continuous film
coordinates, filter weights at the 16-entry table's quantized points with
ceil() offsets in x and floor() in y, the one-pixel-wider footprint, and
the vertical flip on save. The slice splats with ``add_samples_grid``: when
the lanes are the complete sample-bounds grid, each filter-footprint offset
is one shifted slice-add, so accumulation is deterministic (no scatter).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import spectrum as spec
from .filters import LanczosSincFilter

F32 = torch.float32
FILTER_TABLE_WIDTH = 16


class FilmState(NamedTuple):
    xyz: torch.Tensor          # [H, W, 3]
    weight_sum: torch.Tensor   # [H, W]


class Film:
    """Static film configuration: the whole raster (no crop window, no
    splats, scale 1 -- not ported yet)."""

    def __init__(self, resolution, filter=None, filename: str = "out.png"):
        self.resolution = (int(resolution[0]), int(resolution[1]))
        self.filter = filter or LanczosSincFilter((1.0, 1.0), 3.0)
        self.filename = filename
        self.crop_min = (1, 1)
        self.crop_max = self.resolution
        self.width, self.height = self.resolution
        fr = self.filter.radius
        # A sample at base pixel p (d - p in [-0.5, 0.5)) touches pixels
        # p + delta, delta in [ceil(-0.5 - r), floor(0.5 + r) + 1].
        self.stencil_x = (int(math.ceil(-0.5 - fr[0])),
                          int(math.floor(0.5 + fr[0])) + 1)
        self.stencil_y = (int(math.ceil(-0.5 - fr[1])),
                          int(math.floor(0.5 + fr[1])) + 1)

    def sample_bounds(self):
        """Inclusive 1-based pixel range samplers must cover, padded by
        the filter radius: ((x0, y0), (x1, y1))."""
        fr = self.filter.radius
        lo = (int(math.floor(self.crop_min[0] + 0.5 - fr[0])),
              int(math.floor(self.crop_min[1] + 0.5 - fr[1])))
        hi = (int(math.ceil(self.crop_max[0] - 0.5 + fr[0])),
              int(math.ceil(self.crop_max[1] - 0.5 + fr[1])))
        return lo, hi

    def initial_state(self, device) -> FilmState:
        h, w = self.height, self.width
        return FilmState(torch.zeros((h, w, 3), dtype=F32, device=device),
                         torch.zeros((h, w), dtype=F32, device=device))

    def add_samples_grid(self, state: FilmState, p_film, L_rgb,
                         sample_weight, origin, grid_hw) -> FilmState:
        """Splat the complete raster sample grid (x-fastest lanes,
        N == gh * gw) through the static filter stencil. ``origin`` is
        sample_bounds' lo corner. Returns a new state; ``state`` is left
        as it was."""
        gh, gw = grid_hw
        x0, y0 = origin
        d_x = (p_film[:, 0] - 0.5).reshape(gh, gw)
        d_y = (p_film[:, 1] - 0.5).reshape(gh, gw)
        r = self.filter.radius
        inv_rx = float(np.float32(1.0 / r[0]))
        inv_ry = float(np.float32(1.0 / r[1]))
        step_x = float(np.float32(r[0] / FILTER_TABLE_WIDTH))
        step_y = float(np.float32(r[1] / FILTER_TABLE_WIDTH))

        xyz = spec.rgb_to_xyz(L_rgb) * sample_weight[..., None]
        vx = xyz[:, 0].reshape(gh, gw)
        vy = xyz[:, 1].reshape(gh, gw)
        vz = xyz[:, 2].reshape(gh, gw)

        p0x = torch.ceil(d_x - r[0]).clamp_min(float(self.crop_min[0]))
        p0y = torch.ceil(d_y - r[1]).clamp_min(float(self.crop_min[1]))
        p1x = (torch.floor(d_x + r[0]) + 1.0).clamp_max(float(self.crop_max[0]))
        p1y = (torch.floor(d_y + r[1]) + 1.0).clamp_max(float(self.crop_max[1]))

        dev = p_film.device
        px = (torch.arange(gw, dtype=F32, device=dev) + float(x0))[None, :]
        py = (torch.arange(gh, dtype=F32, device=dev) + float(y0))[:, None]

        H, W = self.height, self.width
        sx = x0 - self.crop_min[0]
        sy = y0 - self.crop_min[1]
        acc_x = state.xyz[..., 0].clone()
        acc_y = state.xyz[..., 1].clone()
        acc_z = state.xyz[..., 2].clone()
        acc_w = state.weight_sum.clone()

        for dy in range(self.stencil_y[0], self.stencil_y[1] + 1):
            ty0 = max(0, dy + sy)
            ly = min(H, gh + dy + sy) - ty0
            if ly <= 0:
                continue
            gy0 = ty0 - (dy + sy)
            for dx in range(self.stencil_x[0], self.stencil_x[1] + 1):
                tx0 = max(0, dx + sx)
                lx = min(W, gw + dx + sx) - tx0
                if lx <= 0:
                    continue
                gx0 = tx0 - (dx + sx)
                qx = px + float(dx)
                qy = py + float(dy)
                inb = (qx >= p0x) & (qx <= p1x) & (qy >= p0y) & (qy <= p1y)
                fx = ((qx - d_x) * inv_rx).abs() * FILTER_TABLE_WIDTH
                fy = ((qy - d_y) * inv_ry).abs() * FILTER_TABLE_WIDTH
                off_x = torch.ceil(fx).clamp(1, FILTER_TABLE_WIDTH) - 1.0
                off_y = torch.floor(fy).clamp(1, FILTER_TABLE_WIDTH) - 1.0
                w = self.filter((off_x + 0.5) * step_x,
                                (off_y + 0.5) * step_y) * inb.to(F32)
                gs = (slice(gy0, gy0 + ly), slice(gx0, gx0 + lx))
                ts = (slice(ty0, ty0 + ly), slice(tx0, tx0 + lx))
                ws = w[gs]
                acc_x[ts] += ws * vx[gs]
                acc_y[ts] += ws * vy[gs]
                acc_z[ts] += ws * vz[gs]
                acc_w[ts] += ws

        return FilmState(torch.stack([acc_x, acc_y, acc_z], dim=-1), acc_w)

    def set_image(self, rgb_image: torch.Tensor) -> FilmState:
        """A film holding a whole RGB image [H, W, 3] at unit weight (the
        SPPM path)."""
        return FilmState(spec.rgb_to_xyz(rgb_image),
                         torch.ones((self.height, self.width), dtype=F32,
                                    device=rgb_image.device))

    def to_image(self, state: FilmState):
        """Weight-normalized, clamped RGB [H, W, 3] (not flipped)."""
        rgb = spec.xyz_to_rgb(state.xyz)
        inv_w = torch.where(state.weight_sum != 0.0,
                            1.0 / state.weight_sum, 1.0)
        return (rgb * inv_w[..., None]).clamp(0.0, 1.0)

    def save_png(self, state: FilmState, path: str | None = None):
        from .png import write_png

        img = self.to_image(state).cpu().numpy()
        write_png(path or self.filename, img[::-1])  # vertical flip
        return img
