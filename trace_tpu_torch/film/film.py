"""Film: deterministic sample splatting (port of trace_tpu/film/film.py).

Reference conventions kept as in the JAX twin: 1-based continuous film
coordinates, a crop window in [0, 1]^2 whose 1-based pixel bounds follow
film.jl:41-44, filter weights at the 16-entry table's quantized points
with ceil() offsets in x and floor() in y, the one-pixel-wider footprint,
unfiltered splats added after the weight normalization, and the vertical
flip on save. Two splats: ``add_samples_grid`` when the lanes are the
complete sample-bounds grid (each filter-footprint offset is one shifted
slice-add, no scatter), and ``add_samples``, the scatter over any lanes.
Both add in the same order on every run, on the card too.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import spectrum as spec
from ..core.math import scatter_add
from .filters import LanczosSincFilter, weights

F32 = torch.float32
FILTER_TABLE_WIDTH = 16


class FilmState(NamedTuple):
    xyz: torch.Tensor          # [H, W, 3]
    weight_sum: torch.Tensor   # [H, W]
    splat_xyz: torch.Tensor    # [H, W, 3]


class Film:
    """Static film configuration: resolution, crop window (in [0, 1]^2,
    as the reference's Film), filter, diagonal (mm), scale."""

    def __init__(self, resolution, crop=((0.0, 0.0), (1.0, 1.0)),
                 filter=None, diagonal: float = 35.0, scale: float = 1.0,
                 filename: str = "out.png"):
        self.resolution = (int(resolution[0]), int(resolution[1]))
        self.filter = filter or LanczosSincFilter((1.0, 1.0), 3.0)
        self.diagonal = float(diagonal) * 0.001
        self.scale = float(scale)
        self.filename = filename
        rx, ry = self.resolution
        # 1-based inclusive pixel bounds of the crop window (film.jl:41-44).
        self.crop_min = (int(math.ceil(rx * crop[0][0])) + 1,
                         int(math.ceil(ry * crop[0][1])) + 1)
        self.crop_max = (int(math.ceil(rx * crop[1][0])),
                         int(math.ceil(ry * crop[1][1])))
        self.width = self.crop_max[0] - self.crop_min[0] + 1
        self.height = self.crop_max[1] - self.crop_min[1] + 1
        fr = self.filter.radius
        # The scatter's static footprint: at most floor(2r) + 2 pixels an
        # axis (ceil(d - r)..floor(d + r) + 1 inclusive).
        self.fp_x = int(math.floor(2 * fr[0])) + 2
        self.fp_y = int(math.floor(2 * fr[1])) + 2
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

    def physical_extent(self):
        """((x0, y0), (x1, y1)) of the film's physical area, in meters,
        centred at 0 (film.jl:79-84)."""
        aspect = self.resolution[1] / self.resolution[0]
        x = math.sqrt(self.diagonal ** 2 / (1 + aspect ** 2))
        y = aspect * x
        return ((-x / 2, -y / 2), (x / 2, y / 2))

    def initial_state(self, device="cuda") -> FilmState:
        h, w = self.height, self.width
        return FilmState(torch.zeros((h, w, 3), dtype=F32, device=device),
                         torch.zeros((h, w), dtype=F32, device=device),
                         torch.zeros((h, w, 3), dtype=F32, device=device))

    def _table_points(self):
        """float32 1 / r and r / 16 per axis, as the JAX twin rounds
        them."""
        r = np.asarray(self.filter.radius, np.float32)
        inv_r = np.float32(1.0) / r
        step = r / np.float32(FILTER_TABLE_WIDTH)
        return [float(v) for v in inv_r], [float(v) for v in step]

    def add_samples(self, state: FilmState, p_film, L_rgb, sample_weight,
                    valid=None) -> FilmState:
        """Scatter N samples over their filter footprints (film.jl:134-164).

        p_film: [N, 2] 1-based continuous film coordinates; L_rgb: [N, 3];
        sample_weight: [N]. ``valid`` ([N] bool, optional) disables lanes
        entirely: their xyz and their filter weight. The footprint entries
        go through a deterministic scatter (core.math.scatter_add: in
        sample order on the CPU, as JAX's; the same order every run on the
        card). Returns a new state."""
        dev = p_film.device
        d = p_film - 0.5
        r = self.filter.radius
        (inv_rx, inv_ry), (step_x, step_y) = self._table_points()
        p0x = torch.ceil(d[:, 0] - r[0]).clamp_min(
            float(max(self.crop_min[0], 1)))
        p0y = torch.ceil(d[:, 1] - r[1]).clamp_min(
            float(max(self.crop_min[1], 1)))
        p1x = (torch.floor(d[:, 0] + r[0]) + 1.0).clamp_max(
            float(self.crop_max[0]))
        p1y = (torch.floor(d[:, 1] + r[1]) + 1.0).clamp_max(
            float(self.crop_max[1]))

        xyz = spec.rgb_to_xyz(L_rgb) * sample_weight[..., None]
        px = p0x[:, None] + torch.arange(self.fp_x, dtype=F32, device=dev)
        py = p0y[:, None] + torch.arange(self.fp_y, dtype=F32, device=dev)
        in_x = px <= p1x[:, None]                                 # [N, fx]
        in_y = py <= p1y[:, None]                                 # [N, fy]
        fx = ((px - d[:, 0:1]) * inv_rx).abs() * FILTER_TABLE_WIDTH
        fy = ((py - d[:, 1:2]) * inv_ry).abs() * FILTER_TABLE_WIDTH
        off_x = torch.ceil(fx).clamp(1, FILTER_TABLE_WIDTH) - 1.0
        off_y = torch.floor(fy).clamp(1, FILTER_TABLE_WIDTH) - 1.0
        n = p_film.shape[0]
        shape = (n, self.fp_y, self.fp_x)
        w = weights(self.filter,
                    ((off_x + 0.5) * step_x)[:, None, :].expand(shape),
                    ((off_y + 0.5) * step_y)[:, :, None].expand(shape))
        mask = in_y[:, :, None] & in_x[:, None, :]
        if valid is not None:
            mask = mask & valid[:, None, None]
        wf = (w * mask.to(F32)).reshape(-1)

        ix = (px - self.crop_min[0]).to(torch.int64)
        iy = (py - self.crop_min[1]).to(torch.int64)
        flat = (iy.clamp(0, self.height - 1)[:, :, None] * self.width
                + ix.clamp(0, self.width - 1)[:, None, :]).reshape(-1)
        contrib = wf[:, None] * xyz.repeat_interleave(self.fp_x * self.fp_y,
                                                      dim=0)
        new_xyz = scatter_add(state.xyz.reshape(-1, 3).clone(), flat,
                              contrib).reshape(state.xyz.shape)
        new_ws = scatter_add(state.weight_sum.reshape(-1).clone(), flat,
                             wf).reshape(state.weight_sum.shape)
        return FilmState(new_xyz, new_ws, state.splat_xyz)

    def add_samples_grid(self, state: FilmState, p_film, L_rgb,
                         sample_weight, origin, grid_hw,
                         valid=None) -> FilmState:
        """Splat the complete raster sample grid (x-fastest lanes,
        N == gh * gw) through the static filter stencil. ``origin`` is
        sample_bounds' lo corner; ``valid`` ([N] bool, optional) drops
        lanes' filter weights, as the JAX package's does (callers also
        zero those lanes' radiance and weight). Returns a new state;
        ``state`` is left as it was."""
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
        vmask = None if valid is None else valid.reshape(gh, gw).to(F32)

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
                w = weights(self.filter, (off_x + 0.5) * step_x,
                            (off_y + 0.5) * step_y) * inb.to(F32)
                if vmask is not None:
                    w = w * vmask
                gs = (slice(gy0, gy0 + ly), slice(gx0, gx0 + lx))
                ts = (slice(ty0, ty0 + ly), slice(tx0, tx0 + lx))
                ws = w[gs]
                acc_x[ts] += ws * vx[gs]
                acc_y[ts] += ws * vy[gs]
                acc_z[ts] += ws * vz[gs]
                acc_w[ts] += ws

        return FilmState(torch.stack([acc_x, acc_y, acc_z], dim=-1), acc_w,
                         state.splat_xyz)

    def add_splats(self, state: FilmState, p_film, L_rgb) -> FilmState:
        """Unfiltered splats at integer pixels (deterministic scatter).
        Splats outside the crop are dropped, not clamped onto its border;
        a dropped lane's radiance goes through a select, so a non-finite
        value cannot reach the film."""
        ix = torch.floor(p_film[:, 0]).to(torch.int64) - self.crop_min[0]
        iy = torch.floor(p_film[:, 1]).to(torch.int64) - self.crop_min[1]
        inb = (ix >= 0) & (ix < self.width) & (iy >= 0) & (iy < self.height)
        flat = (iy.clamp(0, self.height - 1) * self.width
                + ix.clamp(0, self.width - 1))
        xyz = torch.where(inb[:, None], spec.rgb_to_xyz(L_rgb), 0.0)
        splat = scatter_add(state.splat_xyz.reshape(-1, 3).clone(), flat,
                            xyz).reshape(state.splat_xyz.shape)
        return FilmState(state.xyz, state.weight_sum, splat)

    def set_image(self, rgb_image: torch.Tensor) -> FilmState:
        """A film holding a whole RGB image [H, W, 3] at unit weight (the
        SPPM path)."""
        dev = rgb_image.device
        return FilmState(spec.rgb_to_xyz(rgb_image),
                         torch.ones((self.height, self.width), dtype=F32,
                                    device=dev),
                         torch.zeros((self.height, self.width, 3), dtype=F32,
                                     device=dev))

    def to_image(self, state: FilmState, splat_scale: float = 1.0):
        """Weight-normalize, add the splats, scale, clamp: RGB [H, W, 3]
        (not flipped; film.jl:204-222 without the write)."""
        rgb = spec.xyz_to_rgb(state.xyz)
        inv_w = torch.where(state.weight_sum != 0.0,
                            1.0 / state.weight_sum, 1.0)
        rgb = (rgb * inv_w[..., None]).clamp_min(0.0)
        rgb = rgb + splat_scale * spec.xyz_to_rgb(state.splat_xyz)
        return (rgb * self.scale).clamp(0.0, 1.0)

    def save_png(self, state: FilmState, path: str | None = None,
                 splat_scale: float = 1.0):
        from .png import write_png

        img = self.to_image(state, splat_scale).cpu().numpy()
        write_png(path or self.filename, img[::-1])  # vertical flip
        return img
