"""The film's gather splat: csrc/splat.cu, bound with ctypes (ops/nvcc.py),
and its plain PyTorch twin.

It replaces no Pallas kernel: the JAX package splats with XLA's
scatter-add (trace_tpu/film/film.py::Film.add_samples). On the card the
render loop's chunk splats go through the kernel (film/film.py::
Film.add_samples with ``lanes``); every other splat keeps the scatter.
One thread owns one film pixel and adds the chunk's lanes whose footprint
covers it, in ascending lane order: the order of the CPU's deterministic
scatter, bit for bit where the lanes' xyz is finite (csrc/splat.cu's
notes). :func:`splat_plain` has the
kernel's signature and arithmetic; the kernel takes CUDA tensors only,
the twin any.

Both take the film (its crop window, filter radius, footprint and stencil),
its state (FilmState: xyz [H, W, 3], weight_sum [H, W]), the chunk's lanes
p_film [C, 2] and xyz [C, 3] (radiance times sample weight, in XYZ), and a
:class:`GridLanes`, and return the new (xyz, weight_sum); the state is
left as it was.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .nvcc import CudaLibrary, check_tensors

F32 = torch.float32
TABLE = 16   # film/film.py FILTER_TABLE_WIDTH


class GridLanes(NamedTuple):
    """A chunk's place in the sample grid (x fastest): its lanes
    0 .. n_valid - 1 are grid lanes start .. start + n_valid - 1, the rest
    padding. ``origin``: the 1-based pixel of grid lane 0 (sample_bounds'
    lo corner); ``grid_w``: the grid's columns; ``table``: the filter's
    16 x 16 weights (Film.filter_table) on the lanes' device."""
    start: int
    n_valid: int
    origin: tuple
    grid_w: int
    table: torch.Tensor


class SplatParams(ctypes.Structure):
    """csrc/splat.cu's SplatParams."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "height", "width", "crop_x", "crop_y", "fp_x", "fp_y", "grid_x",
        "grid_y", "grid_w", "start", "n_valid", "win_x0", "win_x1",
        "win_y0", "win_y1")]
        + [(n, ctypes.c_float) for n in (
            "lo_x", "lo_y", "hi_x", "hi_y", "r_x", "r_y", "inv_rx",
            "inv_ry")])


def params(film, lanes: GridLanes) -> SplatParams:
    """The launch's constants. The candidate window is the film's stencil
    seen from the pixel, widened by one each way: a lane at grid pixel P
    touches P + delta, delta in the stencil, so pixel X gathers lanes at X
    - delta."""
    r = np.asarray(film.filter.radius, np.float32)
    inv_r = np.float32(1.0) / r
    (sx0, sx1), (sy0, sy1) = film.stencil_x, film.stencil_y
    return SplatParams(
        film.height, film.width, film.crop_min[0], film.crop_min[1],
        film.fp_x, film.fp_y, int(lanes.origin[0]), int(lanes.origin[1]),
        int(lanes.grid_w), int(lanes.start), int(lanes.n_valid),
        -sx1 - 1, -sx0 + 1, -sy1 - 1, -sy0 + 1,
        max(film.crop_min[0], 1), max(film.crop_min[1], 1),
        film.crop_max[0], film.crop_max[1], r[0], r[1], inv_r[0], inv_r[1])


def _check(what, state, p_film, xyz, lanes):
    c = p_film.shape[0]
    h, w = state.weight_sum.shape
    check_tensors(what, p_film.device, (
        (state.xyz, F32, (h, w, 3)), (state.weight_sum, F32, (h, w)),
        (p_film, F32, (c, 2)), (xyz, F32, (c, 3)),
        (lanes.table, F32, (TABLE, TABLE))))
    if not (lanes.start >= 0 and 1 <= lanes.n_valid <= c
            and lanes.grid_w >= 1):
        raise ValueError(f"{what}: wants start >= 0, 1 <= n_valid <= "
                         f"{c} lanes and grid_w >= 1, got {lanes[:4]}")


def splat_plain(film, state, p_film, xyz, lanes: GridLanes):
    """Plain PyTorch version of the kernel: for each candidate lane of the
    window in ascending lane order (grid row, then column), each film
    pixel adds that lane's entry where the lane is in the chunk's valid
    range and its footprint covers the pixel. -> (xyz [H, W, 3],
    weight_sum [H, W])."""
    _check("splat_plain", state, p_film, xyz, lanes)
    p = params(film, lanes)
    dev = p_film.device
    h, w = state.weight_sum.shape
    px = torch.arange(w, device=dev)[None, :] + p.crop_x        # [1, W]
    py = torch.arange(h, device=dev)[:, None] + p.crop_y        # [H, 1]
    xf, yf = px.to(F32), py.to(F32)
    acc = [state.xyz[..., k] for k in range(3)] + [state.weight_sum]
    for ky in range(p.win_y0, p.win_y1 + 1):
        gy = py + ky - p.grid_y
        for kx in range(p.win_x0, p.win_x1 + 1):
            gx = px + kx - p.grid_x
            lane = gy * p.grid_w + gx - p.start                  # [H, W]
            ok = (gx >= 0) & (gx < p.grid_w) & (lane >= 0) \
                & (lane < p.n_valid)
            i = lane.clamp(0, p.n_valid - 1)
            d = p_film[i] - 0.5                                  # [H, W, 2]
            dx, dy = d[..., 0], d[..., 1]
            p0x = torch.ceil(dx - p.r_x).clamp_min(p.lo_x)
            p0y = torch.ceil(dy - p.r_y).clamp_min(p.lo_y)
            p1x = (torch.floor(dx + p.r_x) + 1.0).clamp_max(p.hi_x)
            p1y = (torch.floor(dy + p.r_y) + 1.0).clamp_max(p.hi_y)
            ok = ok & (p0x <= xf) & (xf <= p1x) & (xf - p0x < p.fp_x) \
                & (p0y <= yf) & (yf <= p1y) & (yf - p0y < p.fp_y)
            fx = ((xf - dx) * p.inv_rx).abs() * TABLE
            fy = ((yf - dy) * p.inv_ry).abs() * TABLE
            ox = torch.ceil(fx).clamp(1, TABLE).to(torch.int64) - 1
            oy = torch.floor(fy).clamp(1, TABLE).to(torch.int64) - 1
            wt = lanes.table[oy, ox]
            v = xyz[i]
            acc = [torch.where(ok, a + wt * v[..., k], a)
                   for k, a in enumerate(acc[:3])] \
                + [torch.where(ok, acc[3] + wt, acc[3])]
    return torch.stack(acc[:3], dim=-1), acc[3]


class SplatKernel:
    """ctypes binding of csrc/splat.cu, built at the first launch.
    ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self.lib = CudaLibrary("splat", "splat_gather_launch",
                               [ctypes.c_void_p] * 7
                               + [ctypes.POINTER(SplatParams),
                                  ctypes.c_void_p])

    def reset_counts(self) -> None:
        self.launches = 0

    def __call__(self, film, state, p_film, xyz, lanes: GridLanes):
        dev = p_film.device
        if dev.type != "cuda":
            raise ValueError("splat kernel: wants CUDA tensors (splat_plain "
                             "takes the CPU's)")
        _check("splat kernel", state, p_film, xyz, lanes)
        launch = self.lib.load()
        out_xyz = torch.empty_like(state.xyz)
        out_ws = torch.empty_like(state.weight_sum)
        p = params(film, lanes)
        if out_ws.numel():
            err = launch(state.xyz.data_ptr(), state.weight_sum.data_ptr(),
                         p_film.data_ptr(), xyz.data_ptr(),
                         lanes.table.data_ptr(), out_xyz.data_ptr(),
                         out_ws.data_ptr(), ctypes.byref(p),
                         torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(
                    f"splat kernel launch failed: CUDA error {err}")
            self.launches += 1
        return out_xyz, out_ws


splat_kernel = SplatKernel()
