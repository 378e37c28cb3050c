"""The film's splat as the reference renderer defines it (Trace.jl's
film.jl): 1-based continuous coordinates, a pixel's filter weight read
at the 16-entry table's quantized points, ceil() offsets in x and floor()
in y, one pixel more on the far side of each axis; then XYZ sums over
weight sums."""
from __future__ import annotations

import math

import numpy as np

RGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                       [0.212671, 0.715160, 0.072169],
                       [0.019334, 0.119193, 0.950227]], np.float64)
TABLE = 16


def _sinc(x):
    x = np.abs(x)
    return np.where(x < 1e-5, 1.0, np.sin(np.pi * x)
                    / np.where(x < 1e-5, 1.0, np.pi * x))


def lanczos(x, radius: float, tau: float):
    x = np.abs(x)
    return np.where(x > radius, 0.0, _sinc(x) * _sinc(x / tau))


def _footprint(d, rx, ry, w_px, h_px):
    p0x = np.maximum(np.ceil(d[:, 0] - rx), 1.0)
    p0y = np.maximum(np.ceil(d[:, 1] - ry), 1.0)
    p1x = np.minimum(np.floor(d[:, 0] + rx) + 1.0, w_px)
    p1y = np.minimum(np.floor(d[:, 1] + ry) + 1.0, h_px)
    return p0x, p0y, p1x, p1y


def splat(p_film, rgb, resolution, radius, tau):
    """p_film [N, 2] (float32 film points), rgb [N, 3] -> (xyz sums
    [H, W, 3], weight sums [H, W]), float64; crop = the whole film."""
    w_px, h_px = resolution
    rx, ry = float(radius[0]), float(radius[1])
    d = np.asarray(p_film, np.float32).astype(np.float64) - 0.5
    xyz = np.asarray(rgb, np.float64) @ RGB_TO_XYZ.T
    p0x, p0y, p1x, p1y = _footprint(d, rx, ry, w_px, h_px)
    acc = np.zeros((h_px * w_px, 3))
    wsum = np.zeros(h_px * w_px)
    fx_n = int(math.floor(2 * rx)) + 2
    fy_n = int(math.floor(2 * ry)) + 2
    for ky in range(fy_n):
        qy = p0y + ky
        fy = np.abs((qy - d[:, 1]) / ry) * TABLE
        wy = lanczos((np.clip(np.floor(fy), 1, TABLE) - 0.5) * ry / TABLE,
                     ry, tau)
        for kx in range(fx_n):
            qx = p0x + kx
            fx = np.abs((qx - d[:, 0]) / rx) * TABLE
            wx = lanczos((np.clip(np.ceil(fx), 1, TABLE) - 0.5) * rx / TABLE,
                         rx, tau)
            inb = (qx <= p1x) & (qy <= p1y)
            w = np.where(inb, wx * wy, 0.0)
            flat = ((np.clip(qy, 1, h_px) - 1) * w_px
                    + np.clip(qx, 1, w_px) - 1).astype(np.int64)
            np.add.at(acc, flat, w[:, None] * xyz)
            np.add.at(wsum, flat, w)
    return acc.reshape(h_px, w_px, 3), wsum.reshape(h_px, w_px)
