"""Threefry-2x32 (20 rounds) and the key scheme of ``jax.random`` with
partitionable counters, in numpy uint32: the draws a seed gives."""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
U32 = np.uint32


def _rotl(x, r):
    return (x << U32(r)) | (x >> U32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The hash of counter words (x0, x1) under key (k0, k1); uint32
    arrays that broadcast together."""
    k0, k1, x0, x1 = (np.asarray(a, dtype=U32) for a in (k0, k1, x0, x1))
    k2 = k0 ^ k1 ^ U32(0x1BD11BDA)
    ks = (k0, k1, k2)
    with np.errstate(over="ignore"):
        x0 = x0 + k0
        x1 = x1 + k1
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + U32(i + 1)
    return x0, x1


def key(seed: int):
    """The key of ``seed`` (its low 32 bits): words (0, seed)."""
    return (U32(0), U32(int(seed) & 0xFFFFFFFF))


def fold_in(k, data):
    """A new key per ``data`` (uint32 array or int) from key ``k``."""
    data = np.asarray(data, dtype=np.int64).astype(U32)
    return threefry2x32(k[0], k[1], np.zeros_like(data), data)


def uniforms(k, cols: int):
    """[N, cols] float64 uniforms in [0, 1) of keys ``k`` (arrays [N]):
    column c hashes the counter (0, c); 23 mantissa bits, exact."""
    c = np.arange(cols, dtype=U32)[None, :]
    y0, y1 = threefry2x32(k[0][:, None], k[1][:, None], np.zeros_like(c), c)
    return ((y0 ^ y1) >> U32(9)).astype(np.float64) * 2.0 ** -23


def pixel_ids(px, py):
    """(y << 16) | x of integer raster coordinates."""
    return ((np.asarray(py, np.int64) << 16) | np.asarray(px, np.int64)) \
        & 0xFFFFFFFF
