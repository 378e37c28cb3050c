"""Counter-based sampling: Threefry-2x32, bit-exact with ``jax.random``.

Port of trace_tpu/sampler/uniform.py. A key is an int64 tensor [..., 2]
holding two uint32 words; the plain version's arithmetic runs in int64
masked to 32 bits (torch's uint32 op coverage is thin). The layout
matches JAX with ``jax_threefry_partitionable=True`` (its default):
``uniform(key, (c,))`` hashes the counter pair (0, i) for i < c and XORs
the two output words.
There is no global RNG: every draw hangs off an explicit key.

On the card every :func:`fold_in` and :func:`uniform_lanes` (and so every
function here that draws) is one launch of the hand-written kernel
(ops/threefry.py, csrc/threefry.cu); CPU tensors take the plain twins
:func:`fold_in_plain` and :func:`uniform_lanes_plain`, which give the same
bits on either device.
"""
from __future__ import annotations

import torch

from ..ops.threefry import threefry_kernel

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


class UniformSampler:
    def __init__(self, samples_per_pixel: int = 1, seed: int = 0):
        self.samples_per_pixel = int(samples_per_pixel)
        self.seed = int(seed)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on int64 words < 2**32; key and
    counter words broadcast against each other."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int, device) -> torch.Tensor:
    """``jax.random.key(seed)`` for 0 <= seed < 2**32: words (0, seed)."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a key array [..., 2]; ``data`` is a
    scalar or an integer tensor broadcasting against the key batch. On
    the card one kernel launch (ops/threefry.py::ThreefryKernel.fold)."""
    if keys.device.type == "cuda":
        return threefry_kernel.fold(keys, data)
    return fold_in_plain(keys, data)


def fold_in_plain(keys: torch.Tensor, data) -> torch.Tensor:
    """:func:`fold_in` in tensor ops on any device: the kernel's twin."""
    if not torch.is_tensor(data):
        # A fill on the device, not a host copy (which would wait for the
        # device to drain).
        data = torch.full((), int(data), dtype=torch.int64,
                          device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data, dtype=torch.int64),
                          data.to(torch.int64) & M32)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def lane_keys(key: torch.Tensor, lane_id: torch.Tensor) -> torch.Tensor:
    """Per-lane keys from stable integer lane identities."""
    return fold_in(key, lane_id)


def fold_lanes(keys: torch.Tensor, salt) -> torch.Tensor:
    """fold_in over a key array [N, 2]; ``salt`` is a scalar or [N]."""
    return fold_in(keys, salt)


def uniform_lanes(keys: torch.Tensor, cols: int) -> torch.Tensor:
    """[N, cols] float32 uniforms in [0, 1), one row per lane key. On the
    card one kernel launch (ops/threefry.py::ThreefryKernel.uniform)."""
    if keys.device.type == "cuda":
        return threefry_kernel.uniform(keys, cols)
    return uniform_lanes_plain(keys, cols)


def uniform_lanes_plain(keys: torch.Tensor, cols: int) -> torch.Tensor:
    """:func:`uniform_lanes` in tensor ops on any device: the kernel's
    twin."""
    ctr = torch.arange(cols, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2],
                          torch.zeros_like(ctr), ctr)
    bits = y0 ^ y1
    # (bits >> 9) | 0x3F800000 read as a float in [1, 2), minus 1: the
    # same value is mantissa * 2**-23, exact in float32.
    return (bits >> 9).to(torch.float32) * (2.0 ** -23)


def split(key_: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)`` of one key [2] -> [num, 2]: with
    partitionable counters, key i hashes the counter pair (0, i), which is
    ``fold_in(key, i)``."""
    return fold_in(key_, torch.arange(num, dtype=torch.int64,
                                      device=key_.device))


def uniform(key_: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` of one key [2]: element
    i of the row-major flattening hashes the counter pair (0, i)."""
    n = 1
    for s in shape:
        n *= int(s)
    return uniform_lanes(key_[None], n).reshape(tuple(shape))


def pixel_ids(pixel_xy: torch.Tensor) -> torch.Tensor:
    """(y << 16) | x on the 1-based raster coordinates."""
    x = pixel_xy[:, 0].to(torch.int64)
    y = pixel_xy[:, 1].to(torch.int64)
    return ((y << 16) | x) & M32


def get_camera_samples_lanes(keys: torch.Tensor, pixel_xy: torch.Tensor):
    """5 uniforms per lane key -> (p_film [N, 2], u_lens [N, 2],
    u_time [N])."""
    cols = uniform_lanes(keys, 5)
    p_film = pixel_xy.to(torch.float32) + cols[:, :2]
    return p_film, cols[:, 2:4], cols[:, 4]
