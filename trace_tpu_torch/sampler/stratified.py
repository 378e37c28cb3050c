"""Stratified sampler (port of trace_tpu/sampler/stratified.py).

``x_samples * y_samples`` jittered strata per pixel. Pass it to any
integrator in place of UniformSampler: the render loop draws each lane's
film jitter as the uniform sampler does, then confines it to stratum
``s`` of sample ``s`` (integrators/base.py::stratum_arrays).
``get_camera_samples`` is the standalone batched draw, bit-equal to the
JAX twin's on the same key.
"""
from __future__ import annotations

import torch

from . import uniform as U

F32 = torch.float32


class StratifiedSampler:
    """x_samples * y_samples jittered strata per pixel."""

    def __init__(self, x_samples: int = 2, y_samples: int = 2,
                 jitter: bool = True, seed: int = 0):
        self.x_samples = int(x_samples)
        self.y_samples = int(y_samples)
        self.samples_per_pixel = self.x_samples * self.y_samples
        self.jitter = bool(jitter)
        self.seed = int(seed)

    def stratum(self, sample_index: int):
        """(sx, sy) cell of the flat sample index."""
        return (sample_index % self.x_samples,
                sample_index // self.x_samples)


def get_camera_samples(sampler: StratifiedSampler, key: torch.Tensor,
                       pixel_xy: torch.Tensor, sample_index: int):
    """The film jitter inside stratum ``sample_index`` of each pixel, from
    one key [2] split three ways (film, lens, time) as the JAX twin splits
    it. pixel_xy: [N, 2] int. Returns (p_film [N, 2], u_lens [N, 2],
    u_time [N])."""
    n = pixel_xy.shape[0]
    dev = pixel_xy.device
    sx, sy = sampler.stratum(sample_index)
    k1, k2, k3 = U.split(key, 3)
    if sampler.jitter:
        u = U.uniform(k1, (n, 2))
    else:
        u = torch.full((n, 2), 0.5, dtype=F32, device=dev)
    cell = torch.tensor([sx, sy], dtype=F32, device=dev)
    size = torch.tensor([sampler.x_samples, sampler.y_samples], dtype=F32,
                        device=dev)
    p_film = pixel_xy.to(F32) + (cell + u) / size
    return p_film, U.uniform(k2, (n, 2)), U.uniform(k3, (n,))
