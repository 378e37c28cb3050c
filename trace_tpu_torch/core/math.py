"""Packed [..., 3] vector helpers (port of trace_tpu/core/math.py, the
part the camera and film need). Component arithmetic is written out, as
in the JAX twin, so no 3-vector op goes through a matrix product. Also
the deterministic scatter-add that the film and SPPM's pair pass share."""
from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def length(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """Zero-guarded: a zero vector passes through unchanged."""
    n = length(a)
    return a / torch.where(n == 0.0, 1.0, n)[..., None]


def lerp(a, b, t):
    return (1.0 - t) * a + t * b



def scatter_add(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor):
    """dst[idx] += val with duplicates, in place, in the same order on
    every run: PyTorch's deterministic algorithm. On the CPU a serial loop
    in update order, as the JAX scatter adds (bit for bit), where the
    default multithreaded loop associates otherwise; on CUDA a sort of the
    indices, then a fixed reduction per index, in place of atomics."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        dst.index_put_((idx,), val, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
    return dst
