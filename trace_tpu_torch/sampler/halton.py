"""Halton / radical-inverse low-discrepancy sequences (port of
trace_tpu/sampler/halton.py).

Bit-exact with the JAX package: the same sieved prime table, base 2 by
32-bit reversal scaled by 2**-32, other bases by digit reversal with the
float32 running product of 1/base. The JAX twin keeps the reversed digits
in two uint32 limbs (hi * 2**32 + lo) for want of 64-bit integers; here an
int64 accumulator holds the same exact value and is split into the same
limbs before the float32 conversion. The index is a uint32 held in int64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.sync import device_constant

F32 = torch.float32
M32 = 0xFFFFFFFF
TWO_M32 = float(np.float32(2.3283064365386963e-10))   # 2^-32


def _sieve_primes(n: int) -> np.ndarray:
    """First n primes."""
    limit = max(100, int(n * (np.log(n + 2) + np.log(np.log(n + 3))) * 1.2))
    sieve = np.ones(limit, bool)
    sieve[:2] = False
    for p in range(2, int(limit ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    primes = np.flatnonzero(sieve)[:n]
    assert primes.size == n
    return primes.astype(np.uint32)


PRIMES = _sieve_primes(1024)

_MAX_DIGITS = 32  # enough for any uint32 index in base >= 2


def reverse_bits32(n: torch.Tensor) -> torch.Tensor:
    n = n.to(torch.int64) & M32
    n = ((n << 16) | (n >> 16)) & M32
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    return ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)


def _digits(base: int, a_max: int | None) -> int:
    """Base-``base`` digits of the largest index (the loop's trip count:
    later trips change no lane)."""
    if a_max is None:
        return _MAX_DIGITS
    n, a = 0, int(a_max)
    while a > 0:
        a //= base
        n += 1
    return n


def radical_inverses(dims, a: torch.Tensor, a_max: int | None = None
                     ) -> torch.Tensor:
    """[len(dims), N] float32: the radical inverse of the uint32 indices
    ``a`` [N] in each base PRIMES[dim]. ``a_max`` (optional) is a host
    bound on the indices; it only shortens the digit loop."""
    a = a.to(torch.int64) & M32
    dims = [int(x) for x in dims]
    out = [None] * len(dims)
    if 0 in dims:
        rev = reverse_bits32(a).to(F32) * TWO_M32
        for i, dm in enumerate(dims):
            if dm == 0:
                out[i] = rev
    gen = [(i, dm) for i, dm in enumerate(dims) if dm != 0]
    if gen:
        bases = [int(PRIMES[dm]) for _, dm in gen]
        k = len(gen)
        base = device_constant(tuple(bases), torch.int64, a.device)[:, None]
        inv_base = 1.0 / base.to(F32)
        cur = a[None, :].expand(k, -1)
        acc = torch.zeros((k, a.shape[0]), dtype=torch.int64, device=a.device)
        inv_n = torch.ones((k, a.shape[0]), dtype=F32, device=a.device)
        for _ in range(_digits(min(bases), a_max)):
            active = cur > 0
            nxt = cur // base
            digit = cur - nxt * base
            acc = torch.where(active, acc * base + digit, acc)
            inv_n = torch.where(active, inv_n * inv_base, inv_n)
            cur = nxt
        rev_f = (acc >> 32).to(F32) * 4294967296.0 + (acc & M32).to(F32)
        vals = (rev_f * inv_n).clamp_max(1.0)
        for row, (i, _) in enumerate(gen):
            out[i] = vals[row]
    return torch.stack(out)


def radical_inverse(base_index: int, a: torch.Tensor,
                    a_max: int | None = None) -> torch.Tensor:
    """Radical inverse [N] of uint32 indices ``a`` in the base_index-th
    prime (base_index 0: bit reversal in base 2)."""
    return radical_inverses([base_index], a, a_max)[0]
