"""1D piecewise-constant distributions (port of
trace_tpu/sampler/distribution.py).

The CDF is built on the host in float32 exactly as the JAX twin builds it
and uploaded once per device; lookups are a ``torch.searchsorted`` over a
batch of u values.
"""
from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


class Distribution1D:
    def __init__(self, func):
        f = np.asarray(func, np.float32)
        n = f.size
        cdf = np.zeros(n + 1, np.float32)
        cdf[1:] = np.cumsum(f / n)
        self.func_int = float(cdf[-1])
        if self.func_int == 0.0:
            cdf[1:] = np.arange(1, n + 1, dtype=np.float32) / n
        else:
            cdf[1:] /= self.func_int
        self.func = f          # host numpy
        self.cdf = cdf
        self.n = n
        self._tables = {}      # device -> tables()

    def tables(self, device):
        """(cdf [n + 1], func [n], the divisors func_int * n, func_int and
        n as float32 scalars) on ``device``, uploaded once. Divisors are
        device tensors: CUDA turns a division by a host scalar into a
        multiply by its reciprocal, which rounds differently."""
        device = torch.device(device)
        if device not in self._tables:
            div = np.asarray([self.func_int * self.n, self.func_int, self.n],
                             np.float32)
            self._tables[device] = (torch.from_numpy(self.cdf).to(device),
                                    torch.from_numpy(self.func).to(device),
                                    *torch.from_numpy(div).to(device))
        return self._tables[device]

    def _offset(self, cdf, u):
        # The last index with cdf[offset] <= u.
        return (torch.searchsorted(cdf, u, right=True) - 1).clamp(
            0, self.n - 1)

    def sample_discrete(self, u: torch.Tensor):
        """-> (index int32 [same shape as u], pdf, u remapped into the
        picked bin); index is 0-based."""
        cdf, func, int_n, _, _ = self.tables(u.device)
        offset = self._offset(cdf, u)
        if self.func_int > 0:
            pdf = func[offset] / int_n
        else:
            pdf = torch.zeros_like(u)
        c0, c1 = cdf[offset], cdf[offset + 1]
        u_remapped = (u - c0) / torch.where(c1 > c0, c1 - c0, 1.0)
        return offset.to(torch.int32), pdf, u_remapped

    def sample_continuous(self, u: torch.Tensor):
        """-> (x in [0, 1), pdf, index int32)."""
        cdf, func, _, f_int, n = self.tables(u.device)
        offset = self._offset(cdf, u)
        c0, c1 = cdf[offset], cdf[offset + 1]
        du = (u - c0) / torch.where(c1 > c0, c1 - c0, 1.0)
        if self.func_int > 0:
            pdf = func[offset] / f_int
        else:
            pdf = torch.zeros_like(u)
        x = (offset.to(F32) + du) / n
        return x, pdf, offset.to(torch.int32)
