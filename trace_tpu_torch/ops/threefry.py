"""The Threefry-2x32 hash on the card: csrc/threefry.cu, bound with ctypes
(ops/nvcc.py).

It replaces no Pallas kernel: it is the counterpart of ``jax.random``'s
threefry, which XLA fuses for the JAX package. sampler/uniform.py sends
every ``fold_in`` and ``uniform_lanes`` of CUDA tensors here, one launch a
call; CPU tensors take the plain twin there (``fold_in_plain``,
``uniform_lanes_plain`` over ``threefry2x32``), which gives the same bits.
The kernel takes CUDA tensors only and raises on a form it does not take.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..utils.stats import count
from .nvcc import CudaLibrary

M32 = 0xFFFFFFFF
# csrc/threefry.cu's DataKind.
SCALAR, INT32, INT64 = 0, 1, 2
_KINDS = {torch.int32: INT32, torch.int64: INT64}


def _keys(what: str, keys: torch.Tensor) -> torch.Tensor:
    """``keys`` [..., 2] int64 on the card, contiguous and 16-byte aligned
    (the kernel loads a key as one longlong2)."""
    if keys.device.type != "cuda":
        raise ValueError(f"threefry kernel {what}: wants CUDA tensors (the "
                         f"plain twin in sampler/uniform.py takes the CPU's)")
    if keys.dtype != torch.int64 or keys.dim() < 1 or keys.shape[-1] != 2:
        raise ValueError(f"threefry kernel {what}: wants int64 keys [..., 2],"
                         f" got {keys.dtype} {tuple(keys.shape)}")
    keys = keys.contiguous()
    return keys if keys.data_ptr() % 16 == 0 else keys.clone()


class ThreefryKernel:
    """ctypes binding of csrc/threefry.cu, built at the first launch.
    ``launches`` counts kernel launches; each also adds one to the
    ``threefry_launches`` counter (utils/stats.py)."""

    def __init__(self):
        self.launches = 0
        self.lib = CudaLibrary(
            "threefry", "threefry_fold_launch",
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p])

    def reset_counts(self) -> None:
        self.launches = 0

    def _launched(self, err: int, what: str) -> None:
        if err != 0:
            raise RuntimeError(f"threefry {what} launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        count("threefry_launches", 1)

    def fold(self, keys: torch.Tensor, data) -> torch.Tensor:
        """``fold_in(keys, data)``: keys [..., 2]; data a Python integer
        (a launch argument), a one-element tensor (a CPU one read as a
        launch argument, a card one read on the card), or an integer
        tensor of the card. Key batch and data each hold one element or
        one for each output key. -> int64 [broadcast shape, 2]."""
        keys = _keys("fold", keys)
        dev = keys.device
        scalar, kind, ptr, step = 0, SCALAR, None, 0
        if not torch.is_tensor(data):
            shape = ()
            scalar = int(data) & M32
        else:
            shape = tuple(data.shape)
            if data.device.type == "cpu" and data.numel() == 1:
                scalar = int(data.reshape(()).to(torch.int64)) & M32
            elif data.device != dev:
                raise ValueError(f"threefry kernel fold: data on "
                                 f"{data.device}, keys on {dev}")
            else:
                if data.dtype not in _KINDS:
                    data = data.to(torch.int64)
                data = data.contiguous()
                kind = _KINDS[data.dtype]
        out_shape = torch.broadcast_shapes(tuple(keys.shape[:-1]), shape)
        n = math.prod(out_shape)
        n_keys = keys.numel() // 2
        n_data = data.numel() if kind != SCALAR else 1
        if n_keys not in (1, n) or n_data not in (1, n):
            raise ValueError(
                f"threefry kernel fold: keys {tuple(keys.shape)} and data "
                f"{shape} must each hold one element or one an output key "
                f"of {tuple(out_shape)}")
        out = torch.empty(out_shape + (2,), dtype=torch.int64, device=dev)
        if n == 0:
            return out
        if kind != SCALAR:
            ptr, step = data.data_ptr(), int(n_data > 1)
        err = self.lib.load()(
            keys.data_ptr(), int(n_keys > 1), ptr, kind, step, scalar,
            out.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
        self._launched(err, "fold")
        return out

    def uniform(self, keys: torch.Tensor, cols: int) -> torch.Tensor:
        """``uniform_lanes(keys, cols)``: keys [N, 2] -> float32 [N, cols],
        row l the uniforms of the counters (0, c), c < cols, under key l."""
        keys = _keys("uniform", keys)
        cols = int(cols)
        n = keys.shape[0]
        if keys.dim() != 2 or cols < 0 or n * cols > M32:
            raise ValueError(f"threefry kernel uniform: wants keys [N, 2] "
                             f"and 0 <= N * cols < 2^32, got "
                             f"{tuple(keys.shape)} and {cols}")
        out = torch.empty((n, cols), dtype=torch.float32, device=keys.device)
        if out.numel() == 0:
            return out
        fn = self.lib.function(
            "threefry_uniform_launch",
            [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_void_p])
        err = fn(keys.data_ptr(), n, cols, out.data_ptr(),
                 torch.cuda.current_stream(keys.device).cuda_stream)
        self._launched(err, "uniform")
        return out


threefry_kernel = ThreefryKernel()
