"""The sync-free mode of the render path.

A few places on the path read a device value on the host to save work:
an early exit once no lane is live, the sweep skipping the ray chunks
that hold no live lane. Under :func:`no_host_reads` they take their
static route instead -- every depth, every chunk -- which gives the same
values, so that a block of work is issued without a host round trip and
a CUDA graph can capture it (integrators/sppm.py's fused blocks). The
fused blocks on the card refuse the scenes whose intersection reads the
host with no static route (integrators/fused.py).

:func:`device_constant` holds the small constant tables the path builds
from host values: made once per device (a fused block's eager warm-up
makes them), since a host copy inside a capture would fail.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_SYNC_FREE = contextvars.ContextVar("sync_free", default=False)
_CONSTANTS = {}


def sync_free() -> bool:
    """Whether the caller is inside :func:`no_host_reads`."""
    return _SYNC_FREE.get()


@contextlib.contextmanager
def no_host_reads():
    """Run the render path on its static routes (module docstring)."""
    token = _SYNC_FREE.set(True)
    try:
        yield
    finally:
        _SYNC_FREE.reset(token)


def device_constant(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device) and shared: callers must not write to it.
    ``values`` is a number or a (nested) tuple of numbers."""
    key = (values, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype,
                                           device=device)
    return t
