"""The sync-free mode of the render path.

A few places on the path read a device value on the host to save work:
an early exit once no lane is live, the sweep skipping the ray chunks
that hold no live lane. Under :func:`no_host_reads` they take their
static route instead -- every depth, every chunk -- which gives the same
values, so that a block of work is issued without a host round trip and
a CUDA graph can capture it (integrators/sppm.py's fused blocks). The
fused blocks on the card refuse the scenes whose intersection reads the
host with no static route (integrators/fused.py). A run's
:class:`StaticRoute` carries what the static routes share with the
caller: the instance walks' pair buffer sizes, and the candidate pair
counts they saw (accel/instances.py).

:func:`device_constant` holds the small constant tables the path builds
from host values: made once per device (a fused block's eager warm-up
makes them), since a host copy inside a capture would fail.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

_ROUTE = contextvars.ContextVar("static_route", default=None)
_CONSTANTS = {}


class StaticRoute:
    """One sync-free run's instance walk settings and reports.
    ``capacity``: pair buffer size per instanced geometry (a geometry
    not in it takes the walk's bound, which no count exceeds); ``counts``:
    per geometry, the candidate pair count of each group walked (device
    scalars, in walk order)."""

    def __init__(self, capacity: dict | None = None):
        self.capacity = dict(capacity or {})
        self.counts = {}


def sync_free() -> bool:
    """Whether the caller is inside :func:`no_host_reads`."""
    return _ROUTE.get() is not None


def static_route() -> StaticRoute | None:
    """The :class:`StaticRoute` of the enclosing :func:`no_host_reads`."""
    return _ROUTE.get()


@contextlib.contextmanager
def no_host_reads(route: StaticRoute | None = None):
    """Run the render path on its static routes (module docstring), with
    ``route`` (a fresh one if None) as their :class:`StaticRoute`."""
    token = _ROUTE.set(route if route is not None else StaticRoute())
    try:
        yield
    finally:
        _ROUTE.reset(token)


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
