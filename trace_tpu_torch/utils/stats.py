"""Structured per-pass render statistics (port of
trace_tpu/utils/stats.py), and the port's spans and counters.

Counters are host-side: integrators add statically known lane counts and
the few scalars they read anyway (the SPPM pair total). The timers
synchronise the card before they read the clock, so a timed span holds
the device work it enqueued, not only the enqueue.

Inside :func:`collect` the render path marks its passes and layers with
:func:`span` -- ``torch.profiler.record_function`` ranges named ``tt.<name>``,
on the profiler's clock beside the card's kernels -- and adds host numbers
with :func:`count` into the ambient :class:`RenderStats`. Spans nest by time
on the one host thread: a span's parent is the innermost span open around
it. Outside ``collect`` a span is one shared null context and a count does
nothing, so the path pays one context-variable lookup a site.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import time

import torch

_AMBIENT = contextvars.ContextVar("render_stats", default=None)
_NO_SPAN = contextlib.nullcontext()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a nest of tuples, lists and
    dicts."""
    if torch.is_tensor(tree):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*[_cuda_devices(x) for x in tree])
    return set()


class RenderStats:
    def __init__(self):
        self.counters: dict[str, float] = {}
        self._timers: dict[str, float] = {}

    def add(self, name: str, value) -> None:
        self.counters[name] = self.counters.get(name, 0) + float(value)

    def start(self, name: str) -> None:
        _sync()
        self._timers[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        if name in self._timers:
            _sync()
            self.add(f"{name}_seconds",
                     time.perf_counter() - self._timers.pop(name))

    def mrays_per_sec(self, rays_key: str = "rays_dispatched",
                      time_key: str = "render_seconds") -> float:
        t = self.counters.get(time_key, 0.0)
        return self.counters.get(rays_key, 0.0) / t / 1e6 if t else 0.0

    def as_dict(self) -> dict:
        return dict(self.counters)

    def __repr__(self):
        rows = ", ".join(f"{k}={v:.6g}"
                         for k, v in sorted(self.counters.items()))
        return f"RenderStats({rows})"


@contextlib.contextmanager
def collect(stats: RenderStats | None = None):
    """Turn spans on and make ``stats`` (a fresh RenderStats if None) the
    ambient counters for the block; yields it. An integrator's own
    ``stats=`` object is not the ambient one unless passed here."""
    stats = RenderStats() if stats is None else stats
    token = _AMBIENT.set(stats)
    try:
        yield stats
    finally:
        _AMBIENT.reset(token)


def span(name: str):
    """A context manager around one pass or layer call: inside
    :func:`collect`, ``torch.profiler.record_function("tt." + name)``;
    outside it, a shared null context (no record_function is made)."""
    if _AMBIENT.get() is None:
        return _NO_SPAN
    return torch.profiler.record_function("tt." + name)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``.
    The wrapper holds the call's arguments until it returns, so a function
    that rebinds a large argument to free it early (ops/sweep.py's
    ``intersect``) opens the span in its body instead."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n) -> None:
    """Add the host number ``n`` to counter ``name`` of the ambient
    RenderStats (nothing outside :func:`collect`). A tensor is refused:
    reading it would wait on the card."""
    if torch.is_tensor(n):
        raise TypeError(f"count({name!r}): a host number, not a tensor")
    stats = _AMBIENT.get()
    if stats is not None:
        stats.add(name, n)


class trace_profile:
    """A ``torch.profiler`` capture around a block, written as a
    Chrome/Perfetto trace (``<log_dir>/trace.json``, viewable at
    ui.perfetto.dev):

        with trace_profile("/tmp/trace"):
            integ.render(scene)

    It records the CPU, and CUDA where the card is in use; the card is
    synchronised before the capture stops, so work still in flight lands
    in the trace. The block runs inside :func:`collect`, so the trace shows
    the port's spans (``tt.render``, ``tt.intersect``, ...) and ``stats``
    holds the counters they add. ``barrier_args`` (the JAX package's
    block-until-ready barrier): tensors, or tuples, lists, dicts or
    NamedTuples of them, whose work must land in the trace too; on exit
    each CUDA device that holds one is synchronised as well (the current
    card always is, so on one card they add nothing). ``path`` is the
    trace file after the block."""

    def __init__(self, log_dir: str, *barrier_args):
        self.log_dir = log_dir
        self.barrier_args = barrier_args
        self.path = None
        self.stats = None
        self._prof = None
        self._stack = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        self._stack = contextlib.ExitStack()
        self.stats = self._stack.enter_context(collect())
        self._prof = self._stack.enter_context(profile(activities=acts))
        return self

    def __exit__(self, exc_type, exc, tb):
        import os

        _sync()
        if exc_type is None:
            for dev in _cuda_devices(self.barrier_args):
                torch.cuda.synchronize(dev)
        self._stack.__exit__(exc_type, exc, tb)
        if exc_type is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self.path = os.path.join(self.log_dir, "trace.json")
            self._prof.export_chrome_trace(self.path)
        return False
