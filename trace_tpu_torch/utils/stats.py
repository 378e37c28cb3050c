"""Structured per-pass render statistics (port of
trace_tpu/utils/stats.py).

Counters are host-side: integrators add statically known lane counts and
the few scalars they read anyway (the SPPM pair total). The timers
synchronise the card before they read the clock, so a timed span holds
the device work it enqueued, not only the enqueue.
"""
from __future__ import annotations

import time

import torch


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


class trace_profile:
    """A ``torch.profiler`` capture around a block, written as a
    Chrome/Perfetto trace (``<log_dir>/trace.json``, viewable at
    ui.perfetto.dev):

        with trace_profile("/tmp/trace"):
            integ.render(scene)

    It records the CPU, and CUDA where the card is in use; the card is
    synchronised before the capture stops, so work still in flight lands
    in the trace. ``barrier_args`` (the JAX package's block-until-ready
    barrier): tensors, or tuples, lists, dicts or NamedTuples of them,
    whose work must land in the trace too; on exit each CUDA device that
    holds one is synchronised as well (the current card always is, so on
    one card they add nothing). ``path`` is the trace file after the
    block."""

    def __init__(self, log_dir: str, *barrier_args):
        self.log_dir = log_dir
        self.barrier_args = barrier_args
        self.path = None
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        import os

        _sync()
        if exc_type is None:
            for dev in _cuda_devices(self.barrier_args):
                torch.cuda.synchronize(dev)
        self._prof.__exit__(exc_type, exc, tb)
        if exc_type is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self.path = os.path.join(self.log_dir, "trace.json")
            self._prof.export_chrome_trace(self.path)
        return False
