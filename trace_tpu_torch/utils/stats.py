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
    in the trace. ``path`` is the trace file after the block."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
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
        self._prof.__exit__(exc_type, exc, tb)
        if exc_type is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self.path = os.path.join(self.log_dir, "trace.json")
            self._prof.export_chrome_trace(self.path)
        return False
