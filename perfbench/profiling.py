"""The traced run's profile: a few whole steps under torch.profiler, kept
in memory (no trace file), reduced to device activity, host operations
and step windows; the breakdown of the result line.

Two passes. The metrics' pass records the card's activity alone, which
costs the host little, so the steps run at their untraced pace; its
window is the steps' length on the host clock. A second pass of one step
records host operations too, only to say what the host was doing in the
card's idle gaps. Times are microseconds; a device event is a kernel, a
copy or a set on the card; user annotations are left out."""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

STEP = "perfbench.step"
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def _union(intervals) -> float:
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


@dataclass
class Trace:
    """Reduced profile. ``device`` and ``host``: lists of (name, start,
    end); ``steps``: (start, end) of each profiled step on the profiler's
    clock, where host operations were recorded (else empty); ``n_steps``
    and ``window``: the steps and their length on the host clock (us);
    ``phase_ms``: per phase name, the CUDA-event milliseconds of each
    step."""
    device: list
    host: list
    steps: list
    n_steps: int = 0
    window: float = 0.0
    phase_ms: dict = field(default_factory=dict)

    def kernels(self):
        return [e for e in self.device if not e[0].startswith(NOT_KERNELS)]

    def in_steps(self, events):
        """The events that start inside a step window (all of them where
        the pass kept no windows: it profiled the steps alone)."""
        if not self.steps:
            return list(events)
        starts = [s for s, _ in self.steps]
        out = []
        for e in events:
            i = bisect.bisect_right(starts, e[1]) - 1
            if i >= 0 and e[1] <= self.steps[i][1]:
                out.append(e)
        return out

    def window_us(self) -> float:
        return self.window or float(sum(e - s for s, e in self.steps))

    def busy_us(self) -> float:
        """The union of device activity (clipped to the step windows
        where there are some)."""
        if not self.steps:
            return _union((a, b) for _, a, b in self.device)
        return sum(_union((max(a, s), min(b, e)) for _, a, b in self.device
                          if b > s and a < e) for s, e in self.steps)

    def idle_gaps(self):
        """(start, end) of each stretch of a step window with no device
        activity."""
        gaps = []
        for s, e in self.steps:
            iv = sorted((max(a, s), min(b, e)) for _, a, b in self.device
                        if b > s and a < e)
            cur = s
            for a, b in iv:
                if a > cur:
                    gaps.append((cur, a))
                cur = max(cur, b)
            if e > cur:
                gaps.append((cur, e))
        return gaps

    def top_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        ops = {}
        for name, a, b in self.in_steps(self.device):
            ops[name[:120]] = ops.get(name[:120], 0.0) + (b - a) * 1e-6
        return _largest(ops, top)

    def gap_causes(self, top: int = 10) -> list:
        """[[name, seconds]]: the idle gaps summed by the innermost host
        operation running at their middle ("python" where none was)."""
        host = sorted((a, b, n) for n, a, b in self.host)
        starts = [h[0] for h in host]
        gaps = {}
        for a, b in self.idle_gaps():
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            name = "python"
            for j in range(i, max(i - 64, -1), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            gaps[name[:120]] = gaps.get(name[:120], 0.0) + (b - a) * 1e-6
        return _largest(gaps, top)


def _largest(d: dict, top: int) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]


def profile_steps(step, n: int, host: bool = False) -> Trace:
    """Run ``step`` n times under torch.profiler: the card's activity, and
    with ``host`` the host's operations and each step's window too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    window = 0.0
    with profile(activities=acts, record_shapes=False,
                 with_stack=False) as prof:
        for _ in range(n):
            t0 = time.perf_counter()
            with record_function(STEP):
                step()
                torch.cuda.synchronize()
            window += (time.perf_counter() - t0) * 1e6
    device, ops, steps = [], [], []
    for ev in prof.events():
        rng = (float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            if ev.name != STEP and not getattr(ev, "is_user_annotation",
                                               False):
                device.append((ev.name, *rng))
        elif ev.name == STEP:
            steps.append(rng)
        else:
            ops.append((ev.name, *rng))
    steps.sort()
    return Trace(device=device, host=ops, steps=steps if host else [],
                 n_steps=n, window=window)
