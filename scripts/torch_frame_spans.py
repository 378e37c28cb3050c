"""A benchmark cell's frames by program span, on the card.

    python scripts/torch_frame_spans.py [--cell mesh1m_whitted_256] \
        [--seed 1] [--frames 10] [--steps 3] [--out spans.json]

Builds the cell from perfbench's files, as ``perfbench/run.py`` does; its
warm frames leave a Whitted or path-tracing cell's view captured as a CUDA
graph. The replay is read first: ``--frames`` frames with tracing off,
then ``--steps`` under torch.profiler (device ms, kernels and idle ms a
frame), and the capture's record (capture ms, launches by kernel
wrapper). Then the integrator's ``frame_graph`` is set False on the
instance, the eager route, so that every pass is issued from the host
inside its span and the table stays pass by pass (a replay is one
``whitted.replay`` or ``path.replay`` span), and the rest reads eager
frames: ``--frames`` frames with tracing off (host clock, each
ending in a synchronise); four passes of ``--steps`` frames under
torch.profiler (CPU and CUDA activity), with spans off and on (inside
``trace_tpu_torch.utils.stats.collect()``) in turn; the last is read.
Each device event is given to the innermost program span open when its
launch (the CUDA runtime event with the same correlation id) was issued;
each idle gap of the card to the innermost span open at its middle.
Prints one JSON line: per span name and step, calls, host ms, self host
ms, kernels, device ms and idle ms; the counters; what the spans and
counters read (lane use of the chunks and of the sweep launches, host
reads and their wait, also by the span that reads, device ms launched
inside ``intersect`` and ``film.splat``, the gather kernel's splats a
frame); the host window of each pass;
the cost of a span off and on; the card's name and power limit; for a
path-tracing cell, ``path_self_hits`` of one more frame (the integrator's
own ``stats``) on the port's continuation rule and on the JAX package's
(1e-6 along the new direction). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NONE = "(none)"
NOT_KERNELS = ("Memcpy", "Memset")
STEP = "frame_spans.step"


def nesting(spans):
    """spans: [(name, start, end)] on one thread. -> (parent index or
    None per span, segment starts, innermost span index or None per
    segment): the innermost span open at t is
    ``labels[bisect_right(starts, t) - 1]``."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1],
                                                     -spans[i][2]))
    edges = sorted([(spans[i][2], 0, i) for i in order]
                   + [(spans[i][1], 1, k, i) for k, i in enumerate(order)])
    parent = [None] * len(spans)
    stack, starts, labels = [], [float("-inf")], [None]
    for e in edges:
        i = e[-1]
        if e[1]:
            parent[i] = stack[-1] if stack else None
            stack.append(i)
        else:
            stack.remove(i)
        starts.append(e[0])
        labels.append(stack[-1] if stack else None)
    return parent, starts, labels


def idle_gaps(device, steps):
    """(start, end) of each stretch of a step window with nothing on the
    card."""
    gaps = []
    for s, e in steps:
        cur = s
        for a, b in sorted((max(a, s), min(b, e)) for _, a, b, _ in device
                           if b > s and a < e):
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if e > cur:
            gaps.append((cur, e))
    return gaps


def span_table(spans, device, launches, steps):
    """spans: [(name, start, end)] program spans (host, us); device:
    [(name, start, end, correlation id)]; launches: correlation id ->
    host start of its runtime call; steps: [(start, end)] windows. ->
    (rows: name -> per-step calls, host_ms, self_ms, kernels (copies and
    sets left out), device_ms, idle_ms, each device event and gap counted
    once, at its innermost span; within: name -> device ms a step of the events launched inside
    a span of that name at any depth)."""
    n = max(len(steps), 1)
    parent, starts, labels = nesting(spans)
    at = lambda t: labels[bisect.bisect_right(starts, t) - 1]
    rows = {}

    def row(i):
        name = NONE if i is None else spans[i][0]
        return rows.setdefault(name, dict.fromkeys(
            ("calls", "host_ms", "self_ms", "kernels", "device_ms",
             "idle_ms"), 0.0))

    child_us = [0.0] * len(spans)
    for i, p in enumerate(parent):
        if p is not None:
            child_us[p] += spans[i][2] - spans[i][1]
    for i, (_, a, b) in enumerate(spans):
        r = row(i)
        r["calls"] += 1 / n
        r["host_ms"] += (b - a) * 1e-3 / n
        r["self_ms"] += (b - a - child_us[i]) * 1e-3 / n
    within = {}
    for name, a, b, corr in device:
        i = at(launches[corr]) if corr in launches else None
        r = row(i)
        r["kernels"] += (not name.startswith(NOT_KERNELS)) / n
        r["device_ms"] += (b - a) * 1e-3 / n
        seen = set()
        while i is not None:
            name = spans[i][0]
            if name not in seen:
                seen.add(name)
                within[name] = within.get(name, 0.0) + (b - a) * 1e-3 / n
            i = parent[i]
    for a, b in idle_gaps(device, steps):
        row(at(0.5 * (a + b)))["idle_ms"] += (b - a) * 1e-3 / n
    return rows, within


def readings(rows, within, counters, n_steps):
    """What the spans and counters read, as the metrics of PERF.md §3
    define them (None where nothing was recorded)."""
    ratio = lambda a, b: (100.0 * counters[a] / counters[b]
                          if counters.get(b) and a in counters else None)
    reads = rows.get("host_read", {})
    return {
        "chunk_lane_use_pct": ratio("chunk_lanes_valid",
                                    "chunk_lanes_issued"),
        "host_reads_per_step": reads.get("calls"),
        "host_read_wait_ms_per_step": reads.get("host_ms"),
        "intersect_call_ms_per_step": within.get("intersect"),
        "sweep_lane_use_pct": ratio("sweep_lanes_live",
                                    "sweep_lanes_launched"),
        "film_splat_ms_per_step": within.get("film.splat"),
        "sweep_launches_per_step": (counters["sweep_launches"] / n_steps
                                    if "sweep_launches" in counters
                                    else None),
        "film_splat_gathers_per_step": (
            counters["film_splat_gathers"] / n_steps
            if "film_splat_gathers" in counters else None),
    }


def profile(step, n: int, spans_on: bool):
    """n steps under torch.profiler -> (spans, device, launches, steps,
    counters, host window us)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    from trace_tpu_torch.utils.stats import collect

    torch.cuda.synchronize()
    window = 0.0
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with collect() if spans_on else contextlib.nullcontext() as stats:
            for _ in range(n):
                t0 = time.perf_counter()
                with record_function(STEP):
                    step()
                    torch.cuda.synchronize()
                window += (time.perf_counter() - t0) * 1e6
    spans, device, launches, steps = [], [], {}, []
    for ev in prof.events():
        rng = (float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                device.append((ev.name, *rng, ev.id))
        elif ev.name == STEP:
            steps.append(rng)
        elif ev.name.startswith("tt."):
            spans.append((ev.name[3:], *rng))
        elif ev.name.startswith("cu"):
            launches[ev.id] = rng[0]
    return (spans, device, launches, sorted(steps),
            stats.as_dict() if spans_on else {}, window)


def span_cost_ns(calls: int = 200_000) -> dict:
    """Host ns a ``with span(...)`` costs, spans off and on (no
    profiler running)."""
    from trace_tpu_torch.utils.stats import collect, span

    def loop():
        t0 = time.perf_counter()
        for _ in range(calls):
            with span("x"):
                pass
        return (time.perf_counter() - t0) * 1e9 / calls

    off = loop()
    with collect():
        on = loop()
    return {"off": off, "on": on}


def path_self_hits(cell) -> dict:
    """Continuations that re-met the primitive they left, in one frame of
    a path-tracing cell, on each continuation rule."""
    from trace_tpu_torch.core.ray import SPAWN_EPS
    from trace_tpu_torch.utils.stats import RenderStats
    from trace_tpu_torch.wavefront import path as WP

    li = WP.li
    out = {}
    for rule, spawn in (("port", None),
                        ("along_wi", lambda p, n, wi: p + wi * SPAWN_EPS)):
        cell.integ.stats = RenderStats()
        if spawn is not None:
            WP.li = functools.partial(li, spawn=spawn)
        try:
            cell.step()
        finally:
            WP.li = li
        out[rule] = cell.integ.stats.as_dict()["path_self_hits"]
    cell.integ.stats = None
    return out


def frames(cell, n: int) -> list:
    """Host ms of ``n`` steps with tracing off, each ending in a
    synchronise."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        cell.step()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def replay_reading(cell, graphs, n_frames: int, n_steps: int) -> dict:
    """The view's frame graph: untraced replays (host ms), then device
    ms, kernels and idle ms a replay under the profiler, and the capture
    records."""
    untraced = frames(cell, n_frames)
    _, device, _, steps, _, _ = profile(cell.step, n_steps, False)
    kernels = [e for e in device if not e[0].startswith(NOT_KERNELS)]
    return {
        "untraced_step_ms": untraced,
        "untraced_step_ms_median": statistics.median(untraced),
        "device_ms_per_step": sum(b - a for _, a, b, _ in device) * 1e-3
        / n_steps,
        "kernels_per_step": len(kernels) / n_steps,
        "idle_ms_per_step": sum(b - a for a, b in idle_gaps(device, steps))
        * 1e-3 / n_steps,
        "captures": graphs.captures,
    }


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", default="mesh1m_whitted_256")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from perfbench import harness
    from perfbench.metrics.intersect_ms_per_step import KERNELS

    if not torch.cuda.is_available():
        print("torch_frame_spans: needs a CUDA device", file=sys.stderr)
        return 2
    spec = harness.CellSpec(REPO, a.cell)
    cell = spec.driver().Cell(spec.config, spec.traffic, a.seed, "cuda")
    cell.setup()
    graphs = getattr(cell.integ, "frame_graphs", None)
    replay = None
    if graphs is not None and graphs.graphs:
        replay = replay_reading(cell, graphs, a.frames, a.steps)
        cell.integ.frame_graph = False
    untraced = frames(cell, a.frames)
    windows = {False: [], True: []}
    for on in (False, True, False, True):   # the last pass is kept
        spans, device, launches, steps, counters, window = profile(
            cell.step, a.steps, on)
        windows[on].append(window * 1e-3 / a.steps)
    rows, within = span_table(spans, device, launches, steps)
    n = a.steps
    parent, _, _ = nesting(spans)
    waits = {}
    for (name, t0, t1), p in zip(spans, parent):
        if name == "host_read":
            key = NONE if p is None else spans[p][0]
            waits[key] = waits.get(key, 0.0) + (t1 - t0) * 1e-3 / n
    kernels = [e for e in device if not e[0].startswith(NOT_KERNELS)]
    render_idle = sum(r["idle_ms"] for k, r in rows.items() if k != NONE)
    out = {
        "cell": a.cell, "seed": a.seed, "card": card(),
        "device": torch.cuda.get_device_name(0),
        "replay": replay,
        "untraced_step_ms": untraced,
        "untraced_step_ms_median": statistics.median(untraced),
        "profiled_spans_off_ms_per_step": windows[False],
        "profiled_spans_on_ms_per_step": windows[True],
        "span_cost_ns": span_cost_ns(),
        "readings": readings(rows, within, counters, n),
        "intersect_ms_per_step": sum(
            b - a for k, a, b, _ in kernels if KERNELS.search(k)) * 1e-3 / n,
        "kernels_per_step": len(kernels) / n,
        "device_events_unattributed": sum(1 for e in device
                                          if e[3] not in launches),
        "idle_ms_per_step": sum(b - a for a, b in idle_gaps(device, steps))
        * 1e-3 / n,
        "idle_below_render_share": (
            1 - rows.get("render", {}).get("idle_ms", 0.0) / render_idle
            if render_idle else None),
        "host_read_ms_by_parent": waits,
        "counters": counters,
        "spans": dict(sorted(rows.items(), key=lambda kv: -kv[1]["host_ms"])),
        "within_ms": within,
    }
    if spec.config["integrator"] == "path":
        out["path_self_hits"] = path_self_hits(cell)
    line = json.dumps(out)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
