"""One run of one cell: set-up, the measured window or the traced steps,
the check of what the timed path produced, and the result line.

Everything a cell is made of is found by name: its entry in
BENCHMARK.json, its configuration file (``configs/``), its traffic file
(``traffic/<traffic>.json``), its limits (``limits/<cell>.json``), the
driver of the configuration's integrator (``drivers/<integrator>.py``)
and each per-layer metric's reader (``metrics/<name up to its first
dot>.py``)."""
from __future__ import annotations

import gc
import importlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "trace_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


class CellSpec:
    """A cell's entries and files, found by its name."""

    def __init__(self, root: str, name: str, bench: dict | None = None):
        self.bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
        wl = {w["name"]: w for w in self.bench["workloads"]}
        if name not in wl:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = wl[name]
        cfgs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = cfgs[self.workload["config"]]
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            HERE, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(HERE, "limits", name + ".json"))
        self.name = name

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if name_in(self.name, m)]

    def per_layer(self):
        return [m for m in self.bench["per_layer"] if name_in(self.name, m)]

    def driver(self):
        return importlib.import_module(
            "perfbench.drivers." + self.config["integrator"])


def name_in(cell: str, metric: dict) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole (trace_tpu_torch is not trace_tpu)."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def quantile(values, q: float) -> float:
    """Linear-interpolated quantile (numpy's default)."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def host_sample() -> tuple:
    """(wall, this process's CPU, its main thread's CPU) seconds."""
    return (time.perf_counter(), time.process_time(), time.thread_time())


def host_report(a: tuple, b: tuple) -> dict:
    """The process's and its main thread's CPU time over the wall time
    between two samples: near 1 where one host thread sets the pace."""
    wall = max(b[0] - a[0], 1e-9)
    return {"proc_cpu_share": (b[1] - a[1]) / wall,
            "main_thread_cpu_share": (b[2] - a[2]) / wall}


def run(spec: CellSpec, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, cell=None) -> tuple:
    """-> (result dict, checks [(name, value, limit)], the forbidden modules
    loaded once the window closed). ``cell``: a driver cell built by the
    caller (the controls, tests), else the configuration's own."""
    import torch

    from . import profiling

    cuda = device.startswith("cuda")
    if cell is None:
        cell = spec.driver().Cell(spec.config, spec.traffic, seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell.setup()
    setup_s = time.perf_counter() - t_start

    durations = []
    tr = host = None
    if trace:
        n = int(spec.traffic["trace_steps"])
        with cell.phase_events() as phases:
            tr = profiling.profile_steps(cell.step, n) if cuda else \
                profiling.Trace([], [], [], n_steps=n)
        tr.phase_ms = phases
        gaps = profiling.profile_steps(cell.step, 1, host=True) if cuda \
            else tr
        attempted = n + (1 if cuda else 0)
    else:
        h0 = host_sample()
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            cell.step()
            b = time.perf_counter()
            durations.append(b - a)
            if b - t0 >= seconds:
                break
        window = b - t0
        attempted = len(durations)
        host = host_report(h0, host_sample())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules(list(sys.modules))
    out = cell.output()
    cell.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = cell.check(out, spec.limits)
    check_s = time.perf_counter() - t_check
    correct = all(v <= lim for _, v, lim in checks)

    metrics = {}
    if trace:
        for m in spec.per_layer():
            mod = importlib.import_module(
                "perfbench.metrics." + m["name"].split(".")[0])
            v = mod.read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        # A traffic mix's "family" suffixes its step metrics, so that cells
        # whose steps differ in kind (frames, fused blocks) hold bounds of
        # their own: step_ms.block.
        fam = spec.traffic.get("family")
        sfx = "." + fam if fam else ""
        values = {
            "step_ms" + sfx: 1e3 * window / attempted,
            "step_p90_ms" + sfx: 1e3 * quantile(durations, 0.9),
            "peak_device_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
        for m in spec.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted,
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_us() * 1e-6
        dev["window_s"] = tr.window_us() * 1e-6
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": gaps.gap_causes()}
    if host is not None:
        result["host"] = host
    result["setup_parts"] = dict(getattr(cell, "setup_marks", {}))
    result["check_s"] = check_s
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks, found


def dry_run(root: str, name: str, seed: int, seconds: float,
            trace: bool = False) -> dict:
    """The whole of a run on the CPU, without the look for a card (tests
    at small sizes): the cell's own files, set-up, window, check."""
    result, checks, found = run(CellSpec(root, name), seed, seconds, trace,
                                "cpu", time.perf_counter())
    result["forbidden_modules"] = found
    return result
