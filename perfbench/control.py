"""The controls of ``correct``: a cell run with the program's own
lower-precision path switched on, which the check has to call wrong.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3 \
        [--control panel_bf16]

Each seed: the cell's set-up with the control applied, its warm and one
more step, then the same check as a benchmark run; one JSON line a seed
with the compared numbers. The benchmark's own runs never apply a
control."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def panel_bf16(scene, tris) -> None:
    """The sweep over the same tables with the panel stored as bf16 (the
    port's ``panel_bf16`` arm) in place of the f32 panel."""
    from trace_tpu_torch import scene as scene_mod
    from trace_tpu_torch.ops import sweep as sw

    t = scene_mod.sweep_tables(scene.triangles_host)
    bf = sw.SweepTables.from_arrays(sw.cast_panel(t.panel, bf16=True),
                                    t.slot_to_tri, t.s_lo, t.s_hi)
    scene._set_geometry(scene.triangles, scene.sweep(bf))


CONTROLS = {"panel_bf16": panel_bf16}


def run_control(spec, seed: int, control: str, device: str) -> list:
    """-> [(name, value, limit)] of the cell under the control."""
    import torch

    from perfbench import harness

    cell = spec.driver().Cell(spec.config, spec.traffic, seed, device,
                              control=CONTROLS[control])
    result, checks, _ = harness.run(spec, seed, 0.0, False, device,
                                    time.perf_counter(), cell=cell)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default="panel_bf16", choices=CONTROLS)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import harness

    spec = harness.CellSpec(ROOT, args.workload)
    for seed in args.seeds:
        result, checks = run_control(spec, seed, args.control, "cuda")
        print(json.dumps({"seed": seed, "control": args.control,
                          "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
