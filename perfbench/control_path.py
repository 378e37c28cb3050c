"""The control of the path-traced cells' ``correct``: the cell run with
every BSDF sample's direction rounded to bfloat16 (the continuation's and
the MIS leg's), which the check has to call wrong.

    python3 perfbench/control_path.py --workload cornell_mis_512 \
        --seeds 1 2 3

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


def wi_bf16(scene):
    """Round the direction of every ``shade.sample_f`` result to bfloat16
    (its f and pdf stay those of the float32 direction); -> the undo."""
    import torch

    from trace_tpu_torch.core.vec import V3
    from trace_tpu_torch.wavefront import shade as S

    sample_f = S.sample_f

    def rounded(*a, **k):
        bs = sample_f(*a, **k)
        r = lambda x: x.to(torch.bfloat16).to(x.dtype)
        return bs._replace(wi=V3(r(bs.wi.x), r(bs.wi.y), r(bs.wi.z)))

    S.sample_f = rounded

    def undo():
        S.sample_f = sample_f
    return undo


CONTROLS = {"wi_bf16": wi_bf16}


def run_control(spec, seed: int, control: str, device: str):
    """-> (result, [(name, value, limit)]) of the cell under the control."""
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
    ap.add_argument("--control", default="wi_bf16", choices=CONTROLS)
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
