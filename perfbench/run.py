"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up builds the cell's scene from the
benchmark's own files and warms up the cell's shapes; then either the
cell's steps run back to back for ``--seconds`` (``--trace 0``: the
end-to-end metrics) or a few whole steps run under the profiler
(``--trace 1``: the per-layer metrics). Then the output of the timed path
is judged against the plain reference (reference/), and the compared
numbers go to standard error and, under "checks", to the result line.
Exits 2 without a CUDA device (or fewer than the cell asks for), 3 if
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".perfbench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Kernel caches at fixed paths inside the checkout (the port builds its
    # own under trace_tpu_torch/build/).
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    # Python's own bytecode cache, in the checkout: where the environment
    # turns bytecode writing off, every run compiles torch's modules again.
    sys.pycache_prefix = os.path.join(CACHE, "pycache")
    sys.dont_write_bytecode = False
    sys.path.insert(0, ROOT)
    from perfbench import harness

    spec = harness.CellSpec(ROOT, args.workload)
    import torch

    t_torch = time.perf_counter()

    chips = int(spec.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: needs {chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    result, checks, found = harness.run(spec, args.seed, args.seconds,
                                        bool(args.trace), "cuda", T_START)
    result["setup_parts"] = {"start_and_torch": t_torch - T_START,
                             **result["setup_parts"]}
    result["checks"] = result.pop("checks")
    found = sorted(set(found) | set(harness.forbidden_modules(sys.modules)))
    if found:
        print(f"perfbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("setup parts: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in result["setup_parts"].items()),
        file=sys.stderr)
    if "host" in result:
        result["host"]["torch_threads"] = torch.get_num_threads()
        print("host: " + json.dumps(result["host"]), file=sys.stderr)
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
