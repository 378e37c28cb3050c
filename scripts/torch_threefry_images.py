"""The benchmark cells' Whitted frame, fused SPPM iteration and path-traced
frame, rendered by a checkout's port, digested so that two checkouts can
be held bit-equal.

    python scripts/torch_threefry_images.py [--root DIR] [--seed 1234] \
        [--steps 3] [--out digests.json]

Imports trace_tpu_torch from DIR (default: this checkout), e.g. an older
commit unpacked with ``git archive`` into a git-ignored directory, and
builds the cells through this checkout's ``perfbench`` drivers (their
scene, camera and integrator from the configuration and the traffic
files, with no warm step): ``mesh1m_whitted_256`` (1M-triangle
heightfield, 256^2, Whitted depth 2) and ``mesh1m_sppm_1024_fused``
(1024^2, 2^18 photons, depth 8, one iteration a fused block) and
``cornell_mis_512`` (the Cornell box, 512^2, 4 spp, depth 5). Each cell
runs ``--steps`` steps: on a route with a CUDA graph the first runs its
body eagerly, the second captures the graph, the rest replay it. Per
step: the host ms, a SHA-256 of every tensor of the step's state (the
film's sums; SPPM's state), and the port's Threefry kernel launches where
the checkout has that kernel. One JSON line on stdout, also written to
``--out``. Needs a CUDA device.
"""
import argparse
import hashlib
import importlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("mesh1m_whitted_256", "mesh1m_sppm_1024_fused",
         "cornell_mis_512")


def digest(state) -> dict:
    """SHA-256 of the bytes of each tensor field of a state (the film's
    FilmState, SPPM's SPPMState)."""
    import dataclasses

    import torch

    names = state._fields if hasattr(state, "_fields") else [
        f.name for f in dataclasses.fields(state)]
    return {n: hashlib.sha256(getattr(state, n).cpu().numpy().tobytes())
            .hexdigest() for n in names
            if torch.is_tensor(getattr(state, n))}


def render(cell: str, seed: int, steps: int) -> dict:
    import torch

    from perfbench.harness import CellSpec

    spec = CellSpec(REPO, cell)
    traffic = dict(spec.traffic, warm_steps=0)
    run = spec.driver().Cell(spec.config, traffic, seed, "cuda")
    run.setup()
    try:
        tf = importlib.import_module(
            "trace_tpu_torch.ops.threefry").threefry_kernel
    except ImportError:
        tf = None
    rows = []
    for _ in range(steps):
        before = tf.launches if tf is not None else None
        t0 = time.perf_counter()
        run.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"ms": ms, "digest": digest(run.state),
                     "threefry_launches": None if tf is None
                     else tf.launches - before})
    run.release()
    torch.cuda.empty_cache()
    return {"steps": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, REPO)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_threefry_images: needs a CUDA device", file=sys.stderr)
        return 2
    mod = importlib.import_module("trace_tpu_torch")
    if not mod.__file__.startswith(root):
        raise RuntimeError(f"trace_tpu_torch did not come from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"root": root, "seed": a.seed,
           "device": torch.cuda.get_device_name(0),
           "cells": {c: render(c, a.seed, a.steps) for c in CELLS}}
    line = json.dumps(res)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
