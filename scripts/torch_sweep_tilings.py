"""The sweep kernel on chip_smoke.py's phase-4 chunk (the first 65,536
coherence-sorted camera rays of the 1M-triangle mesh_heavy frame, 256^2)
at several (group, block) tilings, for this checkout or another checkout
of the port, so that one call on the card can time two versions.

    python scripts/torch_sweep_tilings.py [--root DIR] \
        [--tilings 8x32,8x128,8x512,64x128,64x128c8192,64x128h8192] \
        [--kernels NAME=SOURCE ...]

Imports trace_tpu_torch from DIR (default: this checkout), e.g. the
parent commit unpacked with ``git archive`` into a git-ignored directory;
a version whose kernel serves only blocks of 32 rays takes ``--tilings
8x32``. A tiling ``GxBcN`` times the chunk's first N rays and ``GxBhN``
its first N that hit the mesh (``64x128c8192`` and ``64x128h8192``: bench
config 6's launch shape, 64 blocks of 128 rays; the chunk's first rays
enter no super). For each tiling, f32 and certified: the kernel's ms as 10
launches replayed in one CUDA graph (chip_smoke.graph_ms), and its
results against sweep_plain (t, slot and steps), bit for bit. Group 64
regroups the group-8 tables (chip_smoke's regroup_tables).

``--kernels`` times several builds of the sweep's C interface in this one
process on the same inputs, in turns (each tiling: the kernels in order,
then in reverse): SOURCE is a .cu file with sweep.cu's ``sweep_launch``
(e.g. the parent's csrc/sweep.cu), or ``OLD=>NEW`` -- this checkout's
sweep.cu with the line OLD replaced by NEW (e.g. ``constexpr int kStages
= 3;=>constexpr int kStages = 2;``; several such pairs joined by " | ").
The copies build in parallel under the git-ignored
trace_tpu_torch/build/. Prints one JSON line. Needs a CUDA device; the
timers are chip_smoke.py's, from this checkout.
"""
import argparse
import importlib
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def kernel_from(TS, name, spec):
    """A SweepKernel bound to ``spec``: a .cu path, or OLD=>NEW applied to
    this build's sweep.cu."""
    from trace_tpu_torch.ops import nvcc

    k = TS.SweepKernel()
    if "=>" in spec:
        with open(k.lib.source) as f:
            src = f.read()
        for pair in spec.split(" | "):
            old, new = pair.split("=>", 1)
            if old not in src:
                raise RuntimeError(f"sweep.cu has no line {old!r}")
            src = src.replace(old, new)
    else:
        with open(spec) as f:
            src = f.read()
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    k.lib.source = os.path.join(nvcc.BUILD_DIR, f"sweep_{name}.cu")
    k.lib.path = os.path.join(nvcc.BUILD_DIR, f"libsweep_{name}.so")
    with open(k.lib.source, "w") as f:
        f.write(src)
    return k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--tilings", default="8x32,8x128,8x512,64x128,"
                    "64x128c8192,64x128h8192")
    ap.add_argument("--kernels", nargs="*", default=[])
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_tilings: needs a CUDA device", file=sys.stderr)
        return 2
    mods = {m: importlib.import_module(f"trace_tpu_torch.{m}") for m in (
        "integrators.whitted", "models.mesh_heavy", "ops.sweep",
        "sampler.uniform")}
    TS = mods["ops.sweep"]
    if not TS.__file__.startswith(root):
        raise RuntimeError(f"trace_tpu_torch did not come from {root}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels = {"root": TS.sweep_kernel}
    for item in a.kernels:
        name, spec = item.split("=", 1)
        kernels[name] = kernel_from(TS, name, spec)
    with ThreadPoolExecutor() as ex:   # nvcc runs outside the GIL
        list(ex.map(lambda k: k.lib.load(), kernels.values()))
    out = dict(root=root, card=cs.smi(), ptxas={
        n: cs.ptxas_summary(k.lib.build_log) for n, k in kernels.items()},
        rows={})
    scene = mods["models.mesh_heavy"].build_scene(1_000_000, device=dev)
    acc = scene.accel
    cam = mods["models.mesh_heavy"].build_camera(256, "unused.png")
    integ = mods["integrators.whitted"].WhittedIntegrator(
        cam, mods["sampler.uniform"].UniformSampler(1, seed=0), max_depth=2,
        pixel_chunk=cs.ONE_CHUNK)
    o, d, tm, _ = cs.record_calls(integ, scene)[0]
    perm = acc.coherence_order(o, d, tm)
    o, d, tm = (x[perm][:acc.ray_chunk] for x in (o, d, tm))
    hit = TS.SweepAccelerator(acc.tables, dev, sort_rays=False).intersect(
        o, d, tm, False)[0]
    for tiling in a.tilings.split(","):
        g, rest = tiling.split("x")
        b, cut = rest, ""
        for c in "ch":
            if c in rest:
                b, n = rest.split(c)
                cut = c + n
        g, b = int(g), int(b)
        sel = cs.cut_rays(cut, hit)
        tb = acc.tables if g == 8 else cs.regroup_tables(acc.tables, g // 8)
        panel = TS.panel_tensor(tb.panel, dev)
        args = TS.SweepAccelerator(tb, dev, block_rays=b).prologue(
            o[sel], d[sel], tm[sel])
        for cert in (False, True):
            pt, pi, ps = TS.sweep_plain(*args, panel, b, False,
                                        certified=cert, collect_stats=True)
            row = {}
            order = list(kernels) + list(kernels)[::-1]
            for i, name in enumerate(order):
                k = kernels[name]

                def run():
                    k(*args, panel, b, False, certified=cert)

                if i < len(kernels):
                    kt, ki, ks = k(*args, panel, b, False, certified=cert,
                                   collect_stats=True)
                    torch.cuda.synchronize()
                    row[name] = dict(equal=bool(
                        torch.equal(kt, pt) and torch.equal(ki, pi)
                        and torch.equal(ks, ps)), graph_ms=[])
                row[name]["graph_ms"].append(cs.graph_ms(run, a.reps))
            row["steps"] = int(ps.sum())
            row["bound_ms"], row["bound_by"] = cs.sweep_bound(
                args, ps, panel, b, cert)
            out["rows"][f"{tiling}_{'certified' if cert else 'f32'}"] = row
            print(json.dumps({tiling: row}), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
