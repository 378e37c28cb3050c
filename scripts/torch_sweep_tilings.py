"""The sweep kernel on chip_smoke.py's phase-4 chunk (the first 65,536
coherence-sorted camera rays of the 1M-triangle mesh_heavy frame, 256^2)
at several (group, block) tilings, for this checkout or another checkout
of the port, so that one call on the card can time two versions.

    python scripts/torch_sweep_tilings.py [--root DIR] [--tilings 8x32,64x128]

Imports trace_tpu_torch from DIR (default: this checkout), e.g. the
parent commit unpacked with ``git archive`` into a git-ignored directory;
a version whose kernel serves only blocks of 32 rays takes ``--tilings
8x32``. For each tiling, f32 and certified: the kernel's ms as CUDA events
around 10 launches (chip_smoke.cuda_ms) and as 10 launches replayed in one
CUDA graph (chip_smoke.graph_ms), and its results against sweep_plain,
bit for bit. Group 64 regroups the group-8 tables (chip_smoke's
regroup_tables). Prints one JSON line. Needs a CUDA device; the timers
are chip_smoke.py's, from this checkout.
"""
import argparse
import importlib
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--tilings", default="8x32,8x128,8x512,64x128")
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
    TS.sweep_kernel.lib.load()
    scene = mods["models.mesh_heavy"].build_scene(1_000_000, device=dev)
    acc = scene.accel
    cam = mods["models.mesh_heavy"].build_camera(256, "unused.png")
    integ = mods["integrators.whitted"].WhittedIntegrator(
        cam, mods["sampler.uniform"].UniformSampler(1, seed=0), max_depth=2,
        pixel_chunk=cs.ONE_CHUNK)
    o, d, tm, _ = cs.record_calls(integ, scene)[0]
    perm = acc.coherence_order(o, d, tm)
    o, d, tm = (x[perm][:acc.ray_chunk] for x in (o, d, tm))
    out = dict(root=root, card=cs.smi(), rows={})
    for tiling in a.tilings.split(","):
        g, b = (int(x) for x in tiling.split("x"))
        tb = acc.tables if g == 8 else cs.regroup_tables(acc.tables, g // 8)
        panel = TS.panel_tensor(tb.panel, dev)
        args = TS.SweepAccelerator(tb, dev, block_rays=b).prologue(o, d, tm)
        for cert in (False, True):
            kt, ki = TS.sweep_kernel(*args, panel, b, False, certified=cert)
            pt, pi = TS.sweep_plain(*args, panel, b, False, certified=cert)
            torch.cuda.synchronize()

            def run():
                TS.sweep_kernel(*args, panel, b, False, certified=cert)

            out["rows"][f"{tiling}_{'certified' if cert else 'f32'}"] = dict(
                cuda_ms=cs.cuda_ms(run, 10), graph_ms=cs.graph_ms(run, 10),
                equal=bool(torch.equal(kt, pt) and torch.equal(ki, pi)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
