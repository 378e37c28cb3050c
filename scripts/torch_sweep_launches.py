"""Every sweep launch of the port's 1M-triangle frames, with the
prologue's time per chunk, and the frames themselves, for this checkout
or for another checkout of the port, so that one call on the card can
time two versions with the same code.

    python scripts/torch_sweep_launches.py [--root DIR] [--tris 1000000] \
        [--out launches.json]

Imports trace_tpu_torch from DIR (default: this checkout), e.g. an older
commit unpacked with ``git archive`` into a git-ignored directory, and
uses only what every version of the port's sweep has
(SweepAccelerator.prologue and coherence_order, sweep_kernel with
collect_stats). Three frames of the mesh_heavy scene, each 256^2, 1 spp,
seed 0: Whitted at depth 2, by default and with exact_shared_edges, and
the path tracer at depth 3. For each: the frames (one warm, then 3, CUDA
events) and their peak device memory; then, per sweep launch (every
recorded accelerator call, coherence-sorted and cut into the
accelerator's chunks), the prologue's ms and the kernel's ms (CUDA
events, 5 launches each), the steps and the busiest block's steps. Needs
a CUDA device; the timers and the call recorder are chip_smoke.py's, from
this checkout.
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
    ap.add_argument("--tris", type=int, default=1_000_000)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_launches: needs a CUDA device", file=sys.stderr)
        return 2
    mods = {m: importlib.import_module(f"trace_tpu_torch.{m}") for m in (
        "integrators.path", "integrators.whitted", "models.mesh_heavy",
        "ops.sweep", "sampler.uniform")}
    mesh_heavy = mods["models.mesh_heavy"]
    sweep_kernel = mods["ops.sweep"].sweep_kernel
    U = mods["sampler.uniform"]
    if not mods["ops.sweep"].__file__.startswith(root):
        raise RuntimeError(f"trace_tpu_torch did not come from {root}")
    card = cs.smi()
    print(f"root {root}; card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    out = dict(root=root, card=card, frames={})
    scenes = {}
    for label, exact, integ_cls, depth in (
            ("whitted", False, mods["integrators.whitted"].WhittedIntegrator,
             2),
            ("whitted_exact", True,
             mods["integrators.whitted"].WhittedIntegrator, 2),
            ("path", False, mods["integrators.path"].PathIntegrator, 3)):
        if exact not in scenes:
            torch.cuda.empty_cache()
            scenes[exact] = mesh_heavy.build_scene(
                a.tris, device=dev, exact_shared_edges=exact)
        scene = scenes[exact]
        acc = scene.accel
        integ = integ_cls(mesh_heavy.build_camera(256, "unused.png"),
                          U.UniformSampler(1, seed=0), max_depth=depth)
        torch.cuda.reset_peak_memory_stats()
        times, _ = cs.timed_frames(integ, scene)
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches = []
        for i, (o, d, tm, anyh) in enumerate(cs.record_calls(integ, scene)):
            perm = acc.coherence_order(o, d, tm)
            o, d, tm = o[perm], d[perm], tm[perm]
            c = acc.ray_chunk
            for j, s in enumerate(range(0, o.shape[0], c)):
                oc, dc, tc = o[s:s + c], d[s:s + c], tm[s:s + c]
                pro_ms = cs.cuda_ms(lambda: acc.prologue(oc, dc, tc), 5)
                args = acc.prologue(oc, dc, tc)
                opt = dict(certified=acc.certified)
                per_block = sweep_kernel(*args, acc.panel, acc.block_rays,
                                         anyh, collect_stats=True, **opt)[2]
                k_ms = cs.cuda_ms(lambda: sweep_kernel(
                    *args, acc.panel, acc.block_rays, anyh, **opt), 5)
                row = dict(call=i, any_hit=anyh, chunk=j, lanes=oc.shape[0],
                           live=int((tc >= 0).sum()), prologue_ms=pro_ms,
                           ms=k_ms, steps=int(per_block.sum()),
                           max_block_steps=int(per_block.max()))
                launches.append(row)
                print(f"{label} call {i} ({'any' if anyh else 'closest'} "
                      f"hit) chunk {j}: {row['lanes']} lanes ({row['live']} "
                      f"live), prologue {pro_ms:.3f} ms, kernel {k_ms:.3f} "
                      f"ms, steps {row['steps']}, busiest block "
                      f"{row['max_block_steps']}", flush=True)
        ms = sum(times) / len(times)
        out["frames"][label] = dict(times=times, ms=ms, peak_gib=peak,
                                    launches=launches)
        print(f"{label} frame: {[round(x, 3) for x in times]} ms, mean "
              f"{ms:.2f} ms, peak {peak:.2f} GiB; card {card}", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
