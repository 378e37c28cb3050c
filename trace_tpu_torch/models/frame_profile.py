"""Where a frame spends its time on the GPU.

    python -m trace_tpu_torch.models.frame_profile --tris 1000000 \
        --resolution 256 [--exact-shared-edges] --out frame_profile.txt
    python -m trace_tpu_torch.models.frame_profile --scene cornell \
        --resolution 512

Prints, for one warm frame: the frame time (CUDA events, 3 frames) and a
torch.profiler table of device time by kernel with the device-busy share
of the frame. Scenes: ``mesh_heavy`` (Whitted, 1 spp, depth 2, at the
shipped sweep block size), ``shadows`` (bench config 1: Whitted, 4 spp,
depth 5, its level caps) and ``cornell`` (bench config 2: path tracer,
4 spp, depth 5). Each frame renders as one chunk of lanes. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

ONE_CHUNK = 1 << 30   # a pixel_chunk above any frame's lane count


def _events_ms(fn, reps: int) -> list:
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="mesh_heavy",
                    choices=("mesh_heavy", "shadows", "cornell"))
    ap.add_argument("--tris", type=int, default=1_000_000)
    ap.add_argument("--resolution", type=int, default=256)
    ap.add_argument("--exact-shared-edges", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("frame_profile: needs a CUDA device", file=sys.stderr)
        return 2
    from ..integrators.path import PathIntegrator
    from ..integrators.whitted import WhittedIntegrator
    from ..sampler import uniform as U
    from . import cornell, mesh_heavy, spheres

    dev = torch.device("cuda", 0)
    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    say(f"card: {card}; torch {torch.__version__}")
    if a.scene == "mesh_heavy":
        scene = mesh_heavy.build_scene(
            a.tris, device=dev, exact_shared_edges=a.exact_shared_edges)
        cam = mesh_heavy.build_camera(a.resolution, "unused.png")
        integ = WhittedIntegrator(cam, U.UniformSampler(1, seed=0),
                                  max_depth=2, pixel_chunk=ONE_CHUNK)
    else:
        mod = spheres if a.scene == "shadows" else cornell
        scene = mod.build_scene(device=dev,
                                exact_shared_edges=a.exact_shared_edges)
        cam = mod.build_camera(a.resolution, "unused.png")
        integ = (WhittedIntegrator(cam, U.UniformSampler(4, seed=0),
                                   max_depth=5, pixel_chunk=ONE_CHUNK,
                                   level_caps=spheres.LEVEL_CAPS)
                 if a.scene == "shadows" else
                 PathIntegrator(cam, U.UniformSampler(4, seed=0), max_depth=5,
                                pixel_chunk=ONE_CHUNK))
    frame = lambda: integ.render(scene)
    frame()

    f_ms = _events_ms(frame, 3)
    say(f"{a.scene}, {scene.n_triangles} triangles, {a.resolution}^2, "
        f"exact_shared_edges "
        f"{a.exact_shared_edges}: frames "
        f"{' '.join(f'{x:.2f}' for x in f_ms)} ms (CUDA events)")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        wall = _events_ms(frame, 1)[0]
    ev = prof.key_averages()
    on_dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in on_dev)
    # The profiler slows the host side, so the busy share is also given
    # against the unprofiled frames.
    say(f"profiled frame: {wall:.2f} ms (CUDA "
        f"events); device-busy {dev_us / 1e3:.2f} ms "
        f"({100 * dev_us / 1e3 / wall:.1f}% of the frame, "
        f"{100 * dev_us / 1e3 / np.mean(f_ms):.1f}% of the unprofiled "
        f"frames' mean) in {sum(e.count for e in on_dev)} device kernels")
    say(ev.table(sort_by="self_device_time_total", row_limit=20,
                 max_name_column_width=60))
    say(f"card: {card}")
    if a.out:
        with open(a.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
