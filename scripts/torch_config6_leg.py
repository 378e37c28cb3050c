"""Bench config 6's leg (a) -- ``mesh16m_whitted_256``'s sweep at group 64,
blocks of 128 rays, chunks of 8192 (chip_smoke.py phase 17b) -- rendered
with several builds of the sweep kernel in one process, so that one call
on the card compares two versions on the same frames.

    python scripts/torch_config6_leg.py [--kernels NAME=SOURCE ...]

Builds the 16M-triangle mesh_heavy scene and its SAH clusters once, then
for each kernel (this checkout's build first, then each ``--kernels``
entry, as in scripts/torch_sweep_tilings.py: a .cu file with sweep.cu's C
interface, e.g. the parent's, or OLD=>NEW substitutions), in order and
then in reverse: chip_smoke.leg17 with its launches recorded -- a warm
frame, two frames timed with CUDA events, the frame's sweep launches and
their prologues replayed as CUDA graphs (ms a frame), every 4th launch
held to the plain version. The images of all kernels must be equal. Prints
one JSON line. Needs a CUDA device.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402
from torch_sweep_tilings import kernel_from  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kernels", nargs="*", default=[])
    a = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_config6_leg: needs a CUDA device", file=sys.stderr)
        return 2
    from trace_tpu_torch.accel import clusters as TC
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops import sweep as TS
    from trace_tpu_torch.shapes import triangle as tri_mod

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"root": TS.sweep_kernel.lib}
    for item in a.kernels:
        name, spec = item.split("=", 1)
        libs[name] = kernel_from(TS, name, spec).lib
    for lib in libs.values():
        lib.load()
    TS.block_entry_kernel.lib.load()
    out = dict(card=cs.smi(), ptxas={n: cs.ptxas_summary(lib.build_log)
                                     for n, lib in libs.items()}, rows={})
    t0 = time.perf_counter()
    scene = mesh_heavy.build_scene(cs.CONFIG6_TRIS, device=dev,
                                   use_bvh=False)
    tris = scene.triangles_host
    acc = TC.build_clusters(tris, leaf_tris=64, super_size=32)
    sweep = TS.SweepAccelerator(acc, dev, group=64, block_rays=128,
                                ray_chunk=8192)
    tris_dev = tri_mod.to_device(tris, dev)
    cam = mesh_heavy.build_camera(256, "unused.png")
    n_lights = int(scene.lights.kind.shape[0])
    n_rays = cs.n_pix_of(cam) * (1 + n_lights) * 2
    knobs = dict(cs.CONFIG6_LEGS)["sweep_g64_b128"]
    cs.log("c6", t0, f"scene, clusters and tables ready: "
           f"{scene.n_triangles} triangles")
    images = {}
    order = list(libs) + list(libs)[::-1]
    for i, name in enumerate(order):
        TS.sweep_kernel.lib = libs[name]
        scene.geometry_cache = None
        row, img = cs.leg17("c6", t0, out["card"], scene, tris_dev, sweep,
                            knobs, n_rays, 4, launch_times=True)
        bad = cs.disagrees(row["sweep"]) or row["sweep"]["t_bits_mismatch"] \
            or cs.prologue_disagrees(row["prologue"]) \
            or row["launches"]["tiled"] != row["launches"]["sweep"]
        rec = out["rows"].setdefault(name, dict(frame_ms=[], sweep_ms=[],
                                                prologue_ms=[]))
        rec["frame_ms"] += row["frame_ms"]
        rec["sweep_ms"].append(row["launch_ms"]["sweep_ms"])
        rec["prologue_ms"].append(row["launch_ms"]["prologue_ms"])
        rec.update(launches=row["launches"], bad=bool(bad),
                   peak_gib=row["peak_gib"])
        images.setdefault(name, img)
        cs.log("c6", t0, f"{name} (pass {i // len(libs) + 1}): frames "
               f"{row['frame_ms']} ms, sweep launches "
               f"{row['launch_ms']['sweep_ms']:.3f} ms a frame, prologues "
               f"{row['launch_ms']['prologue_ms']:.3f} ms, launches "
               f"{row['launches']}, agreement {row['sweep']}")
    first = images["root"]
    out["image_equal"] = {n: bool(np.array_equal(im, first))
                          for n, im in images.items()}
    print(json.dumps(out), flush=True)
    return int(any(r["bad"] for r in out["rows"].values())
               or not all(out["image_equal"].values()))


if __name__ == "__main__":
    sys.exit(main())
