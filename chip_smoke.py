#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (trace_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure raises):
  0. device: the card's name and power limit, torch and CUDA versions;
  1. build: the sweep kernel (nvcc, sm_90a) and the SAH builder (g++);
  2. kernel vs plain: the 1M-triangle mesh_heavy scene; every sweep launch
     of one 256^2 depth-2 frame (camera, shadow and specular rays, in the
     frame's own 65536-ray chunks), plus the camera rays as any-hit, through
     the CUDA kernel and its plain PyTorch version on the same inputs;
  3. golden: the 5k-triangle scene at 32^2 against
     tests/goldens/mesh_heavy5k_32.npy (the JAX package's render), MSE < 5e-4;
  4. slice: Whitted on the 1M-triangle scene, 256^2, 1 spp, depth 2; one warm
     frame, then three frames timed with CUDA events; the PNG goes to the
     temporary directory (TMPDIR).
The last two lines are the card's name and power limit, and
{"ok": true, "device": {...}}. Without a CUDA device, or outside a checkout
of the repository, it exits non-zero and prints no result.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "goldens", "mesh_heavy5k_32.npy")
MSE_GATE = 5e-4
# Kernel vs plain: built with --fmad=false in the plain version's
# association order, so the two should agree bit for bit; the stated
# tolerance on t leaves room for nothing but a last-ulp difference.
T_RTOL = 1e-6


def log(phase, t0, msg):
    print(f"[{phase}] {time.perf_counter() - t0:8.2f} s  {msg}", flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps):
    import torch

    fn()  # warm
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def compare(kt, ki, pt, pi):
    """Mismatch counts between kernel and plain (best t, best slot)."""
    kf, pf = ki >= 0, pi >= 0
    both = kf & pf
    dt = (kt - pt).abs()
    bad_t = both & (dt > T_RTOL * pt.abs().clamp_min(1.0))
    tied = both & (kt == pt)
    return {
        "hit_mismatch": int((kf != pf).sum()),
        "t_beyond_tol": int(bad_t.sum()),
        "id_mismatch_untied_t": int((tied & (ki != pi)).sum()),
        "max_abs_err": float(dt[both].max()) if bool(both.any()) else 0.0,
        "n_found": int(kf.sum()),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from trace_tpu_torch.accel import native
    from trace_tpu_torch.integrators.whitted import WhittedIntegrator
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops.sweep import sweep_kernel, sweep_plain
    from trace_tpu_torch.sampler import uniform as U

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    card = smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    log(0, t0, f"card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    sweep_kernel.load()
    t_nvcc = time.perf_counter() - t0
    native.load()
    log(1, t0, f"built sweep kernel (nvcc {t_nvcc:.2f} s) and SAH builder")

    # -- 2: kernel vs plain on the main path's own launches ---------------
    t0 = time.perf_counter()
    scene = mesh_heavy.build_scene(1_000_000, device=dev)
    build_s = time.perf_counter() - t0
    acc = scene.accel
    tb = acc.tables
    log(2, t0, f"host scene build {build_s:.2f} s: n_triangles "
        f"{scene.n_triangles}, n_supers {tb.n_supers}, panel "
        f"{tb.panel.nbytes / 2**20:.1f} MB")
    png = os.path.join(tempfile.gettempdir(), "chip_smoke_256.png")
    cam = mesh_heavy.build_camera(256, png)
    integ = WhittedIntegrator(cam, U.UniformSampler(1, seed=0), max_depth=2)
    # Record the rays of every intersect call of one frame (camera, shadow
    # and depth-2 specular rays), then replay each call's chunks exactly as
    # SweepAccelerator.intersect launches them.
    calls = []
    traced = acc.intersect

    def record(o, d, t_max, any_hit):
        calls.append((o.clone(), d.clone(), t_max.clone(), any_hit))
        return traced(o, d, t_max, any_hit)

    acc.intersect = record
    try:
        integ.render(scene)
    finally:
        del acc.intersect
    cases = [(f"call{i}_{'any_hit' if a else 'closest'}", o, d, tm, a)
             for i, (o, d, tm, a) in enumerate(calls)]
    # The camera rays once more as any-hit: nearly every lane is occluded,
    # so the any-hit early exit runs at full scale.
    o, d, tm, _ = calls[0]
    cases.append(("camera_any_hit", o, d, tm, True))
    res = {}
    for name, o, d, tm, anyh in cases:
        perm = acc.coherence_order(o, d, tm)
        o, d, tm = o[perm], d[perm], tm[perm]
        n, c = o.shape[0], acc.ray_chunk
        tot = dict(hit_mismatch=0, t_beyond_tol=0, id_mismatch_untied_t=0,
                   max_abs_err=0.0, n_found=0)
        chunks = []
        for s in range(0, n, c):
            args = (*acc.prologue(o[s:s + c], d[s:s + c], tm[s:s + c]),
                    acc.panel, acc.block_rays, anyh)
            kt, ki = sweep_kernel(*args)
            pt, pi = sweep_plain(*args)
            torch.cuda.synchronize()
            cmp = compare(kt, ki, pt, pi)
            for k, v in cmp.items():
                tot[k] = max(tot[k], v) if k == "max_abs_err" else tot[k] + v
            chunks.append((min(c, n - s), args))
        res[name] = tot
        log(2, t0, f"{name}: {n} rays in chunks "
            f"{[k for k, _ in chunks]}, {tot}")
        if tot["hit_mismatch"] or tot["t_beyond_tol"] \
                or tot["id_mismatch_untied_t"]:
            raise AssertionError(f"kernel disagrees with plain: {name} {tot}")
        if name == "call0_closest":
            args = chunks[0][1]
            tot["ms"] = cuda_ms(lambda: sweep_kernel(*args), 10)
            tot["plain_ms"] = cuda_ms(lambda: sweep_plain(*args), 2)
            log(2, t0, f"{name} first chunk ({chunks[0][0]} rays): kernel "
                f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms (CUDA "
                f"events)")
    if [a for *_, a in calls] != [False, True, False, True]:
        raise AssertionError(f"unexpected intersect calls: {len(calls)}")
    if res["call0_closest"]["n_found"] <= 0 \
            or res["camera_any_hit"]["n_found"] < 1000:
        raise AssertionError("too few hits to exercise the kernel")
    del calls, cases, chunks, args, o, d, tm

    # -- 3: golden --------------------------------------------------------
    t0 = time.perf_counter()
    small = mesh_heavy.build_scene(5000, device=dev)
    cam32 = mesh_heavy.build_camera(
        32, os.path.join(tempfile.gettempdir(), "chip_smoke_32.png"))
    st = WhittedIntegrator(cam32, U.UniformSampler(1, seed=0),
                           max_depth=2).render(small)
    img = cam32.film.to_image(st).cpu().numpy()
    golden = np.load(GOLDEN)
    mse = float(np.mean((img - golden) ** 2))
    log(3, t0, f"golden 32^2: MSE {mse:.3e} (gate {MSE_GATE}), max abs "
        f"{float(np.abs(img - golden).max()):.4f}")
    if not (img.shape == golden.shape and np.isfinite(img).all()
            and mse < MSE_GATE):
        raise AssertionError(f"golden mismatch: MSE {mse}")

    # -- 4: the slice -----------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sweep_kernel.launches = 0
    integ.render(scene)  # warm frame
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        state = integ.render(scene)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    launches = sweep_kernel.launches
    img = cam.film.to_image(state).cpu().numpy()
    cam.film.save_png(state)
    (x0, y0), (x1, y1) = cam.film.sample_bounds()
    n_pix = (x1 - x0 + 1) * (y1 - y0 + 1)
    rays = n_pix * 1 * (1 + int(scene.lights.kind.shape[0])) * 2
    ms = float(np.mean(times))
    nonzero = float((img > 0).any(-1).mean())
    log(4, t0, f"1M tris 256^2 1spp depth 2: frames {times} ms, mean "
        f"{ms:.2f} ms, {rays / ms / 1e3:.3f} Mrays/s ({rays} rays/frame), "
        f"kernel launches {launches}, queue_drops {integ.last_queue_drops}, "
        f"useful_rays {integ.last_useful_rays}, non-zero pixels "
        f"{nonzero:.3f}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; PNG {png}; "
        f"card {card}")
    if launches <= 0 or integ.last_queue_drops != 0:
        raise AssertionError("slice did not run through the kernel cleanly")
    if not (np.isfinite(img).all() and img.shape == (256, 256, 3)
            and nonzero > 0.05):
        raise AssertionError(f"bad frame: non-zero share {nonzero}")

    kern = res["call0_closest"]
    print(json.dumps({"kernels": [{
        "name": "sweep", "route": "cuda",
        "source": "trace_tpu_torch/csrc/sweep.cu",
        "replaces": "trace_tpu/ops/sweep_pallas.py:213",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in res.values()),
        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
    }]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
