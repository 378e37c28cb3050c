"""Time the port's sweep kernel (trace_tpu_torch/csrc/sweep.cu) at several
warps per 32-ray block: the measurement behind the kernel's compile-time
``kWarps``.

    python scripts/torch_sweep_warps.py [--warps 4 8 16] [--tris 1000000] \
        [--out sweep_warps.json]

For each W it writes a copy of sweep.cu with ``constexpr int kWarps = W;``
under trace_tpu_torch/build/ (git-ignored) and builds it with the port's
nvcc flags, all W in parallel, and prints ptxas's registers and spills
per arm. Then, on the mesh_heavy scene, it records the rays of a Whitted
frame (256^2, 1 spp, depth 2, seed 0) and of a path-traced frame (256^2, 1
spp, depth 3, seed 0). On the first 65536-ray chunk of the Whitted camera
rays, of the path tracer's camera rays and of its bounce-1 rays, at every
W and in the f32, certified and double-buffered f32 arms, it holds the
kernel bit-equal to the plain version and times it (CUDA events, 5
launches, W in order and then in reverse, the mean of both passes), with
the busiest block's steps and the us per busiest-block step. Needs a CUDA
device; the timer, the call recorder and the ptxas reader are
chip_smoke.py's.
"""
import argparse
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def kernel_at(warps: int):
    """A SweepKernel bound to a copy of sweep.cu built at ``warps``."""
    from trace_tpu_torch.ops import nvcc
    from trace_tpu_torch.ops import sweep as TS

    k = TS.SweepKernel()
    with open(k.lib.source) as f:
        src = f.read()
    line = f"constexpr int kWarps = {TS.SWEEP_WARPS};"
    if line not in src:
        raise RuntimeError(f"sweep.cu has no line {line!r}")
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    k.lib.source = os.path.join(nvcc.BUILD_DIR, f"sweep_w{warps}.cu")
    k.lib.path = os.path.join(nvcc.BUILD_DIR, f"libsweep_w{warps}.so")
    with open(k.lib.source, "w") as f:
        f.write(src.replace(line, f"constexpr int kWarps = {warps};"))
    return k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--warps", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--tris", type=int, default=1_000_000)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_warps: needs a CUDA device", file=sys.stderr)
        return 2
    from trace_tpu_torch.integrators.path import PathIntegrator
    from trace_tpu_torch.integrators.whitted import WhittedIntegrator
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops import sweep as TS
    from trace_tpu_torch.sampler import uniform as U

    card = cs.smi()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    kernels = {w: kernel_at(w) for w in a.warps}
    with ThreadPoolExecutor() as ex:   # nvcc runs outside the GIL
        list(ex.map(lambda k: k.lib.load(), kernels.values()))
    regs = {w: cs.ptxas_summary(k.lib.build_log) for w, k in kernels.items()}
    for w, r in regs.items():
        print(f"W={w}: registers/spill stores/spill loads per arm: "
              f"{[f'{n}:{x}/{s}/{l}' for n, x, s, l in r]}", flush=True)

    scene = mesh_heavy.build_scene(a.tris)
    acc = scene.accel
    w_calls = cs.record_calls(WhittedIntegrator(
        mesh_heavy.build_camera(256, "unused.png"),
        U.UniformSampler(1, seed=0), max_depth=2), scene)
    p_calls = cs.record_calls(PathIntegrator(
        mesh_heavy.build_camera(256, "unused.png"),
        U.UniformSampler(1, seed=0), max_depth=3), scene)
    chunks = {}
    for label, (o, d, tm, anyh) in (("whitted camera", w_calls[0]),
                                    ("path camera", p_calls[0]),
                                    ("path bounce 1", p_calls[2])):
        perm = acc.coherence_order(o, d, tm)
        c = acc.ray_chunk
        chunks[label] = (acc.prologue(o[perm][:c], d[perm][:c],
                                      tm[perm][:c]), anyh)
    del w_calls, p_calls
    arms = [("f32", False, False), ("certified", True, False),
            ("f32_pipelined", False, True)]
    rows = []
    b = acc.block_rays
    for label, (args, anyh) in chunks.items():
        for arm, cert, pipe in arms:
            opt = dict(certified=cert)
            pt, pi, ps = TS.sweep_plain(*args, acc.panel, b, anyh,
                                        collect_stats=True, **opt)
            for w, k in kernels.items():
                kt, ki, ks = k(*args, acc.panel, b, anyh, collect_stats=True,
                               pipeline=pipe, **opt)
                torch.cuda.synchronize()
                if not (torch.equal(kt, pt) and torch.equal(ki, pi)
                        and torch.equal(ks, ps)):
                    raise AssertionError(f"W={w} {arm} {label}: kernel "
                                         f"differs from plain")
            ms = {w: [] for w in kernels}
            for order in (a.warps, a.warps[::-1]):
                for w in order:
                    ms[w].append(cs.cuda_ms(lambda: kernels[w](
                        *args, acc.panel, b, anyh, pipeline=pipe, **opt), 5))
            busiest = int(ps.max())
            for w in kernels:
                m = sum(ms[w]) / len(ms[w])
                row = dict(chunk=label, arm=arm, warps=w, ms=m, runs=ms[w],
                           steps=int(ps.sum()), max_block_steps=busiest,
                           us_per_busiest_step=1e3 * m / max(busiest, 1))
                rows.append(row)
                print(f"{label}, {arm}, W={w}: {m:.3f} ms (runs "
                      f"{[round(x, 4) for x in ms[w]]}), steps "
                      f"{row['steps']}, busiest block {busiest} steps, "
                      f"{row['us_per_busiest_step']:.2f} us a step; "
                      f"bit-equal to plain", flush=True)
    print(f"card: {card}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(card=card, registers=regs, rows=rows), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
