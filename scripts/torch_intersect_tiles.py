"""Time the port's brute-force intersect kernel (trace_tpu_torch/csrc/
intersect.cu) at several register tiles -- rays per thread x threads per
128-ray CTA -- and, optionally, other versions of the source: the
measurement behind the kernel's compile-time ``kRays`` and ``kThreads``.

    python scripts/torch_intersect_tiles.py [--tiles 1x128 2x64 4x32] \
        [--source OTHER/intersect.cu ...] [--out intersect_tiles.json]

For each tile it writes a copy of intersect.cu with ``kRays`` and
``kThreads`` replaced under trace_tpu_torch/build/ (git-ignored); each
``--source`` (e.g. the parent commit's intersect.cu, unpacked with git
archive under the git-ignored _archive/) is copied as it is. All are
built with the port's nvcc flags, in parallel. On the 5k-triangle
mesh_heavy scene's 256^2 Whitted frame (1 spp, depth 2, seed 0) through
the fused accelerator -- chip_smoke phase 2c -- it holds every version
bit-equal to the plain version on the frame's camera rays (66688 x 5000)
and times each (CUDA events, 10 launches, the versions in order and then
in reverse, the mean of both passes). Needs a CUDA device; the timer, the
call recorder and the bound are chip_smoke.py's.
"""
import argparse
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def kernel_from(name: str, src: str):
    """An IntersectKernel bound to ``src`` built as build/lib<name>.so."""
    from trace_tpu_torch.ops import intersect as TI
    from trace_tpu_torch.ops import nvcc

    k = TI.IntersectKernel()
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    k.lib.source = os.path.join(nvcc.BUILD_DIR, f"{name}.cu")
    k.lib.path = os.path.join(nvcc.BUILD_DIR, f"lib{name}.so")
    with open(k.lib.source, "w") as f:
        f.write(src)
    return k


def tiled(src: str, rays: int, threads: int) -> str:
    out = src
    for const, v in (("kRays", rays), ("kThreads", threads)):
        out, n = re.subn(rf"constexpr int {const} = \d+;",
                         f"constexpr int {const} = {v};", out)
        if n != 1:
            raise RuntimeError(f"intersect.cu has no single {const}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tiles", nargs="+", default=["1x128", "2x64", "4x32"])
    ap.add_argument("--source", nargs="*", default=[])
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_intersect_tiles: needs a CUDA device", file=sys.stderr)
        return 2
    from trace_tpu_torch.integrators.whitted import WhittedIntegrator
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.ops import intersect as TI
    from trace_tpu_torch.sampler import uniform as U

    card = cs.smi()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    with open(TI.IntersectKernel().lib.source) as f:
        src = f.read()
    kernels = {}
    for t in a.tiles:
        r, th = (int(x) for x in t.split("x"))
        if r * th != TI.RAY_BLOCK:
            raise ValueError(f"tile {t}: a CTA serves {TI.RAY_BLOCK} rays")
        kernels[t] = kernel_from(f"intersect_{t}", tiled(src, r, th))
    for i, path in enumerate(a.source):
        with open(path) as f:
            kernels[path] = kernel_from(f"intersect_src{i}", f.read())
    with ThreadPoolExecutor() as ex:   # nvcc runs outside the GIL
        list(ex.map(lambda k: k.lib.load(), kernels.values()))
    regs = {n: cs.ptxas_summary(k.lib.build_log) for n, k in kernels.items()}
    for n, r in regs.items():
        print(f"{n}: registers/spill stores/spill loads "
              f"{[f'{x}/{s}/{l}' for _, x, s, l in r]}", flush=True)

    scene = mesh_heavy.build_scene(5000)
    TI.attach(scene)
    calls = cs.record_calls(WhittedIntegrator(
        mesh_heavy.build_camera(256, "unused.png"),
        U.UniformSampler(1, seed=0), max_depth=2,
        pixel_chunk=cs.ONE_CHUNK), scene)
    o, d, tm, _ = calls[0]
    rays, _ = TI.pack_rays(o, d, tm)
    fa = scene.accel
    pt, pi = TI.intersect_plain(rays, fa.tris, fa.ids)
    for n, k in kernels.items():
        kt, ki = k(rays, fa.tris, fa.ids)
        torch.cuda.synchronize()
        if not (torch.equal(kt, pt) and torch.equal(ki, pi)):
            raise AssertionError(f"{n}: kernel differs from plain")
    ms = {n: [] for n in kernels}
    names = list(kernels)
    for order in (names, names[::-1]):
        for n in order:
            ms[n].append(cs.cuda_ms(lambda: kernels[n](rays, fa.tris,
                                                       fa.ids), 10))
    b_ms, b_by = cs.bound(
        rays.shape[1] * scene.n_triangles * cs.INTERSECT_OPS,
        rays.numel() * 4 + fa.tris.numel() * 4 + fa.ids.numel() * 4
        + rays.shape[1] * 8)
    rows = []
    for n in names:
        m = sum(ms[n]) / len(ms[n])
        rows.append(dict(version=n, ms=m, runs=ms[n], bound_ms=b_ms,
                         bound_by=b_by, share=b_ms / m))
        print(f"{n}: {m:.4f} ms (runs {[round(x, 4) for x in ms[n]]}), "
              f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / m:.1f}% of it; "
              f"{rays.shape[1]} rays x {scene.n_triangles} triangles, "
              f"bit-equal to plain", flush=True)
    print(f"card: {card}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(card=card, registers=regs, rows=rows), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
