"""Every walk call of one mesh1m_sppm_1024_wbvh iteration (bench config
3's settings, 1024^2, 262144 photons, depth 8, radius 0.075, seed 0, on
the 1M-triangle mesh_heavy behind accelerator="wbvh") and of the 256^2
Whitted frame (depth 2) on it, through the walk kernel of this checkout
or of another, so that one call on the card can time two versions of the
kernel on the same rays.

    python scripts/torch_walk_calls.py [--root DIR] [--reps 10] \
        [--longest 4] [--out calls.json]

Imports trace_tpu_torch from DIR (default: this checkout), e.g. an older
commit unpacked with ``git archive`` into a git-ignored directory, and
uses only what every version of the walk has (SceneBuilder.build's
accelerator="wbvh", walk_kernel with the same signature). Per call: the
kernel's device ms (--reps launches replayed as one CUDA graph, so that
no host time between launches is counted), lanes, live lanes, and a
digest of the kernel's outputs (t bits, ids, per-ray node visits and
triangle tests), so that two versions can be held bit-equal call by
call; then the --longest walks of the Whitted camera call and of the
1024^2 camera call, each launched alone (one ray), against a launch of
one ray that walks nothing: what one walk's chain of dependent node
loads costs on an otherwise idle card; and ptxas's report of the
kernel's arms where this process built them. Needs a CUDA device; the
timers and the recorders are chip_smoke.py's, from this checkout.
"""
import argparse
import hashlib
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
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--longest", type=int, default=4)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("torch_walk_calls: needs a CUDA device", file=sys.stderr)
        return 2
    mods = {m: importlib.import_module(f"trace_tpu_torch.{m}") for m in (
        "integrators.sppm", "integrators.whitted", "models.mesh_heavy",
        "ops.bvh_walk", "sampler.uniform")}
    if not mods["ops.bvh_walk"].__file__.startswith(root):
        raise RuntimeError(f"trace_tpu_torch did not come from {root}")
    mesh_heavy = mods["models.mesh_heavy"]
    walk_kernel = mods["ops.bvh_walk"].walk_kernel
    U = mods["sampler.uniform"]
    card = cs.smi()
    print(f"root {root}; card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    scene = mesh_heavy.build_scene(1_000_000, device=dev, accelerator="wbvh")
    acc = scene.accel
    sppm = mods["integrators.sppm"].SPPMIntegrator(
        mesh_heavy.build_camera(1024, "unused.png"),
        initial_search_radius=0.075, max_depth=8, n_iterations=1,
        photons_per_iteration=262144, seed=0, device=dev)
    whitted = mods["integrators.whitted"].WhittedIntegrator(
        mesh_heavy.build_camera(256, "unused.png"),
        U.UniformSampler(1, seed=0), max_depth=2)
    calls = cs.tagged_walk_calls(sppm, scene) + [
        (f"whitted {name}", *c) for name, c in zip(
            ("camera", "shadow", "specular", "specular shadow"),
            cs.record_calls(whitted, scene))]
    rows, ptxas = [], None
    for name, o, d, tm, anyh in calls:
        kw = dict(any_hit=anyh, limit="wbvh", stack_depth=acc.stack_depth)
        t, i, stats = walk_kernel(acc.nodes, acc.tris, o, d, tm,
                                  collect_stats=True, **kw)
        if ptxas is None:   # the arms built in this process, if any
            ptxas = cs.walk_ptxas(walk_kernel.lib.build_log)
            print(f"ptxas: {ptxas}", flush=True)
        digest = hashlib.sha256()
        for x in (t.view(torch.int32), i, stats):
            digest.update(x.cpu().numpy().tobytes())
        rows.append(dict(call=name, lanes=o.shape[0],
                         live=int((tm > 0).sum()),
                         visits=int(stats[0].sum()),
                         max_visits=int(stats[0].max()),
                         ms=cs.graph_ms(lambda: walk_kernel(
                             acc.nodes, acc.tris, o, d, tm, **kw), a.reps),
                         digest=digest.hexdigest()[:16]))
        print(json.dumps(rows[-1]), flush=True)
    # The longest walks alone: their own chain, on an idle card.
    chains = []
    for name, o, d, tm, anyh in calls:
        if name not in ("whitted camera", "camera depth 1"):
            continue
        kw = dict(any_hit=anyh, limit="wbvh", stack_depth=acc.stack_depth)
        visits = walk_kernel(acc.nodes, acc.tris, o, d, tm,
                             collect_stats=True, **kw)[2][0]
        dead = torch.full((1,), -1.0, device=dev)
        idle = cs.graph_ms(lambda: walk_kernel(acc.nodes, acc.tris, o[:1],
                                               d[:1], dead, **kw), a.reps)
        for r in torch.argsort(visits, descending=True)[:a.longest].tolist():
            one = slice(r, r + 1)
            ms = cs.graph_ms(lambda: walk_kernel(acc.nodes, acc.tris, o[one],
                                                 d[one], tm[one], **kw),
                             a.reps)
            chains.append(dict(call=name, ray=r, visits=int(visits[r]),
                               ms=ms, dead_ray_ms=idle,
                               ns_per_visit=(ms - idle) * 1e6 / int(
                                   visits[r])))
            print(json.dumps(chains[-1]), flush=True)
    sppm_ms = sum(r["ms"] for r in rows if not r["call"].startswith("whitted"))
    print(f"the 1024^2 iteration's walk calls: {sppm_ms:.4f} ms in all; "
          f"card {card}", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(dict(root=root, card=card, sppm_ms=sppm_ms,
                           ptxas=ptxas, calls=rows, longest=chains), f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
