"""Ranks of the port's sharded paths on the CPU, for the tests.

``run_ranks(fn, world_size, tmp_path)`` starts ``world_size`` processes
(torch.multiprocessing.spawn) that join one gloo process group through a
FileStore under ``tmp_path``; rank r runs ``fn(rank, world_size)`` with
one torch thread and saves the arrays of the dict it returns as
``tmp_path/<name>.r<rank>.npy``; the call returns one dict a rank. This
module imports neither JAX nor the tests' conftest, so the spawned ranks
(which import it to unpickle ``fn``) do not either. It also holds the
cases of tests/test_torch_parallel.py: ``sharded_cases`` (on every rank)
and ``single_cases`` (the same renders on one device).
"""
import glob
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _rank_main(rank, fn, world_size, tmp):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world_size)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world_size)
    try:
        for name, value in fn(rank, world_size).items():
            np.save(os.path.join(tmp, f"{name}.r{rank}.npy"), value)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, tmp_path) -> list:
    """[{name: array}] of each rank of ``fn`` run on ``world_size`` gloo
    ranks (module docstring)."""
    tmp = str(tmp_path)
    mp.spawn(_rank_main, args=(fn, world_size, tmp), nprocs=world_size,
             join=True)
    out = [{} for _ in range(world_size)]
    for path in glob.glob(os.path.join(tmp, "*.r*.npy")):
        name, r = os.path.basename(path)[:-4].rsplit(".r", 1)
        out[int(r)][name] = np.load(path)
    return out


# -- the cases --------------------------------------------------------------

SPHERES_RENDER = dict(res=12, spp=1, max_depth=2, seed=5)
PHOTONS = dict(initial_search_radius=0.2, max_depth=2, n_iterations=1,
               photons_per_iteration=1024)
DEEP = dict(initial_search_radius=0.2, max_depth=4, n_iterations=2,
            photons_per_iteration=2048, seed=0)


def _modules():
    import chip_smoke as CS
    from trace_tpu_torch.models import spheres

    ns = CS.port_modules()
    return dict(
        CS=CS, ns=ns, spheres=spheres.build_scene(device="cpu"),
        dryrun=CS.dryrun_builder(ns).build(device="cpu"),
        spheres_cam=lambda res: spheres.build_camera(res, "unused.png"),
        dryrun_cam=CS.dryrun_camera(ns, 16))


def _sppm(cam, mesh=None, **kw):
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator

    return SPPMIntegrator(cam, device="cpu", mesh=mesh, **kw)


def _state(prefix, st) -> dict:
    return {f"{prefix}_{k}": getattr(st, k).numpy()
            for k in ("ld", "tau", "radius", "n", "m")}


def sharded_cases(rank, world_size) -> dict:
    """Every sharded case on this rank (tests/test_torch_parallel.py)."""
    from trace_tpu_torch.parallel.render import make_mesh, render_sharded

    m = _modules()
    out = {}
    rays = make_mesh("cpu")
    cam = m["spheres_cam"](SPHERES_RENDER["res"])
    for name in ("whitted", "path"):
        for call in (0, 1):
            st = render_sharded(
                m["spheres"], cam, rays, spp=1, max_depth=2,
                seed=SPHERES_RENDER["seed"], integrator=name)
            out[f"spheres_{name}_{call}"] = cam.film.to_image(st).numpy()
        st = render_sharded(m["dryrun"], m["dryrun_cam"], rays, spp=1,
                            max_depth=2, integrator=name)
        out[f"dryrun_{name}"] = m["dryrun_cam"].film.to_image(st).numpy()
    integ = _sppm(m["dryrun_cam"], rays, shard_axis="rays",
                  shard_camera=True, **m["CS"].DRYRUN_SPPM)
    out["dryrun_sppm"] = integ.to_image(integ.render(m["dryrun"]), 1).numpy()

    cam12 = m["spheres_cam"](12)
    photons = make_mesh("cpu", axis="photons")
    out.update(_state("photons", _sppm(cam12, photons, seed=2,
                                       **PHOTONS).render(m["spheres"])))
    px = make_mesh("cpu", axis="px")
    out.update(_state("spmd", _sppm(cam12, px, seed=1, shard_axis="px",
                                    shard_camera=True,
                                    **PHOTONS).render(m["spheres"])))
    integ = _sppm(m["spheres_cam"](24), rays, shard_axis="rays",
                  shard_camera=True, **DEEP)
    st = integ.render(m["spheres"])
    out.update(_state("deep", st))
    out["deep_image"] = integ.to_image(st, DEEP["n_iterations"]).numpy()
    out["refusals"] = np.array(_refusals(m, rays, cam12), np.int32)
    out.update(_gathered(rays, rank))
    return out


def _gathered(mesh, rank) -> dict:
    """gather_shares of a float share holding -0.0, +0.0, NaN and -inf, an
    int64 share and a bool share, each tagged with the rank."""
    from trace_tpu_torch.parallel.render import axis_group, gather_shares

    group, r, size = axis_group(mesh, "rays")
    f = torch.tensor([[-0.0, 0.0], [float("nan"), -float("inf")],
                      [float(rank), -float(rank)]])
    i = torch.tensor([rank, -rank, 1 << 40], dtype=torch.int64)
    b = torch.tensor([rank % 2 == 0, True])
    gf, (gi, gb) = gather_shares((f, [i, b]), group, r, size)
    return {"gather_f": gf.numpy(), "gather_f_signs": torch.signbit(
        gf).numpy(), "gather_i": gi.numpy(), "gather_b": gb.numpy()}


def _refusals(m, mesh, cam) -> list:
    """1 where the call raised ValueError: animated geometry and
    render_frames with a mesh, an axis the mesh lacks (render_sharded and
    SPPMIntegrator), an unknown integrator."""
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.lights import lights as L
    from trace_tpu_torch.parallel.render import render_sharded

    scene = m["spheres"]
    light = [L.point_light(T.translate([0.0, 5.0, 0.0]), (1.0, 1.0, 1.0))]
    calls = [
        lambda: _sppm(cam, mesh, shard_axis="rays", **PHOTONS).render(
            scene, geometry=scene.triangles),
        lambda: _sppm(cam, mesh, shard_axis="rays", **PHOTONS).render_frames(
            scene, [light]),
        lambda: _sppm(cam, mesh, shard_axis="nope", **PHOTONS),
        lambda: render_sharded(scene, cam, mesh, axis="nope"),
        lambda: render_sharded(scene, cam, mesh, integrator="bogus"),
    ]
    out = []
    for call in calls:
        try:
            call()
            out.append(0)
        except ValueError:
            out.append(1)
    return out


def single_cases() -> dict:
    """The same renders on one device (the sharded cases' references)."""
    from trace_tpu_torch.integrators.path import PathIntegrator
    from trace_tpu_torch.integrators.whitted import WhittedIntegrator
    from trace_tpu_torch.sampler.uniform import UniformSampler

    m = _modules()
    out = {}
    cam = m["spheres_cam"](SPHERES_RENDER["res"])
    for name, cls in (("whitted", WhittedIntegrator),
                      ("path", PathIntegrator)):
        integ = cls(cam, UniformSampler(1, seed=SPHERES_RENDER["seed"]),
                    max_depth=2)
        out[f"spheres_{name}"] = cam.film.to_image(
            integ.render(m["spheres"])).numpy()
        integ = cls(m["dryrun_cam"], UniformSampler(1, seed=0), max_depth=2)
        out[f"dryrun_{name}"] = m["dryrun_cam"].film.to_image(
            integ.render(m["dryrun"])).numpy()
    integ = _sppm(m["dryrun_cam"], **m["CS"].DRYRUN_SPPM)
    out["dryrun_sppm"] = integ.to_image(integ.render(m["dryrun"]), 1).numpy()
    cam12 = m["spheres_cam"](12)
    out.update(_state("photons", _sppm(cam12, seed=2, **PHOTONS).render(
        m["spheres"])))
    out.update(_state("spmd", _sppm(cam12, seed=1, **PHOTONS).render(
        m["spheres"])))
    integ = _sppm(m["spheres_cam"](24), **DEEP)
    st = integ.render(m["spheres"])
    out.update(_state("deep", st))
    out["deep_image"] = integ.to_image(st, DEEP["n_iterations"]).numpy()
    return out
