"""Scene-script entry points: ``python -m trace_tpu_torch.models.<scene>``
renders one PNG (port of trace_tpu/models/_run.py: whitted_main,
path_main and sppm_main)."""
from __future__ import annotations

import argparse
import time


def parser(doc, *, resolution, spp, depth, output) -> argparse.ArgumentParser:
    """The scene scripts' arguments; ``--device`` is the card unless the
    caller asks for the CPU (``--device cpu``)."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--resolution", type=int, default=resolution)
    ap.add_argument("--output", default=output)
    ap.add_argument("--spp", type=int, default=spp)
    ap.add_argument("--depth", type=int, default=depth)
    ap.add_argument("--device", default="cuda")
    return ap


def sppm_parser(doc, *, resolution, iterations, depth, photons=-1,
                output) -> argparse.ArgumentParser:
    """The SPPM scene scripts' arguments (``--device`` as in parser)."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--resolution", type=int, default=resolution)
    ap.add_argument("--output", default=output)
    ap.add_argument("--iterations", type=int, default=iterations)
    ap.add_argument("--depth", type=int, default=depth)
    ap.add_argument("--photons", type=int, default=photons,
                    help="photons per iteration; -1 = one per pixel")
    ap.add_argument("--device", default="cuda")
    return ap


def sppm_main(doc, build_scene, build_camera, *, resolution, iterations,
              radius, depth, photons=-1, output="render.png", argv=None):
    """SPPM scene script: render ``--iterations`` iterations and write
    the PNG."""
    a = sppm_parser(doc, resolution=resolution, iterations=iterations,
                    depth=depth, photons=photons,
                    output=output).parse_args(argv)
    from ..integrators.sppm import SPPMIntegrator

    t0 = time.perf_counter()
    scene = build_scene(device=a.device)
    t1 = time.perf_counter()
    cam = build_camera(a.resolution, a.output)
    integ = SPPMIntegrator(cam, initial_search_radius=radius,
                           max_depth=a.depth, n_iterations=a.iterations,
                           photons_per_iteration=a.photons, device=a.device)
    state = integ.render(scene)
    integ.save(state, a.iterations, a.output)
    t2 = time.perf_counter()
    print(f"wrote {a.output}: scene build {t1 - t0:.2f} s, {a.iterations} "
          f"SPPM iterations {t2 - t1:.2f} s on {a.device} (host clock, "
          f"the first iteration includes kernel builds)")


def _main(doc, build_scene, build_camera, make_integrator, *, resolution,
          spp, depth, output):
    a = parser(doc, resolution=resolution, spp=spp, depth=depth,
               output=output).parse_args()
    from ..sampler.uniform import UniformSampler

    t0 = time.perf_counter()
    scene = build_scene(device=a.device)
    t1 = time.perf_counter()
    cam = build_camera(a.resolution, a.output)
    integ = make_integrator(cam, UniformSampler(a.spp), a.depth)
    state = integ.render(scene)
    cam.film.save_png(state, a.output)
    t2 = time.perf_counter()
    print(f"wrote {a.output}: scene build {t1 - t0:.2f} s, render "
          f"{t2 - t1:.2f} s on {a.device} (host clock, first frame "
          f"includes kernel builds), queue_drops {integ.last_queue_drops}, "
          f"useful_rays {integ.last_useful_rays}")


def whitted_main(doc, build_scene, build_camera, *, resolution, spp=4,
                 depth=5, output="render.png"):
    from ..integrators.whitted import WhittedIntegrator

    _main(doc, build_scene, build_camera,
          lambda cam, s, d: WhittedIntegrator(cam, s, max_depth=d),
          resolution=resolution, spp=spp, depth=depth, output=output)


def path_main(doc, build_scene, build_camera, *, resolution, spp=4,
              depth=5, output="render.png"):
    from ..integrators.path import PathIntegrator

    _main(doc, build_scene, build_camera,
          lambda cam, s, d: PathIntegrator(cam, s, max_depth=d),
          resolution=resolution, spp=spp, depth=depth, output=output)
