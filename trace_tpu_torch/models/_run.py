"""Scene-script entry points: ``python -m trace_tpu_torch.models.<scene>``
renders one PNG (port of trace_tpu/models/_run.py: whitted_main and
path_main)."""
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
