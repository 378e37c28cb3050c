"""Whitted frames: ``WhittedIntegrator.render`` on the heightfield scene,
one frame a step; judged by reference/whitted.py."""
from __future__ import annotations

import contextlib
import time

from ..reference import compare
from ..reference import whitted as ref
from . import scene as SC


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 control=None):
        self.control = control
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = device
        self.desc = config["scene"]
        self.resolution = int(traffic["resolution"])
        self.state = None

    def setup(self) -> None:
        t0 = time.perf_counter()
        import trace_tpu_torch as tt

        self.verts, tris, self.n = SC.terrain(self.desc)
        t1 = time.perf_counter()
        self.scene = SC.build_scene(self.desc, self.device, self.verts, tris)
        if self.control is not None:
            self.control(self.scene, tris)
        t2 = time.perf_counter()
        camera = SC.build_camera(self.desc, self.resolution)
        args = dict(self.config["integrator_args"])
        args.update(self.traffic.get("integrator_args", {}))
        spp = int(args.pop("spp"))
        self.integ = tt.WhittedIntegrator(
            camera, tt.UniformSampler(spp, seed=self.seed), **args)
        for _ in range(int(self.traffic["warm_steps"])):
            self.step()
        self.setup_marks = {"import_and_terrain": t1 - t0,
                            "scene_build": t2 - t1,
                            "warm": time.perf_counter() - t2}

    def step(self) -> None:
        import torch

        self.state = self.integ.render(self.scene)
        if self.integ.last_queue_drops:
            raise RuntimeError(f"queue drops: {self.integ.last_queue_drops}")
        if self.state.xyz.is_cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase_events(self):
        yield {}

    def output(self):
        """The last frame's film: (xyz sums [H, W, 3], weight sums)."""
        return (self.state.xyz.double().cpu().numpy(),
                self.state.weight_sum.double().cpu().numpy())

    def release(self) -> None:
        self.state = self.scene = self.integ = None

    def check(self, out, limits: dict) -> list:
        want = ref.render(self.desc, self.verts, self.n, self.resolution,
                          self.seed, self.device)
        return compare.film_checks(out, want, limits)
