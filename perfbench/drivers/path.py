"""Path-traced frames: ``PathIntegrator.render`` on the Cornell box, one
frame a step (the eager route: the path tracer does not opt in to the
frame graph); judged by reference/path.py."""
from __future__ import annotations

import contextlib
import time

from ..reference import path as ref
from ..scenes import box
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
        self.undo = None

    def setup(self) -> None:
        t0 = time.perf_counter()
        import trace_tpu_torch as tt

        t1 = time.perf_counter()
        self.scene = box.build_scene(self.desc, self.device)
        if self.control is not None:
            self.undo = self.control(self.scene)
        t2 = time.perf_counter()
        camera = SC.build_camera(self.desc, self.resolution)
        args = dict(self.config["integrator_args"])
        args.update(self.traffic.get("integrator_args", {}))
        spp = int(args.pop("spp"))
        self.integ = tt.PathIntegrator(
            camera, tt.UniformSampler(spp, seed=self.seed), **args)
        self.args = dict(args, spp=spp)
        for _ in range(int(self.traffic["warm_steps"])):
            self.step()
        self.setup_marks = {"import": t1 - t0, "scene_build": t2 - t1,
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
        """CUDA events around each ``PathIntegrator.li`` call (a sample
        pass's paths) and each ``wavefront/path.py::estimate_direct``
        call (a bounce's light leg and BSDF-sampling MIS leg): {"li":
        [ms, ...], "direct": [...]}. Nothing is read where the render
        replays a graph or runs on the CPU."""
        import torch

        from trace_tpu_torch.wavefront import path as WP

        phases = {}
        if self.scene.device.type != "cuda" or self.integ.replays(self.scene):
            yield phases
            return
        marks = []

        def timed(name, fn):
            def call(*a, **k):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = fn(*a, **k)
                ev[1].record()
                marks.append((name, ev))
                return out
            return call

        integ = self.integ
        direct = WP.estimate_direct
        integ.li = timed("li", integ.li)
        WP.estimate_direct = timed("direct", direct)
        try:
            yield phases
        finally:
            del integ.li
            WP.estimate_direct = direct
            torch.cuda.synchronize()
            for name, (a, b) in marks:
                phases.setdefault(name, []).append(a.elapsed_time(b))

    def output(self):
        """The last frame's film: (xyz sums [H, W, 3], weight sums)."""
        return (self.state.xyz.double().cpu().numpy(),
                self.state.weight_sum.double().cpu().numpy())

    def release(self) -> None:
        if self.undo is not None:
            self.undo()
        self.state = self.scene = self.integ = self.undo = None

    def check(self, out, limits: dict) -> list:
        want, mask = ref.render(self.desc, self.resolution, self.seed,
                                self.args, self.device)
        return ref.checks(out, want, mask, limits)
