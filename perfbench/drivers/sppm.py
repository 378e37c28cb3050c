"""SPPM iterations: ``SPPMIntegrator.render`` on the heightfield scene,
one iteration a step, each from the state the last one returned; judged
by reference/sppm.py, which recomputes the last iteration of the run from
the state before it."""
from __future__ import annotations

import contextlib
import time

from ..reference import sppm as ref
from . import scene as SC

STATE_FIELDS = ("ld", "tau", "radius", "n")


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
        self.state = self.prev = None
        self.it = 0

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
        self.args = args
        self.integ = tt.SPPMIntegrator(camera, seed=self.seed,
                                       device=self.device, **args)
        for _ in range(int(self.traffic["warm_steps"])):
            self.step()
        self.setup_marks = {"import_and_terrain": t1 - t0,
                            "scene_build": t2 - t1,
                            "warm": time.perf_counter() - t2}

    def step(self) -> None:
        import torch

        self.it += 1
        self.prev = self.state
        self.state = self.integ.render(self.scene, n_iterations=self.it,
                                       state=self.state,
                                       start_iteration=self.it)
        if self.state.ld.is_cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase_events(self):
        """CUDA events around the camera pass and the photon walk of each
        stepwise step: {"camera": [ms, ...], "photon": [...]}. A fused
        block replays its graph and calls neither: nothing is read."""
        import torch

        phases = {}
        if self.args.get("fused_iterations") or not torch.cuda.is_available():
            yield phases
            return
        integ = self.integ
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

        integ._camera_pass_all = timed("camera", integ._camera_pass_all)
        integ._photon_walk_all = timed("photon", integ._photon_walk_all)
        try:
            yield phases
        finally:
            del integ._camera_pass_all, integ._photon_walk_all
            torch.cuda.synchronize()
            for name, (a, b) in marks:
                phases.setdefault(name, []).append(a.elapsed_time(b))

    def output(self):
        """The states before and after the last iteration, on the host."""
        host = lambda st: {f: getattr(st, f).double().cpu().numpy()
                           for f in STATE_FIELDS}
        return {"it": self.it, "prev": host(self.prev),
                "state": host(self.state)}

    def release(self) -> None:
        self.state = self.prev = self.scene = self.integ = None

    def check(self, out, limits: dict) -> list:
        want = ref.iteration(self.desc, self.verts, self.n, self.resolution,
                             self.seed, out["it"], out["prev"], self.args,
                             limits, self.device)
        return ref.checks(out, want, limits)
