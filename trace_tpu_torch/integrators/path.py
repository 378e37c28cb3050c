"""Path integrator (port of trace_tpu/integrators/path.py over the planar
wavefront; the JAX package's packed oracle is not ported: the port keeps
one stack)."""
from __future__ import annotations

import torch

from ..utils.stats import span
from ..wavefront import path as planar
from .base import PIXEL_CHUNK, SamplerIntegrator


class PathIntegrator(SamplerIntegrator):
    """NEE + MIS path tracer with Russian roulette after ``rr_depth``
    bounces, in chunks of ``pixel_chunk`` lanes (integrators/base.py).
    ``li_impl`` other than "auto"/"planar" raises. On the card, where
    ``replays`` holds (integrators/base.py), a view's frames after its
    first are replays of one CUDA graph; an instance whose ``frame_graph``
    is set False issues every frame eagerly, pass by pass (the same image,
    bit for bit). With ``stats`` (a utils.stats.RenderStats) a render is
    eager and also adds ``path_self_hits``, in one host read after it:
    continuations whose next hit is the primitive they left, within the
    spawn offset (core/ray.py::self_hits)."""

    frame_graph = True
    replay_span = "path.replay"

    def __init__(self, camera, sampler=None, max_depth: int = 5,
                 rr_depth: int = 3, pixel_chunk: int = PIXEL_CHUNK,
                 li_impl: str = "auto", stats=None):
        if li_impl not in ("auto", "planar"):
            raise NotImplementedError(
                f"li_impl={li_impl!r}: only the planar path is ported")
        super().__init__(camera, sampler, max_depth, pixel_chunk,
                         stats=stats)
        self.rr_depth = int(rr_depth)
        self._tally = None

    def graph_settings(self) -> tuple:
        """The base's settings (integrators/base.py), then the roulette
        depth."""
        return super().graph_settings() + (self.rr_depth,)

    def li(self, scene, rd, key):
        planar.supports(scene)
        return planar.li(scene, rd, key, self.max_depth, self.rr_depth,
                         tally=self._tally)

    def render(self, scene, **kw):
        if self.stats is None:
            return super().render(scene, **kw)
        self._tally = []
        try:
            state = super().render(scene, **kw)
        finally:
            tally, self._tally = self._tally, None
        zero = torch.zeros((), dtype=torch.int64, device=scene.device)
        with span("host_read"):
            self.stats.add("path_self_hits", int(sum(tally, zero)))
        return state
