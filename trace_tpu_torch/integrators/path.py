"""Path integrator (port of trace_tpu/integrators/path.py over the planar
wavefront; the JAX package's packed oracle is not ported: the port keeps
one stack)."""
from __future__ import annotations

from ..wavefront import path as planar
from .base import PIXEL_CHUNK, SamplerIntegrator


class PathIntegrator(SamplerIntegrator):
    """NEE + MIS path tracer with Russian roulette after ``rr_depth``
    bounces, in chunks of ``pixel_chunk`` lanes (integrators/base.py).
    ``li_impl`` other than "auto"/"planar" raises."""

    def __init__(self, camera, sampler=None, max_depth: int = 5,
                 rr_depth: int = 3, pixel_chunk: int = PIXEL_CHUNK,
                 li_impl: str = "auto", stats=None):
        if li_impl not in ("auto", "planar"):
            raise NotImplementedError(
                f"li_impl={li_impl!r}: only the planar path is ported")
        super().__init__(camera, sampler, max_depth, pixel_chunk,
                         stats=stats)
        self.rr_depth = int(rr_depth)

    def li(self, scene, rd, key):
        planar.supports(scene)
        return planar.li(scene, rd, key, self.max_depth, self.rr_depth)
