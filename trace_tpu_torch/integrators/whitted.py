"""Whitted integrator (port of trace_tpu/integrators/whitted.py; the
planar wavefront path)."""
from __future__ import annotations

from ..wavefront import whitted as planar
from .base import SamplerIntegrator


class WhittedIntegrator(SamplerIntegrator):
    """After ``render()``, ``last_queue_drops`` must be 0 for an
    energy-exact image (the specular queue holds one lane per sample)."""

    def li(self, scene, rd, keys):
        return planar.li(scene, rd, keys, self.max_depth)
