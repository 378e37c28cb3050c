"""Whitted integrator (port of trace_tpu/integrators/whitted.py; the
planar wavefront path)."""
from __future__ import annotations

from ..wavefront import whitted as planar
from .base import SamplerIntegrator


class WhittedIntegrator(SamplerIntegrator):
    """After ``render()``, ``last_queue_drops`` must be 0 for an
    energy-exact image.

    ``level_caps``: optional queue capacities after levels 1..max_depth-1
    (the default holds one lane per camera ray at every level). Entries
    are ints, or fractions (floats <= 1) of the lane count; a short tuple
    repeats its last entry."""

    def __init__(self, *args, level_caps: tuple | None = None, **kw):
        super().__init__(*args, **kw)
        self.level_caps = level_caps

    def _resolve_caps(self, n: int):
        caps = self.level_caps
        if caps is None:
            return None
        vals = [int(c * n) if isinstance(c, float) and c <= 1.0 else int(c)
                for c in caps]
        while len(vals) < self.max_depth - 1:
            vals.append(vals[-1])
        return tuple(max(1, v) for v in vals[: max(self.max_depth - 1, 0)])

    def li(self, scene, rd, keys):
        planar.supports(scene)
        return planar.li(scene, rd, keys, self.max_depth,
                         level_caps=self._resolve_caps(rd.o.shape[0]))
