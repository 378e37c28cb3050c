"""Whitted integrator (port of trace_tpu/integrators/whitted.py; the
planar wavefront path)."""
from __future__ import annotations

from ..wavefront import whitted as planar
from .base import SamplerIntegrator


class WhittedIntegrator(SamplerIntegrator):
    """After ``render()``, ``last_queue_drops`` must be 0 for an
    energy-exact image.

    ``queue_capacity`` bounds the specular queue at ``max(queue_capacity,
    lanes)`` (default: the chunk's lanes), as the JAX package's planar li
    does; overflowing children are dropped and counted. ``level_caps``:
    optional queue capacities after levels 1..max_depth-1 instead. Entries
    are ints, or fractions (floats <= 1) of the lane count; a short tuple
    repeats its last entry. ``sort_materials``: each level's lanes in
    material order before shading (wavefront/whitted.py). ``li_impl``:
    "auto" or "planar"; the JAX package's "packed" oracle is not ported
    (the port keeps one stack) and raises. ``frame_graph``: on the card,
    where ``replays`` holds (integrators/base.py), a view's frames after
    its first are replays of one CUDA graph; False issues every frame
    eagerly, pass by pass (the same image, bit for bit)."""

    replay_span = "whitted.replay"

    def __init__(self, *args, queue_capacity: int | None = None,
                 sort_materials: bool = False, li_impl: str = "auto",
                 level_caps: tuple | None = None, frame_graph: bool = True,
                 **kw):
        if li_impl not in ("auto", "planar"):
            raise NotImplementedError(
                f"li_impl={li_impl!r}: only the planar path is ported")
        super().__init__(*args, **kw)
        self.queue_capacity = queue_capacity
        self.sort_materials = bool(sort_materials)
        self.li_impl = li_impl
        self.level_caps = level_caps
        self.frame_graph = bool(frame_graph)

    def graph_settings(self) -> tuple:
        """The base's settings (integrators/base.py), then queue capacity,
        level caps, material sort."""
        caps = self.level_caps
        return super().graph_settings() + (
            self.queue_capacity, None if caps is None else tuple(caps),
            self.sort_materials)

    def _resolve_caps(self, n: int):
        caps = self.level_caps
        if caps is None:
            return None
        vals = [int(c * n) if isinstance(c, float) and c <= 1.0 else int(c)
                for c in caps]
        while len(vals) < self.max_depth - 1:
            vals.append(vals[-1])
        return tuple(max(1, v) for v in vals[: max(self.max_depth - 1, 0)])

    def li(self, scene, rd, key):
        planar.supports(scene)
        return planar.li(scene, rd, key, self.max_depth,
                         level_caps=self._resolve_caps(rd.o.shape[0]),
                         queue_capacity=self.queue_capacity,
                         sort_materials=self.sort_materials)
