"""Light table (port of trace_tpu/lights/lights.py, point lights).

The table is small, per-scene static host data: the wavefront visits
lights at static indices and reads each light's parameters as host
scalars. Spot, distant, area and environment lights are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

POINT = 0  # kind codes as in the JAX package


@dataclass(frozen=True)
class Lights:
    kind: np.ndarray          # [L] int32
    p: np.ndarray             # [L, 3] world position
    i: np.ndarray             # [L, 3] intensity
    world_center: np.ndarray  # [3] scene bounding sphere (preprocess)
    world_radius: np.ndarray  # []


def point_light(light_to_world, intensity):
    return dict(kind=POINT, l2w=light_to_world, i=intensity)


def pack_lights(entries) -> Lights:
    n = len(entries)
    p = np.zeros((n, 3), np.float32)
    i = np.zeros((n, 3), np.float32)
    for j, e in enumerate(entries):
        if e["kind"] != POINT:
            raise NotImplementedError(
                f"light kind {e['kind']} is not ported yet (point only)")
        i[j] = np.asarray(e["i"], np.float32)
        p[j] = np.asarray(e["l2w"].m, np.float32)[:3, 3]
    return Lights(np.full(n, POINT, np.int32), p, i,
                  np.zeros(3, np.float32), np.asarray(0.0, np.float32))


def preprocess(lights: Lights, world_center, world_radius) -> Lights:
    """Attach the scene's bounding sphere (the reference forgets to)."""
    return replace(lights,
                   world_center=np.asarray(world_center, np.float32),
                   world_radius=np.asarray(world_radius, np.float32))


def num_lights(lights: Lights) -> int:
    return lights.kind.shape[0]
