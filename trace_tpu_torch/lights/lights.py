"""Light table (port of trace_tpu/lights/lights.py): point, spot, distant
and diffuse area lights.

The table is small, per-scene static host data: the wavefront visits
lights at static indices and reads each light's parameters as host
scalars. Environment (infinite) lights are not ported: ``pack_lights``
refuses them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

POINT = 0  # kind codes as in the JAX package
SPOT = 1
DISTANT = 2
AREA = 3
INFINITE = 4

DELTA_POSITION = 1
DELTA_DIRECTION = 2
LIGHT_AREA = 4
LIGHT_INFINITE = 8
_KIND_FLAGS = {POINT: DELTA_POSITION, SPOT: DELTA_POSITION,
               DISTANT: DELTA_DIRECTION, AREA: LIGHT_AREA,
               INFINITE: LIGHT_INFINITE}


@dataclass(frozen=True)
class Lights:
    kind: np.ndarray             # [L] int32
    flags: np.ndarray            # [L] int32
    p: np.ndarray                # [L, 3] world position
    i: np.ndarray                # [L, 3] intensity / radiance
    direction: np.ndarray        # [L, 3] toward a distant light
    w2l: np.ndarray              # [L, 4, 4]
    l2w: np.ndarray              # [L, 4, 4]
    cos_total_width: np.ndarray    # [L] spot
    cos_falloff_start: np.ndarray  # [L] spot
    tri_start: np.ndarray        # [L] int32 area-light triangle range
    tri_count: np.ndarray        # [L] int32
    total_area: np.ndarray       # [L]
    two_sided: np.ndarray        # [L] bool
    world_center: np.ndarray     # [3] scene bounding sphere (preprocess)
    world_radius: np.ndarray     # []


def point_light(light_to_world, intensity):
    return dict(kind=POINT, l2w=light_to_world, i=intensity)


def spot_light(light_to_world, intensity, total_width_deg, falloff_start_deg):
    return dict(kind=SPOT, l2w=light_to_world, i=intensity,
                cos_total_width=float(np.cos(np.deg2rad(total_width_deg))),
                cos_falloff_start=float(np.cos(np.deg2rad(falloff_start_deg))))


def distant_light(light_to_world, radiance, direction):
    return dict(kind=DISTANT, l2w=light_to_world, i=radiance,
                direction=direction)


def area_light(radiance, tri_start, tri_count, two_sided=False):
    """Diffuse area light over triangles [tri_start, tri_start + tri_count)
    of the scene's triangle table."""
    return dict(kind=AREA, i=radiance, tri_start=int(tri_start),
                tri_count=int(tri_count), two_sided=bool(two_sided))


def infinite_light(l2w=None, radiance=(1.0, 1.0, 1.0), image=None):
    """An environment light entry; ``pack_lights`` refuses it (not
    ported)."""
    return dict(kind=INFINITE, l2w=l2w, i=radiance, image=image)


def is_delta(lights: Lights) -> np.ndarray:
    return (lights.flags & (DELTA_POSITION | DELTA_DIRECTION)) != 0


def triangle_areas(tris) -> np.ndarray:
    c = np.cross(tris.v1 - tris.v0, tris.v2 - tris.v0)
    return 0.5 * np.sqrt((c * c).sum(-1)).astype(np.float32)


def make_lights(kind, p, i, tris=None, **fields) -> Lights:
    """The light table from per-light arrays: ``kind`` [L], ``p`` and
    ``i`` [L, 3], and any other field of Lights (the rest default as for
    a point light). ``flags`` follow from the kinds, an area light's
    ``total_area`` from its range of ``tris``."""
    kind = np.asarray(kind, np.int32).reshape(-1)
    n = kind.shape[0]
    for k in kind:
        if int(k) not in (POINT, SPOT, DISTANT, AREA):
            raise NotImplementedError(
                f"light kind {k} is not ported (environment lights are not)")
    ident = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    direction = np.zeros((n, 3), np.float32)
    direction[:, 2] = 1.0
    defaults = dict(direction=direction, w2l=ident, l2w=ident,
                    cos_total_width=np.zeros(n, np.float32),
                    cos_falloff_start=np.zeros(n, np.float32),
                    tri_start=np.zeros(n, np.int32),
                    tri_count=np.zeros(n, np.int32),
                    two_sided=np.zeros(n, bool))
    f = {k: np.asarray(fields.get(k, v)).astype(v.dtype).reshape(v.shape)
         for k, v in defaults.items()}
    total_area = np.zeros(n, np.float32)
    if (kind == AREA).any():
        if tris is None or tris.v0.shape[0] == 0:
            raise ValueError("an area light needs the scene's triangles")
        areas = triangle_areas(tris)
        for j in np.flatnonzero(kind == AREA):
            s, c = int(f["tri_start"][j]), int(f["tri_count"][j])
            total_area[j] = areas[s:s + c].sum()
    return Lights(
        kind=kind,
        flags=np.asarray([_KIND_FLAGS[int(k)] for k in kind],
                         np.int32).reshape(n),
        p=np.asarray(p, np.float32).reshape(n, 3),
        i=np.asarray(i, np.float32).reshape(n, 3),
        total_area=total_area, world_center=np.zeros(3, np.float32),
        world_radius=np.asarray(0.0, np.float32), **f)


def pack_lights(entries, tris=None) -> Lights:
    """Build the light table from entry dicts (the helpers above)."""
    n = len(entries)
    l2w = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    w2l = l2w.copy()
    f = dict(direction=np.zeros((n, 3), np.float32),
             cos_total_width=np.zeros(n, np.float32),
             cos_falloff_start=np.zeros(n, np.float32),
             tri_start=np.zeros(n, np.int32), tri_count=np.zeros(n, np.int32),
             two_sided=np.zeros(n, bool))
    f["direction"][:, 2] = 1.0
    for j, e in enumerate(entries):
        t = e.get("l2w")
        if t is not None:
            l2w[j] = np.asarray(t.m, np.float32)
            w2l[j] = np.asarray(t.inv_m, np.float32)
        if e["kind"] == DISTANT:
            dw = l2w[j][:3, :3] @ np.asarray(e["direction"], np.float32)
            f["direction"][j] = dw / np.linalg.norm(dw)
        for name in ("cos_total_width", "cos_falloff_start", "tri_start",
                     "tri_count", "two_sided"):
            if name in e:
                f[name][j] = e[name]
    return make_lights([e["kind"] for e in entries], l2w[:, :3, 3],
                       [e["i"] for e in entries], tris, l2w=l2w, w2l=w2l, **f)


def preprocess(lights: Lights, world_center, world_radius) -> Lights:
    """Attach the scene's bounding sphere (the distant light's disk; the
    reference forgets to)."""
    return replace(lights,
                   world_center=np.asarray(world_center, np.float32),
                   world_radius=np.asarray(world_radius, np.float32))


def num_lights(lights: Lights) -> int:
    return lights.kind.shape[0]


def power(lights: Lights) -> np.ndarray:
    """Per-light total power [L, 3], float32 on the host, in the JAX
    twin's operation order (point 4 pi I; spot I 2 pi (1 - (cfs + ctw) /
    2); distant pi r^2 I over the scene's bounding disk; area L A pi,
    twice that if two-sided)."""
    pi = np.float32(3.1415926535897932)
    i = lights.i.astype(np.float32)
    p_point = 4.0 * pi * i
    p_spot = i * (2.0 * pi * (1.0 - 0.5 * (lights.cos_falloff_start
                                            + lights.cos_total_width))
                  )[..., None]
    wr = np.float32(lights.world_radius)
    p_dist = i * (pi * (wr * wr))
    p_area = i * (lights.total_area * pi
                  * np.where(lights.two_sided, np.float32(2.0),
                             np.float32(1.0)))[..., None]
    out = np.where((lights.kind == SPOT)[:, None], p_spot, p_point)
    out = np.where((lights.kind == DISTANT)[:, None], p_dist, out)
    return np.where((lights.kind == AREA)[:, None], p_area,
                    out).astype(np.float32)
