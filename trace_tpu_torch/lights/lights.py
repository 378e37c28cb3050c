"""Light table (port of trace_tpu/lights/lights.py): point, spot, distant,
diffuse area and environment (infinite) lights.

The table is small, per-scene static host data: the wavefront visits
lights at static indices and reads each light's parameters as host
scalars. An environment light is an equal-rect radiance image, one per
scene, carried in the table's ``env_*`` fields with its texel pick pmf
and Vose alias table; scenes without one carry 1-texel dummies.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

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
    env_rgb: np.ndarray          # [K, 3] equal-rect radiance texels, rows
    #                              theta from the light frame's +z
    env_pmf: np.ndarray          # [K] texel pick pmf (sin-theta weighted)
    env_prob: np.ndarray         # [K] alias-table acceptance probability
    env_alias: np.ndarray        # [K] int32 alias-table partner texel
    env_h: np.ndarray            # [] int32 image height
    env_w: np.ndarray            # [] int32 image width


def has_env(lights: Lights) -> bool:
    """Whether the table holds an environment light: its tables have at
    least 2 texels (a constant sky is stored as 2), the dummies 1."""
    return lights.env_pmf.shape[0] > 1


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
    """Image-based environment light. ``image``: [H, W, 3] linear
    equal-rect radiance (rows = theta from the light frame's +z, columns
    = phi), or None for a constant sky; ``radiance`` scales either. At
    most one per scene."""
    img = None if image is None else np.asarray(image, np.float32)
    return dict(kind=INFINITE, l2w=l2w, i=radiance, image=img)


def _alias_table(pmf: np.ndarray):
    """Vose alias table over a pmf -> (prob [K] f32, alias [K] i32)."""
    k = pmf.size
    scaled = (pmf * k).astype(np.float64)
    prob = np.ones(k, np.float64)
    alias = np.arange(k, dtype=np.int64)
    small = [i for i in range(k) if scaled[i] < 1.0]
    large = [i for i in range(k) if scaled[i] >= 1.0]
    while small and large:
        s, big = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = big
        scaled[big] -= 1.0 - scaled[s]
        (small if scaled[big] < 1.0 else large).append(big)
    return prob.astype(np.float32), alias.astype(np.int32)


def env_tables(image=None, radiance=(1.0, 1.0, 1.0)) -> dict:
    """An environment light's tables (the env_* fields of Lights) and its
    mean radiance ``i`` (what ``power`` reads), from an [H, W, 3] image or
    a constant sky (None), scaled by ``radiance``. The texel pmf is
    luminance times sin(theta) of the row (uniform for a black image)."""
    img = np.ones((1, 1, 3), np.float32) if image is None else image
    img = img * np.asarray(radiance, np.float32)
    if img.shape[0] * img.shape[1] < 2:
        img = np.tile(img, (1, 2, 1))   # >= 2 texels: has_env reads shapes
    h, w = int(img.shape[0]), int(img.shape[1])
    rgb = img.reshape(-1, 3).astype(np.float32)
    lum = rgb @ np.array([0.212671, 0.715160, 0.072169], np.float32)
    sin_t = np.sin(np.pi * (np.arange(h, dtype=np.float64) + 0.5) / h
                   ).astype(np.float32)
    wgt = (lum.reshape(h, w) * sin_t[:, None]).reshape(-1).astype(np.float64)
    total = wgt.sum()
    pmf = wgt / total if total > 0 else np.full(wgt.size, 1.0 / wgt.size)
    prob, alias = _alias_table(pmf)
    return dict(env_rgb=rgb, env_pmf=pmf.astype(np.float32), env_prob=prob,
                env_alias=alias, env_h=np.asarray(h, np.int32),
                env_w=np.asarray(w, np.int32), i=rgb.mean(axis=0))


_NO_ENV = dict(env_rgb=np.zeros((1, 3), np.float32),
               env_pmf=np.ones(1, np.float32), env_prob=np.ones(1, np.float32),
               env_alias=np.zeros(1, np.int32), env_h=np.asarray(1, np.int32),
               env_w=np.asarray(1, np.int32))


def is_delta(lights: Lights) -> np.ndarray:
    return (lights.flags & (DELTA_POSITION | DELTA_DIRECTION)) != 0


def triangle_areas(tris) -> np.ndarray:
    c = np.cross(tris.v1 - tris.v0, tris.v2 - tris.v0)
    return 0.5 * np.sqrt((c * c).sum(-1)).astype(np.float32)


def make_lights(kind, p, i, tris=None, **fields) -> Lights:
    """The light table from per-light arrays: ``kind`` [L], ``p`` and
    ``i`` [L, 3], and any other field of Lights (the rest default as for
    a point light). ``flags`` follow from the kinds, an area light's
    ``total_area`` from its range of ``tris``. An environment light
    (kind INFINITE, at most one) comes with the ``env_*`` fields
    (``env_tables``), its ``i`` their mean radiance."""
    kind = np.asarray(kind, np.int32).reshape(-1)
    n = kind.shape[0]
    for k in kind:
        if int(k) not in _KIND_FLAGS:
            raise ValueError(f"unknown light kind {k}")
    n_env = int((kind == INFINITE).sum())
    if n_env > 1:
        raise ValueError("at most one environment light per scene")
    env = {k: np.asarray(fields.pop(k, v)).astype(v.dtype)
           for k, v in _NO_ENV.items()}
    if (env["env_pmf"].shape[0] > 1) != bool(n_env):
        raise ValueError("env_* tables need exactly one INFINITE light")
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
        world_radius=np.asarray(0.0, np.float32), **f, **env)


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
    i = np.array([np.asarray(e["i"], np.float32).reshape(3)
                  for e in entries], np.float32).reshape(n, 3)
    for j, e in enumerate(entries):
        t = e.get("l2w")
        if t is not None:
            l2w[j] = np.asarray(t.m, np.float32)
            w2l[j] = np.asarray(t.inv_m, np.float32)
        if e["kind"] == DISTANT:
            dw = l2w[j][:3, :3] @ np.asarray(e["direction"], np.float32)
            f["direction"][j] = dw / np.linalg.norm(dw)
        if e["kind"] == INFINITE:
            if "env_pmf" in f:
                raise ValueError("at most one environment light per scene")
            env = env_tables(e.get("image"), e["i"])
            i[j] = env.pop("i")   # the image's mean radiance
            f.update(env)
        for name in ("cos_total_width", "cos_falloff_start", "tri_start",
                     "tri_count", "two_sided"):
            if name in e:
                f[name][j] = e[name]
    return make_lights([e["kind"] for e in entries], l2w[:, :3, 3], i, tris,
                       l2w=l2w, w2l=w2l, **f)


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
    2); distant, and an environment light's mean radiance, pi r^2 I over
    the scene's bounding disk; area L A pi, twice that if two-sided)."""
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
    far = (lights.kind == DISTANT) | (lights.kind == INFINITE)
    out = np.where(far[:, None], p_dist, out)
    return np.where((lights.kind == AREA)[:, None], p_area,
                    out).astype(np.float32)


# ---------------------------------------------------------------------------
# Blackbody emission (the reference's emission.jl:12-58)
# ---------------------------------------------------------------------------


def blackbody(wavelengths_nm, temperature) -> torch.Tensor:
    """Planck's law radiance, float32, for wavelengths in nm (a tensor,
    or anything ``torch.as_tensor`` takes, on its device)."""
    lam = torch.as_tensor(wavelengths_nm, dtype=torch.float32) * 1e-9
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    return (2.0 * h * c * c) / (
        lam ** 5 * (torch.exp((h * c) / (lam * kb * temperature)) - 1.0))


def blackbody_normalized(wavelengths_nm, temperature) -> torch.Tensor:
    """``blackbody`` divided by its peak (Wien's displacement law), so the
    peak is 1."""
    le = blackbody(wavelengths_nm, temperature)
    lam_max = 2.8977721e-3 / temperature * 1e9
    peak = blackbody(torch.tensor([lam_max], dtype=torch.float32,
                                  device=le.device), temperature)
    return le / peak[0]
