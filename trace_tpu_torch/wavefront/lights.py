"""Light sampling on planar state (port of trace_tpu/wavefront/lights.py:
point, spot, distant and area lights, and the emission of area lights;
and of the environment light's lookups and samplers in
trace_tpu/lights/lights.py, which the JAX package runs on its packed
path only).

Each light's sampler runs at a static index, its kind, triangle range
and parameters host scalars from the scene's light table; the per-lane
forms (``*_lanes``) take a light index per lane, run every light's
static sampler (tensor code, no ray traced) and keep each lane's own, or
gather the lane's light row on the device (trace_tpu/lights/lights.py's
per-lane sample_li, pdf_li, le_area, le_inf and sample_le). An area
light's windowed area CDF is built on the host in numpy, in float32,
exactly as the JAX package builds it, so light picks agree at bucket
edges.

The environment light's texel tables live on the scene's device
(``EnvTables``). Its lookups keep the JAX package's association order
(the multiply by 0.5/pi before the one by the width), and divide by the
image's width and height as device tensors: CUDA computes a division by
a host scalar as a multiply by its reciprocal, which would put a texel
in another row on the card than on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vec as V
from ..core.vec import V3
from ..lights import lights as L
from ..shapes import triangle as tri_mod

F32 = torch.float32


_F = np.float32
PI = V.PI
TWO_PI = float(_F(2.0) * _F(PI))
TWO_PI2 = float(_F(2.0) * _F(PI) * _F(PI))
HALF_INV_PI = float(_F(0.5) / _F(PI))
INV_PI = float(_F(1.0) / _F(PI))
ONE_MINUS = float(_F(1.0 - 1e-7))


class EnvTables(NamedTuple):
    """An environment light's tables on the scene's device."""
    rgb: torch.Tensor     # [K, 3] texel radiance
    pmf: torch.Tensor     # [K] texel pick pmf
    prob: torch.Tensor    # [K] alias acceptance probability
    alias: torch.Tensor   # [K] int64 alias partner
    h: torch.Tensor       # [] f32 image height (a device divisor)
    w: torch.Tensor       # [] f32 image width
    hf: float             # the height, width and texels as host numbers
    wf: float
    k: int


def device_env(lights: L.Lights, device) -> EnvTables | None:
    """The table's environment light on ``device``; None without one."""
    if not L.has_env(lights):
        return None
    dev = torch.device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    h, w = int(lights.env_h), int(lights.env_w)
    return EnvTables(t(lights.env_rgb), t(lights.env_pmf),
                     t(lights.env_prob), t(lights.env_alias).long(),
                     torch.tensor(float(h), dtype=F32, device=dev),
                     torch.tensor(float(w), dtype=F32, device=dev),
                     float(h), float(w), h * w)


def _unit(v: V3) -> V3:
    """Normalize by a division, as the JAX package's packed normalize
    does (``V3.normalize`` multiplies by the reciprocal)."""
    n = v.length()
    n = torch.where(n == 0.0, 1.0, n)
    return V3(v.x / n, v.y / n, v.z / n)


def _rows3(r) -> list:
    return [[float(r[a, c]) for c in range(3)] for a in range(3)]


def _env_uv_cell(env: EnvTables, wl: V3):
    """Light-space unit direction -> (sin theta [N], texel [N] int64)."""
    theta = torch.acos(wl.z.clamp(-1.0, 1.0))
    phi = torch.atan2(wl.y, wl.x)
    phi = torch.where(phi < 0, phi + TWO_PI, phi)
    w, h = env.wf, env.hf
    x = torch.floor(phi * HALF_INV_PI * w).clamp(0.0, w - 1.0)
    y = torch.floor(theta * INV_PI * h).clamp(0.0, h - 1.0)
    # A NaN direction (a masked lane) reads texel 0, not an index that
    # would trap on the card.
    return torch.sin(theta), torch.nan_to_num(y * w + x).long()


def _env_pdf(env: EnvTables, cell, sin_theta):
    """Solid-angle pdf of the env sampler at a texel: pmf H W / (2 pi^2
    sin theta), 0 at the poles."""
    p = (env.pmf[cell] * float(env.k)) / (
        TWO_PI2 * sin_theta.clamp_min(1e-9))
    return torch.where(sin_theta > 1e-9, p, 0.0)


def _env_sample_cell(env: EnvTables, u0):
    """One uniform -> (texel [N] int64, a fresh uniform [N]) through the
    alias table; the alias coin is rescaled into the fresh uniform."""
    x = u0 * env.k
    c = torch.floor(x).clamp(0.0, env.k - 1.0)
    f = x - c
    c = c.long()
    p_c = env.prob[c]
    take = f >= p_c
    cell = torch.where(take, env.alias[c], c)
    f2 = torch.where(take, (f - p_c) / (1.0 - p_c).clamp_min(1e-9),
                     f / p_c.clamp_min(1e-9))
    return cell, f2.clamp(0.0, ONE_MINUS)


def _env_sample_dir(env: EnvTables, l2w, u0, u1):
    """Importance-sample a world direction toward the environment ->
    (wi V3, radiance V3, solid-angle pdf [N]); ``l2w`` [4, 4] host."""
    cell, fu = _env_sample_cell(env, u0)
    cf = cell.to(F32)
    row = torch.floor(cf / env.w)
    col = cf - row * env.wf
    phi = (TWO_PI * (col + fu)) / env.w
    theta = (PI * (row + u1)) / env.h
    st = torch.sin(theta)
    wl = V3(st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta))
    wi = _unit(V.mat3_apply(_rows3(l2w), wl))
    return wi, _texels(env, cell), _env_pdf(env, cell, st)


def _texels(env: EnvTables, cell) -> V3:
    g = env.rgb[cell]
    return V3(g[:, 0], g[:, 1], g[:, 2])


def env_index(scene) -> int:
    """The scene's environment light's index (there is at most one)."""
    return int(np.flatnonzero(scene.lights.kind == L.INFINITE)[0])


def _env_lookup(scene, rot, wi: V3):
    """(sin theta [N], texel [N]) of the environment along world ``wi``,
    rotated into the light's frame by ``rot`` ([4, 4] host w2l)."""
    return _env_uv_cell(scene.env, _unit(V.mat3_apply(_rows3(rot), wi)))


def env_le(scene, d: V3) -> V3:
    """Environment radiance along escaped rays ``d`` (the scene must hold
    an environment light)."""
    # The JAX package sums the lights' masked w2l, which makes a -0.0
    # entry +0.0; adding 0.0 does the same.
    rot = scene.lights.w2l[env_index(scene)] + _F(0.0)
    return _texels(scene.env, _env_lookup(scene, rot, _unit(d))[1])


def le_inf(scene, j: int, wi: V3) -> V3:
    """Environment light ``j``'s radiance along ``wi`` (the BSDF-sampling
    MIS leg's Le)."""
    return _texels(scene.env, _env_lookup(scene, scene.lights.w2l[j], wi)[1])


def pdf_li_env(scene, j: int, wi: V3):
    """Solid-angle pdf that environment light ``j`` samples ``wi``."""
    st, cell = _env_lookup(scene, scene.lights.w2l[j], _unit(wi))
    return _env_pdf(scene.env, cell, st)


def light_count(scene) -> int:
    return L.num_lights(scene.lights)


def kind_of(scene, j: int) -> int:
    return int(scene.lights.kind[j])


def _full3(n, v, device) -> V3:
    return V3.full((n,), v[0], v[1], v[2], device)


def _spot_falloff(w2l, ctw, cfs, w: V3):
    """Spot falloff delta^4; ``w2l`` [4, 4], ``ctw``/``cfs`` float32 host
    scalars."""
    r = [[float(w2l[a, c]) for c in range(3)] for a in range(3)]
    cos_t = V.mat3_apply(r, w).normalize().z
    denom = float(max(np.float32(cfs) - np.float32(ctw), np.float32(1e-12)))
    d = (cos_t - float(ctw)) / denom
    d = d.clamp(0.0, 1.0)
    d2 = d * d
    f = torch.where(cos_t < float(ctw), 0.0, d2 * d2)
    return torch.where(cos_t >= float(cfs), 1.0, f)


def sample_li_static(scene, j: int, p_ref: V3, u0, u1):
    """sample_li for static light ``j`` -> (radiance V3, wi V3, pdf [N],
    p_light V3). ``u0``/``u1`` are read by area and environment lights
    only."""
    lights = scene.lights
    kind = kind_of(scene, j)
    n = p_ref.x.shape[0]
    dev = p_ref.x.device
    i_rgb = lights.i[j]

    if kind in (L.POINT, L.SPOT):
        p_light = _full3(n, lights.p[j], dev)
        to_l = p_light - p_ref
        dist2 = to_l.length_squared().clamp_min(1e-20)
        inv_d = 1.0 / torch.sqrt(dist2)
        wi = to_l * inv_d
        inv2 = 1.0 / dist2
        rad = V3(float(i_rgb[0]) * inv2, float(i_rgb[1]) * inv2,
                 float(i_rgb[2]) * inv2)
        if kind == L.SPOT:
            rad = rad * _spot_falloff(lights.w2l[j],
                                      lights.cos_total_width[j],
                                      lights.cos_falloff_start[j], -wi)
        return rad, wi, torch.ones((n,), dtype=F32, device=dev), p_light

    if kind == L.DISTANT:
        wi = _full3(n, lights.direction[j], dev)
        p_light = p_ref + wi * float(2.0 * lights.world_radius)
        return (_full3(n, i_rgb, dev), wi,
                torch.ones((n,), dtype=F32, device=dev), p_light)

    if kind == L.AREA:
        p_a, n_a = _sample_area_point_static(
            scene, int(lights.tri_start[j]), int(lights.tri_count[j]), u0, u1)
        to_a = p_a - p_ref
        d2_a = to_a.length_squared().clamp_min(1e-20)
        wi_a = to_a * (1.0 / torch.sqrt(d2_a))
        cos_l = n_a.dot(-wi_a)
        if bool(lights.two_sided[j]):
            emits = cos_l.abs() > 1e-9
        else:
            emits = cos_l > 1e-9
        area = float(max(float(lights.total_area[j]), 1e-20))
        pdf_a = d2_a / (cos_l.abs() * area).clamp_min(1e-20)
        rad = V.where(emits, _full3(n, i_rgb, dev), 0.0)
        return rad, wi_a, pdf_a, p_a

    if kind == L.INFINITE:
        wi, rad, pdf = _env_sample_dir(scene.env, lights.l2w[j], u0, u1)
        p_light = p_ref + wi * float(2.0 * lights.world_radius)
        return rad, wi, pdf, p_light

    raise ValueError(f"unknown light kind {kind}")


def sample_le_static(scene, j: int, u0x, u0y, u1x, u1y, time):
    """Photon emission from static light ``j`` -> (le V3, o V3, d V3,
    n_light V3, pdf_pos [N], pdf_dir [N]). ``time`` is unused (static
    lights)."""
    lights = scene.lights
    kind = kind_of(scene, j)
    n = u0x.shape[0]
    dev = u0x.device
    i_v = _full3(n, lights.i[j], dev)
    ones = torch.ones((n,), dtype=F32, device=dev)

    if kind == L.POINT:
        d = V.uniform_sample_sphere(u0x, u0y)
        o = _full3(n, lights.p[j], dev)
        pdf_dir = ones * float(np.float32(1.0 / (4.0 * np.pi)))
        return i_v, o, d, d, ones, pdf_dir

    if kind == L.SPOT:
        ctw = np.float32(lights.cos_total_width[j])
        cfs = np.float32(lights.cos_falloff_start[j])
        d_cone = V.uniform_sample_cone(u0x, u0y, float(ctw))
        l2w = lights.l2w[j]
        r = [[float(l2w[a, c]) for c in range(3)] for a in range(3)]
        d = V.mat3_apply(r, d_cone).normalize()
        o = _full3(n, lights.p[j], dev)
        le = i_v * _spot_falloff(lights.w2l[j], ctw, cfs, d)
        pdf = np.float32(1.0) / (np.float32(2.0) * np.float32(np.pi)
                                 * (np.float32(1.0) - ctw))
        return le, o, d, d, ones, torch.full((n,), float(pdf), dtype=F32,
                                             device=dev)

    if kind == L.DISTANT:
        dv = _full3(n, lights.direction[j], dev)
        wr = float(np.float32(lights.world_radius))
        _, v1, v2 = V.coordinate_system(dv)
        cdx, cdy = V.concentric_sample_disk(u0x, u0y)
        o = _full3(n, lights.world_center, dev) + (v1 * cdx + v2 * cdy) * wr \
            + dv * wr
        pi = np.float32(np.pi)
        wr32 = np.float32(lights.world_radius)
        pdf_pos = np.float32(1.0) / max(pi * wr32 * wr32, np.float32(1e-20))
        return i_v, o, -dv, -dv, ones * float(pdf_pos), ones

    if kind == L.AREA:
        total_area = float(lights.total_area[j])
        two = bool(lights.two_sided[j])
        p_a, n_a = _sample_area_point_static(
            scene, int(lights.tri_start[j]), int(lights.tri_count[j]),
            u0x, u0y)
        if two:
            back = u1x < 0.5
            u1x_r = torch.where(back, u1x * 2.0, (u1x - 0.5) * 2.0
                                ).clamp_max(float(np.float32(1.0 - 1e-7)))
        else:
            back = torch.zeros((n,), dtype=torch.bool, device=dev)
            u1x_r = u1x
        w_local = V.cosine_sample_hemisphere(u1x_r, u1y)
        wz = torch.where(back, -w_local.z, w_local.z)
        _, t1, t2 = V.coordinate_system(n_a)
        d = t1 * w_local.x + t2 * w_local.y + n_a * wz
        pdf_pos = ones * float(np.float32(1.0 / max(total_area, 1e-20)))
        pdf_dir = wz.abs() * float(np.float32(1.0 / np.pi)) * (
            0.5 if two else 1.0)
        return i_v, p_a, d, n_a, pdf_pos, pdf_dir

    if kind == L.INFINITE:
        # A direction toward the sky, then a world-radius disk on its side
        # emitting back through the scene (as for a distant light).
        w_to, le, pdf_dir = _env_sample_dir(scene.env, lights.l2w[j], u0x,
                                            u0y)
        wr = float(np.float32(lights.world_radius))
        _, v1, v2 = V.coordinate_system(w_to)
        cdx, cdy = V.concentric_sample_disk(u1x, u1y)
        o = _full3(n, lights.world_center, dev) + (v1 * cdx + v2 * cdy) * wr \
            + w_to * wr
        pi = np.float32(np.pi)
        wr32 = np.float32(lights.world_radius)
        pdf_pos = np.float32(1.0) / max(pi * wr32 * wr32, np.float32(1e-20))
        return le, o, -w_to, -w_to, ones * float(pdf_pos), pdf_dir

    raise ValueError(f"unknown light kind {kind}")


def area_cdf(tris, tri_start: int, tri_count: int) -> np.ndarray:
    """Host float32 area CDF over one light's triangle window."""
    areas = L.triangle_areas(tris)[tri_start:tri_start + tri_count]
    return (np.cumsum(areas) / max(areas.sum(), 1e-20)).astype(np.float32)


def _area_tables(scene, tri_start: int, tri_count: int):
    """(cdf [M], lower bucket edges [M], vertex rows [M, 10]) on the
    scene's device, built once per light window (per frame for animated
    geometry, whose window is first read back to the host)."""
    cache = scene.area_tables
    key = (tri_start, tri_count)
    if key not in cache:
        s = slice(tri_start, tri_start + tri_count)
        tris = scene.triangles
        if torch.is_tensor(tris.v0):
            tris = tri_mod.to_numpy(tri_mod.Triangles(*[x[s] for x in tris]))
            s = slice(0, tri_count)
        cdf = area_cdf(tris, s.start, tri_count)
        lo = np.concatenate([np.zeros(1, np.float32), cdf[:-1]])
        rows = np.concatenate(
            [tris.v0[s], tris.v1[s], tris.v2[s],
             tris.flip_normal[s, None].astype(np.float32)], axis=1)
        dev = scene.device
        cache[key] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in (cdf, lo, rows))
    return cache[key]


def _sample_area_point_static(scene, tri_start: int, tri_count: int, u0, u1):
    """Uniform-by-area point on a light's triangles -> (p V3, n V3)."""
    cdf, lo_t, rows = _area_tables(scene, tri_start, tri_count)
    pick = (cdf[None, :] < u0[:, None]).to(torch.int32).sum(1)
    pick = pick.clamp(0, tri_count - 1).long()
    lo = lo_t[pick]
    hi = cdf[pick]
    u0r = ((u0 - lo) / (hi - lo).clamp_min(1e-12)).clamp(0.0, 1.0)
    gt = rows[pick].T
    gv0 = V3(gt[0], gt[1], gt[2])
    gv1 = V3(gt[3], gt[4], gt[5])
    gv2 = V3(gt[6], gt[7], gt[8])
    su0 = torch.sqrt(u0r)
    b0 = 1.0 - su0
    b1 = u1 * su0
    p_l = gv0 * (1.0 - b0 - b1) + gv1 * b0 + gv2 * b1
    n_l = (gv1 - gv0).cross(gv2 - gv0).normalize()
    return p_l, V.where(gt[9] != 0.0, -n_l, n_l)


def _select(sel, new, old):
    """Per lane, ``new`` where ``sel`` holds, else ``old`` (V3s or
    tensors, elementwise over two tuples)."""
    return tuple(V.where(sel, a, b) if isinstance(a, V3)
                 else torch.where(sel, a, b) for a, b in zip(new, old))


def _rows_of(scene, idx):
    """The light rows (radiance rgb, kind, two_sided, total_area) of each
    lane's light ``idx`` [N], as [6, N]."""
    return scene.light_rows[idx.long()].T


def is_delta_lanes(scene, idx):
    """Whether each lane's light ``idx`` [N] is a delta light."""
    kind = _rows_of(scene, idx)[3]
    return ((kind == float(L.POINT)) | (kind == float(L.SPOT))
            | (kind == float(L.DISTANT)))


def sample_li_lanes(scene, idx, p_ref: V3, u0, u1):
    """sample_li at a per-lane light index ``idx`` [N] -> (radiance V3,
    wi V3, pdf [N], p_light V3): every light's static sampler runs on all
    lanes (tensor code, no ray traced) and each lane keeps its own
    light's values."""
    out = None
    for j in range(light_count(scene)):
        s = sample_li_static(scene, j, p_ref, u0, u1)
        out = s if out is None else _select(idx == j, s, out)
    return out


def sample_le_lanes(scene, idx, u0x, u0y, u1x, u1y, time):
    """sample_le at a per-lane light index ``idx`` [N] -> (le V3, o V3,
    d V3, n_light V3, pdf_pos [N], pdf_dir [N]), each light's static
    sampler selected per lane."""
    out = None
    for j in range(light_count(scene)):
        s = sample_le_static(scene, j, u0x, u0y, u1x, u1y, time)
        out = s if out is None else _select(idx == j, s, out)
    return out


def le_area_lanes(scene, idx, n_l: V3, wo: V3) -> V3:
    """Emission toward ``wo`` of a surface with normal ``n_l`` on each
    lane's light ``idx`` [N]: its radiance where that light is an area
    light that emits on ``wo``'s side, else 0."""
    g = _rows_of(scene, idx)
    emits = (g[4] != 0.0) | (n_l.dot(wo) > 0)
    return V.where((g[3] == float(L.AREA)) & emits, V3(g[0], g[1], g[2]),
                   0.0)


def le_inf_lanes(scene, idx, wi: V3) -> V3:
    """The environment's radiance along ``wi`` on lanes whose light
    ``idx`` is the environment light, 0 on the others."""
    n = wi.x.shape[0]
    if scene.env is None:
        return V3.zeros((n,), wi.x.device)
    j = env_index(scene)
    return V.where(idx == j, le_inf(scene, j, wi), 0.0)


def pdf_li_lanes(scene, idx, wi: V3, hit_t, hit_cos):
    """Solid-angle pdf that each lane's light ``idx`` samples ``wi``:
    for an area light d^2 / (|cos| area) at the light-surface hit
    (``hit_t``, ``hit_cos`` = |cos|; 0 where |cos| <= 1e-9), for the
    environment its texel pdf, 0 for delta lights. The area is gathered
    per lane on the device: a tensor divided by a tensor, never a host
    scalar by a tensor (torch computes that as a reciprocal times it)."""
    g = _rows_of(scene, idx)
    d2 = hit_t * hit_t * wi.length_squared()
    pdf_a = d2 / (hit_cos * g[5].clamp_min(1e-20)).clamp_min(1e-20)
    pdf = torch.where((g[3] == float(L.AREA)) & (hit_cos > 1e-9), pdf_a,
                      0.0)
    if scene.env is not None:
        j = env_index(scene)
        pdf = torch.where(idx == j, pdf_li_env(scene, j, wi), pdf)
    return pdf


def area_light_radiance(scene, hit, wo: V3) -> V3:
    """Emitted radiance at hits on emissive triangles (zero elsewhere)."""
    n = hit.t.shape[0]
    dev = hit.t.device
    if scene.max_area_tris == 0 or scene.n_triangles == 0:
        return V3.zeros((n,), dev)
    ns = scene.n_spheres
    tri_idx = (hit.prim_id - ns).clamp(0, scene.n_triangles - 1).long()
    is_flat = (hit.prim_id >= ns) & (hit.prim_id < ns + scene.n_triangles)
    lid = torch.where(hit.valid & is_flat, scene.tri_light_id[tri_idx], -1)
    g = scene.light_rows[lid.clamp_min(0).long()].T   # [6, N]
    is_area = g[3] == float(L.AREA)
    emits = (g[4] != 0.0) | (hit.n.dot(wo) > 0)
    return V.where((lid >= 0) & is_area & emits, V3(g[0], g[1], g[2]), 0.0)


def light_rows(lights: L.Lights) -> np.ndarray:
    """[L, 6] host rows (radiance rgb, kind, two_sided, total_area) for
    the per-lane gathers."""
    n = L.num_lights(lights)
    return np.concatenate([
        lights.i.reshape(n, 3), lights.kind.astype(np.float32)[:, None],
        lights.two_sided.astype(np.float32)[:, None],
        lights.total_area.astype(np.float32)[:, None]], axis=1).reshape(
            max(n, 0), 6)
