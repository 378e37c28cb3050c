"""Planar path tracer: next-event estimation with MIS (port of
trace_tpu/wavefront/path.py).

Per bounce: closest hit, emission (and the environment on escaped rays)
on camera and specular vertices, one light picked uniformly per lane
with the light-sampling leg (one shadow-ray call whatever the number of
lights), plus the BSDF-sampling leg for lanes that picked an area or
environment light (one more closest-hit call), then a BSDF sample
continues the path, with Russian roulette after ``rr_depth`` bounces.
The uniforms derive from the lane keys exactly as in the JAX twin;
scenes with an environment light or several non-delta lights follow the
JAX package's packed li (integrators/common.py::estimate_direct), which
renders them there.

Dead lanes (finished paths, shading lanes whose shadow or MIS ray cannot
contribute) go to the sweep with t_max = -1, which skips them; their
results were masked out anyway, so the image does not change.
"""
from __future__ import annotations

import torch

from ..core import vec as V
from ..core.ray import SPAWN_EPS
from ..core.vec import V3
from ..sampler import uniform as U
from . import geom as G
from . import lights as WL
from . import materials as WM
from . import shade as S
from . import whitted as WW

F32 = torch.float32
INF = float("inf")


def supports(scene) -> None:
    """Raise for a scene the planar path tracer cannot render: what
    Whitted refuses (any light mix is taken)."""
    WW.supports(scene)


def to_y(c: V3):
    return 0.212671 * c.x + 0.715160 * c.y + 0.072169 * c.z


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = (nf * f_pdf) ** 2
    g = (ng * g_pdf) ** 2
    return torch.where(f + g > 0, f / (f + g), 0.0)


def _offset_origin(p: V3, d: V3, n_geom: V3) -> V3:
    o = p + d * SPAWN_EPS
    scale = 1e-4 * p.abs().max_component().clamp_min(1.0)
    side = torch.sign(n_geom.dot(d))
    return o + n_geom * (scale * side)


def estimate_direct(scene, hit: G.HitP, lobes: S.LobesP, idx, u_l0, u_l1,
                    u_s0, u_s1,
                    flags: int = S.BSDF_ALL & ~S.BSDF_SPECULAR) -> V3:
    """Direct light from each lane's light ``idx`` [N] (port of
    trace_tpu/integrators/common.py::estimate_direct): the light-sampling
    leg, one shadow-ray call for all lanes, weighted 1 for a delta light
    and by the power heuristic otherwise; and, in a scene with an area or
    environment light, the BSDF-sampling leg, one closest-hit call for
    the lanes whose light is not a delta light. Its ray counts where it
    hits a flat triangle of the lane's area light, or escapes on a lane
    whose light is the environment."""
    n = hit.t.shape[0]
    dev = hit.t.device

    radiance, wi, light_pdf, p_light = WL.sample_li_lanes(
        scene, idx, hit.p, u_l0, u_l1)
    f_val = S.f(lobes, hit.wo, wi, flags) * wi.dot(hit.ns).abs()
    scatter_pdf = S.compute_pdf(lobes, hit.wo, wi, flags)
    ok = ((light_pdf > 0) & ~radiance.is_black() & ~f_val.is_black()
          & hit.valid)
    vis = WW.unoccluded(scene, hit.p, p_light, hit.n, live=ok) & ok
    delta = WL.is_delta_lanes(scene, idx)
    w_l = torch.where(delta, 1.0,
                      power_heuristic(1.0, light_pdf, 1.0, scatter_pdf))
    ld = V.where(vis, f_val * radiance * (w_l / light_pdf.clamp_min(1e-20)),
                 0.0)
    if not (scene.max_area_tris > 0 or scene.env is not None):
        return ld

    # BSDF samples that escape see the sky; the area pdf would be
    # inf / inf on them, so an env lane reads the texel pdf only.
    bs = S.sample_f(lobes, hit.wo, u_s0, u_s1, flags)
    spec_sample = (bs.sampled_flags & S.BSDF_SPECULAR) != 0
    f_b = bs.f * bs.wi.dot(hit.ns).abs()
    go = hit.valid & ~delta & (bs.pdf > 0) & ~f_b.is_black()
    o = _offset_origin(hit.p, bs.wi, hit.n)
    hit2 = WW.closest_hit(scene, o, bs.wi,
                          torch.full((n,), INF, dtype=F32, device=dev),
                          hit.time, live=go)
    cos_l = hit2.n.dot(-bs.wi)
    li_pdf = WL.pdf_li_lanes(scene, idx, bs.wi, hit2.t, cos_l.abs())
    le = V3.zeros((n,), dev)
    counts = torch.zeros((n,), dtype=torch.bool, device=dev)
    if scene.max_area_tris > 0 and scene.n_triangles:
        # Only flat triangles are area lights: instanced prim ids start
        # after them and must not clip onto the last one's light.
        ns = scene.n_spheres
        tri_idx = (hit2.prim_id - ns).clamp(0, scene.n_triangles - 1).long()
        is_flat = (hit2.prim_id >= ns) & (hit2.prim_id < ns + scene.n_triangles)
        hits_light = hit2.valid & is_flat & (scene.tri_light_id[tri_idx] == idx)
        le = le + V.where(hits_light,
                          WL.le_area_lanes(scene, idx, hit2.n, -bs.wi), 0.0)
        counts = counts | hits_light
    if scene.env is not None:
        escaped = ~hit2.valid
        le_e = WL.le_inf_lanes(scene, idx, bs.wi)
        le = le + V.where(escaped, le_e, 0.0)
        counts = counts | (escaped & ~le_e.is_black())
    w_b = torch.where(spec_sample, 1.0,
                      power_heuristic(1.0, bs.pdf, 1.0, li_pdf))
    return ld + V.where(go & counts,
                        f_b * le * (w_b / bs.pdf.clamp_min(1e-20)), 0.0)


def uniform_sample_one_light(scene, hit: G.HitP, lobes: S.LobesP,
                             keys) -> V3:
    """One light per lane, picked uniformly (5-column uniform row: pick,
    light sample, BSDF sample), divided by its pick probability."""
    n = hit.t.shape[0]
    dev = hit.t.device
    n_lights = WL.light_count(scene)
    if n_lights == 0:
        return V3.zeros((n,), dev)
    row = U.uniform_lanes(keys, 5)
    u_pick, u_l0, u_l1, u_s0, u_s1 = row.T
    idx = (u_pick * n_lights).to(torch.int32).clamp_max(n_lights - 1)
    pmf = torch.full((n,), 1.0 / n_lights, dtype=F32, device=dev)
    ld = estimate_direct(scene, hit, lobes, idx, u_l0, u_l1, u_s0, u_s1)
    return ld / pmf.clamp_min(1e-12)


def li(scene, rd, key, max_depth: int = 5, rr_depth: int = 3,
       return_aux: bool = True):
    """Path-traced radiance [N, 3] for a batch of camera rays (``key``:
    per-lane keys [N, 2]), with ``return_aux`` (the port's default; the
    JAX package's is False) also {"queue_drops" (0), "useful_rays"}: per
    bounce one closest-hit ray per active path and two rays (NEE shadow,
    BSDF-MIS) per live hit."""
    keys = key
    n = rd.o.shape[0]
    dev = rd.o.device
    rp = G.RayP.of(rd)
    o, d, time = rp.o, rp.d, rp.time
    ones = torch.ones((n,), dtype=F32, device=dev)
    beta = V3(ones, ones, ones)
    l_out = V3.zeros((n,), dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    specular_bounce = torch.zeros((n,), dtype=torch.bool, device=dev)
    useful = torch.zeros((), dtype=torch.int64, device=dev)
    inf = torch.full((n,), INF, dtype=F32, device=dev)
    for bounce in range(max_depth):
        k = U.fold_lanes(keys, bounce)
        hit = WW.closest_hit(scene, o, d, inf, time, live=active)
        live = active & hit.valid
        useful = useful + active.sum() + 2 * live.sum()

        camera_or_specular = (bounce == 0) | specular_bounce
        le = WL.area_light_radiance(scene, hit, hit.wo)
        l_out = l_out + V.where(live & camera_or_specular, beta * le, 0.0)
        if scene.env is not None:
            # Other escapes are the BSDF-sampling leg's (NEE's MIS).
            esc = active & ~hit.valid & camera_or_specular
            l_out = l_out + V.where(esc, beta * WL.env_le(scene, d), 0.0)

        hit = hit._replace(valid=live)
        lobes = WM.compute_scattering(scene.materials, hit,
                                      allow_multiple_lobes=True,
                                      mode=S.RADIANCE)
        ld = uniform_sample_one_light(scene, hit, lobes, U.fold_lanes(k, 0))
        l_out = l_out + V.where(live, beta * ld, 0.0)

        u0, u1 = WW.uniform2(U.fold_lanes(k, 1))
        bs = S.sample_f(lobes, hit.wo, u0, u1, S.BSDF_ALL)
        ok = live & (bs.pdf > 0) & ~bs.f.is_black()
        specular_bounce = torch.where(
            ok, (bs.sampled_flags & S.BSDF_SPECULAR) != 0, specular_bounce)
        beta_next = V.where(
            ok, beta * bs.f * (bs.wi.dot(hit.ns).abs()
                               / bs.pdf.clamp_min(1e-20)), beta)

        if bounce >= rr_depth:
            q = (1.0 - to_y(beta_next)).clamp_min(0.05)
            u_rr = U.uniform_lanes(U.fold_lanes(k, 2), 1)[:, 0]
            killed = u_rr < q
            beta_next = V.where(~killed,
                                beta_next / (1.0 - q).clamp_min(1e-6),
                                beta_next)
        else:
            killed = torch.zeros_like(ok)
        beta = V.where(ok, beta_next, beta)

        active = ok & ~killed
        o = V.where(active, hit.p + bs.wi * SPAWN_EPS, o)
        d = V.where(active, bs.wi, d)
        time = torch.where(active, hit.time, time)
    l_arr = torch.stack([l_out.x, l_out.y, l_out.z], dim=1)
    if not return_aux:
        return l_arr
    return l_arr, {"queue_drops": torch.zeros_like(useful),
                   "useful_rays": useful}
