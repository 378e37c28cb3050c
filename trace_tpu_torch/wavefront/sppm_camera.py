"""SPPM camera pass: visible points on planar state (port of
trace_tpu/wavefront/sppm_camera.py).

One bounce walk per pixel: closest hit, emission (and the environment
on escaped rays) on camera and specular vertices, direct light from one
uniformly picked light (not scaled by the path throughput, as in the
reference), a visible point at the first diffuse vertex (or a glossy one
at the last depth), else a BSDF sample with Russian roulette. The
randomness derives from the pixel-keyed lane keys exactly as in the JAX
twin; only the output is converted to the packed layout the grid and
pair phases read.

Dead lanes go to the sweep with t_max = -1 (``closest_hit(live=)``);
their results are masked out anyway. The walk stops once no lane is
active (in the sync-free mode, core/sync.py, it runs every depth: a
depth with no active lane changes no value), and the last depth samples
no continuation: neither changes a result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import vec as V
from ..core.ray import SPAWN_EPS, scale_differentials
from ..core.sync import sync_free
from ..core.vec import V3
from ..sampler import uniform as U
from . import geom as G
from . import lights as WL
from . import materials as WM
from . import path as WP
from . import shade as S
from . import whitted as WW

F32 = torch.float32


def supports(scene) -> None:
    """Raise for a scene the planar SPPM pass cannot render (the planar
    path tracer's rule, wavefront/path.py)."""
    WP.supports(scene)


def num_components_planar(lo: S.LobesP, flags: int) -> torch.Tensor:
    """Per lane, the number of slots whose lobe matches ``flags``."""
    out = None
    for s in lo.slots:
        ms = (S.matches_flags(s.kind, flags) & (s.kind != S.NONE)).to(
            torch.int32)
        out = ms if out is None else out + ms
    return out


def _slotp_field(slots, name: str, n: int) -> torch.Tensor:
    """One per-slot field in the packed [N, L(, 3)] layout, padded with
    empty-slot values up to ``n`` slots."""
    vals = [getattr(s, name) for s in slots]
    tmpl = vals[0]
    while len(vals) < n:
        if isinstance(tmpl, V3):
            vals.append(V3.zeros(tmpl.x.shape, tmpl.x.device))
        elif name in ("eta_a", "eta_b"):
            vals.append(torch.ones_like(tmpl))
        else:
            vals.append(torch.zeros_like(tmpl))
    if isinstance(tmpl, V3):
        return torch.stack([v.arr() for v in vals[:n]], 1)     # [N, L, 3]
    return torch.stack(vals[:n], 1)                             # [N, L]


def lobesp_to_packed(lo: S.LobesP, n_slots: int):
    """Planar slot table -> packed PackedLobes with ``n_slots`` slots."""
    from ..integrators.sppm import SLOT_FIELDS, PackedLobes

    f = {name: _slotp_field(list(lo.slots), name, n_slots)
         for name in SLOT_FIELDS}
    return PackedLobes(**f, ng=lo.ng.arr(), ns=lo.ns.arr(), ss=lo.ss.arr(),
                       ts=lo.ts.arr(), eta=lo.eta)


def _where_slot(mask, new: S.LobeSlotP, old: S.LobeSlotP) -> S.LobeSlotP:
    return S.LobeSlotP(*[V.where(mask, a, b) if isinstance(a, V3)
                         else torch.where(mask, a, b)
                         for a, b in zip(new, old)])


def camera_pass_body(integ, scene, pixels, lane_valid, key):
    """Visible points of a pixel chunk [C, 2] -> (ld_add [C, 3],
    VisiblePoints with VP_LOBES packed slots)."""
    from ..integrators.sppm import VP_LOBES, VisiblePoints, _compact_lobes

    c = pixels.shape[0]
    dev = pixels.device
    inv_sqrt_spp = float(np.float32(1.0 / np.sqrt(integ.n_iterations)))
    ks = U.lane_keys(key, U.pixel_ids(pixels))
    p_film, u_lens, u_time = U.get_camera_samples_lanes(
        U.fold_lanes(ks, 0), pixels)
    rd, beta_w = integ.camera.generate_ray_differentials(p_film, u_lens,
                                                         u_time)
    rd = scale_differentials(rd, inv_sqrt_spp)
    rp = G.RayP.of(rd)
    n_slots = max(WM.scene_slot_count(scene.materials), VP_LOBES)

    o, d, time = rp.o, rp.d, rp.time
    ones = torch.ones((c,), dtype=F32, device=dev)
    beta = V3(ones, ones, ones) * beta_w
    active = lane_valid & (beta_w > 0)
    specular_bounce = torch.zeros((c,), dtype=torch.bool, device=dev)
    z3 = V3.zeros((c,), dev)
    ld, vp_p, vp_wo, vp_beta = z3, z3, z3, z3
    vp_valid = torch.zeros((c,), dtype=torch.bool, device=dev)
    vp_slots = tuple(S.empty_slot(c, dev) for _ in range(n_slots))
    vp_frame = (z3, z3, z3, z3, torch.zeros((c,), dtype=F32, device=dev))
    inf = torch.full((c,), float("inf"), dtype=F32, device=dev)
    emissive = scene.max_area_tris > 0 and scene.n_triangles > 0

    for depth in range(1, integ.max_depth + 1):
        k_depth = U.fold_lanes(ks, depth)
        hit = WW.closest_hit(scene, o, d, inf, time, live=active)
        live = active & hit.valid
        hit = hit._replace(valid=live)
        lobes = WM.compute_scattering(scene.materials, hit,
                                      allow_multiple_lobes=True,
                                      mode=S.RADIANCE)
        if emissive:
            le = WL.area_light_radiance(scene, hit, hit.wo)
            emit = live if depth == 1 else live & specular_bounce
            ld = ld + V.where(emit, beta * le, 0.0)
        if scene.env is not None:
            esc = active & ~hit.valid
            if depth > 1:
                esc = esc & specular_bounce
            ld = ld + V.where(esc, beta * WL.env_le(scene, d), 0.0)
        direct = WP.uniform_sample_one_light(scene, hit, lobes,
                                             U.fold_lanes(k_depth, 0))
        ld = ld + V.where(live, direct, 0.0)

        rt = S.BSDF_REFLECTION | S.BSDF_TRANSMISSION
        is_diffuse = num_components_planar(lobes, S.BSDF_DIFFUSE | rt) > 0
        make_vp = live & is_diffuse
        if depth == integ.max_depth:
            make_vp = make_vp | (live & (num_components_planar(
                lobes, S.BSDF_GLOSSY | rt) > 0))
        vp_p = V.where(make_vp, hit.p, vp_p)
        vp_wo = V.where(make_vp, hit.wo, vp_wo)
        vp_beta = V.where(make_vp, beta, vp_beta)
        vp_valid = vp_valid | make_vp
        vp_slots = tuple(_where_slot(make_vp, a, b)
                         for a, b in zip(lobes.slots, vp_slots)) \
            + vp_slots[len(lobes.slots):]
        vp_frame = tuple(
            V.where(make_vp, a, b) for a, b in zip(
                (lobes.ng, lobes.ns, lobes.ss, lobes.ts), vp_frame[:4])
        ) + (torch.where(make_vp, lobes.eta, vp_frame[4]),)
        active = live & ~make_vp
        if depth == integ.max_depth or (
                not sync_free() and not bool(active.any())):
            break

        u0, u1 = WW.uniform2(U.fold_lanes(k_depth, 1))
        bs = S.sample_f(lobes, hit.wo, u0, u1, S.BSDF_ALL)
        ok = active & (bs.pdf > 0) & ~bs.f.is_black()
        specular_bounce = torch.where(
            ok, (bs.sampled_flags & S.BSDF_SPECULAR) != 0, specular_bounce)
        beta_new = beta * bs.f * (bs.wi.dot(hit.ns).abs()
                                  / bs.pdf.clamp_min(1e-20))
        by = WP.to_y(beta_new)
        rr = by < 0.25
        cp = by.clamp_max(1.0)
        u_rr = U.uniform_lanes(U.fold_lanes(k_depth, 2), 1)[:, 0]
        killed = rr & (u_rr > cp)
        beta_next = V.where(rr & ~killed, beta_new / cp.clamp_min(1e-20),
                            beta_new)
        beta = V.where(ok, beta_next, beta)
        active = ok & ~killed
        o = V.where(active, hit.p + bs.wi * SPAWN_EPS, o)
        d = V.where(active, bs.wi, d)
        time = torch.where(active, hit.time, time)

    vp_lo = S.LobesP(slots=vp_slots, ng=vp_frame[0], ns=vp_frame[1],
                     ss=vp_frame[2], ts=vp_frame[3], eta=vp_frame[4])
    vp = VisiblePoints(p=vp_p.arr(), wo=vp_wo.arr(), beta=vp_beta.arr(),
                       valid=vp_valid,
                       lobes=_compact_lobes(lobesp_to_packed(vp_lo, n_slots)))
    return ld.arr(), vp
