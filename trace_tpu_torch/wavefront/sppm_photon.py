"""SPPM photon pass: emission, walk and splat records on planar state
(port of trace_tpu/wavefront/sppm_photon.py).

Every sample dimension is a radical inverse of the photon's global
Halton index (dims 0-5 for the light pick, emission and time; three a
bounce), computed for the whole chunk at once. Each hit after the first
bounce records a splat: the photon's point, incoming direction, its
initial throughput (the reference never updates it along the path) and
the range of sorted grid entries of its cell. Russian roulette compares
the new throughput's luminance with the initial one's, as the reference
does.

Dead lanes go to the sweep with t_max = -1; the last depth samples no
continuation, and once no photon is active the remaining levels record
nothing (in the sync-free mode, core/sync.py, they run and record zeros,
the same records): neither changes a record.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import vec as V
from ..core.ray import SPAWN_EPS
from ..core.sync import sync_free
from ..sampler import halton as H
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


def photon_walk_body(integ, scene, halton_idx, lane_valid, light_cdf,
                     light_pmf, grid_lo, grid_res, grid_inv_extent,
                     sorted_cells, idx_max: int | None = None) -> dict:
    """Emit and walk a chunk of C photons (uint32 Halton indices in
    int64) -> splat records, dict of p, d, beta [(D-1) C, 3] and start,
    count [(D-1) C] int32, level by level. ``idx_max`` (optional) is a
    host bound on the indices (it only shortens the digit loops)."""
    from ..integrators.sppm import _hash_cells

    c = halton_idx.shape[0]
    dev = halton_idx.device
    depth_max = integ.max_depth
    n_dims = 6 + 3 * max(depth_max - 1, 0)
    ri = H.radical_inverses(range(n_dims), halton_idx, idx_max)

    n_lights = light_cdf.shape[0]
    light_num = (light_cdf[None, :] < ri[0][:, None]).to(torch.int32).sum(
        1).clamp_max(n_lights - 1)
    light_pdf = light_pmf[light_num.long()]
    time = (float(np.float32(integ.camera.shutter_open)) * (1.0 - ri[5])
            + float(np.float32(integ.camera.shutter_close)) * ri[5])
    le, o, d, n_l, pdf_pos, pdf_dir = WL.sample_le_lanes(
        scene, light_num, ri[1], ri[2], ri[3], ri[4], time)

    beta = le * (n_l.dot(d).abs()
                 / (light_pdf * pdf_pos * pdf_dir).clamp_min(1e-20))
    active = (lane_valid & (pdf_pos > 0) & (pdf_dir > 0) & (light_pdf > 0)
              & ~le.is_black() & ~beta.is_black())
    beta_y0 = WP.to_y(beta).clamp_min(1e-20)

    res_f = grid_res.to(F32)
    inf = torch.full((c,), float("inf"), dtype=F32, device=dev)
    zero3 = torch.zeros((c, 3), dtype=F32, device=dev)
    zero_i = torch.zeros((c,), dtype=torch.int32, device=dev)
    levels = []
    for depth in range(1, depth_max + 1):
        if depth > 1 and not sync_free() and not bool(active.any()):
            levels += [(zero3, zero3, zero3, zero_i, zero_i)] * (
                depth_max + 1 - depth)
            break
        hit = WW.closest_hit(scene, o, d, inf, time, live=active)
        live = active & hit.valid
        if depth > 1:
            g = []
            for ax, comp in enumerate((hit.p.x, hit.p.y, hit.p.z)):
                g.append(torch.floor(res_f[ax] * ((comp - grid_lo[ax])
                                                  * grid_inv_extent[ax])
                                     ).to(torch.int32))
            in_bounds = torch.ones_like(live)
            for ax in range(3):
                in_bounds = in_bounds & (g[ax] >= 0) & (g[ax] < grid_res[ax])
                g[ax] = torch.minimum(g[ax].clamp_min(0), grid_res[ax] - 1)
            cell = _hash_cells(g[0], g[1], g[2], integ.n_pixels)
            start = torch.searchsorted(sorted_cells, cell).to(torch.int32)
            end = torch.searchsorted(sorted_cells, cell, right=True).to(
                torch.int32)
            ok = live & in_bounds
            okc = ok[:, None]
            levels.append((
                torch.where(okc, hit.p.arr(), 0.0),
                torch.where(okc, d.arr(), 0.0),
                torch.where(okc, beta.arr(), 0.0),
                torch.where(ok, start, 0),
                torch.where(ok, end - start, 0)))
        if depth == depth_max:
            break

        hit = hit._replace(valid=live)
        lobes = WM.compute_scattering(scene.materials, hit,
                                      allow_multiple_lobes=True,
                                      mode=S.IMPORTANCE)
        dim = 6 + 3 * (depth - 1)
        bs = S.sample_f(lobes, -d, ri[dim], ri[dim + 1], S.BSDF_ALL,
                        mode=S.IMPORTANCE)
        ok2 = live & (bs.pdf > 0) & ~bs.f.is_black()
        beta_new = beta * bs.f * (bs.wi.dot(hit.ns).abs()
                                  / bs.pdf.clamp_min(1e-20))
        q = (1.0 - WP.to_y(beta_new) / beta_y0).clamp_min(0.0)
        active = ok2 & (ri[dim + 2] >= q)
        o = V.where(active, hit.p + bs.wi * SPAWN_EPS, o)
        d = V.where(active, bs.wi, d)
        time = torch.where(active, hit.time, time)

    names = ("p", "d", "beta", "start", "count")
    if not levels:   # max_depth 1: no splat level
        return {k: (zero3 if i < 3 else zero_i)[:0]
                for i, k in enumerate(names)}
    return {k: torch.cat([lv[i] for lv in levels])
            for i, k in enumerate(names)}
