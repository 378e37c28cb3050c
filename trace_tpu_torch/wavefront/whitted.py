"""Planar Whitted wavefront (port of trace_tpu/wavefront/whitted.py).

Each depth level is one pass over a fixed-capacity queue of rays: closest
hit, direct light from every light, then the two specular children per
hit (reflection, transmission), compacted back into the queue by a
stable argsort on liveness. Overflowing children are dropped and counted
(``queue_drops``); ``useful_rays`` counts one closest-hit ray per live
lane and one shadow ray per light per shading lane. The queue holds
``max(queue_capacity, N)`` lanes (N by default; the lanes past N start
dead), or ``level_caps`` gives the queue after each level its own
capacity (a shrinking schedule): the image is energy-exact iff
``queue_drops`` is 0. ``sort_materials`` reorders each level's lanes by
material id (invalid lanes last, stable) before shading, as the JAX
package's packed path does; every lane keeps its pixel, so the image
changes only where drops do.

Intersection goes through the scene's accelerator (the sweep) where it
has one, else through the brute-force triangle grid (scenes of 1-64
triangles), then through each instanced geometry's walk
(accel/instances.py). Lanes that escape see the environment light, if
the scene has one. The JAX package renders environment-lit and instanced
scenes on its packed path only; the port's tests hold this path to that.

Randomness is identity-keyed as in the JAX twin: per lane, fold in the
branch path (heap numbering) and the depth.

Lanes that are dead (inactive queue entries, or shading lanes whose
light contribution is already zero) are handed to the sweep and to the
instance walks with t_max = -1, which skips them; their results were
masked out anyway, so the image is unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import vec as V
from ..core.ray import SPAWN_EPS
from ..core.vec import V3
from ..sampler import uniform as U
from . import geom as G
from . import lights as WL
from . import materials as WM
from . import shade as S

F32 = torch.float32
INF = float("inf")
SHADOW_T_MAX = float(np.float32(1.0 - 1e-4))


def uniform2(keys):
    u = U.uniform_lanes(keys, 2)
    return u[:, 0], u[:, 1]


def sanitize(v: V3) -> V3:
    f = lambda x: torch.where(torch.isfinite(x), x, 0.0).clamp_min(0.0)
    return V3(f(v.x), f(v.y), f(v.z))


def _zeros_hit(n, device):
    return (torch.zeros(n, dtype=torch.bool, device=device),
            torch.full((n,), INF, dtype=F32, device=device),
            torch.zeros(n, dtype=torch.int32, device=device))


def supports(scene) -> None:
    """Raise for a scene the planar path cannot render (the JAX twin
    falls back to its packed path there; the port has one path)."""
    WM.check_materials(scene.materials)


def _triangles(scene, o: V3, d: V3, t_max, live, any_hit: bool):
    """(hit, t, idx) over the scene's triangles: its accelerator, or the
    brute-force grid. Dead lanes (``live`` false) get t_max = -1."""
    tm = t_max if live is None else torch.where(live, t_max, -1.0)
    if scene.accel is not None:
        return scene.accel.intersect(o.arr(), d.arr(), tm, any_hit)
    if any_hit:
        h = G.triangles_anyhit(scene.triangle_cols, o, d, tm,
                               scene.exact_edges, scene.chunk_size)
        return h, None, None
    return G.triangles_closest(scene.triangle_cols, o, d, tm,
                               scene.exact_edges, scene.chunk_size)


def closest_hit(scene, o: V3, d: V3, t_max, time, live=None) -> G.HitP:
    """Closest hit over the scene's sources -- spheres, triangles, then
    each instanced geometry -> HitP; where sources tie, the earlier one
    wins. ``live`` marks the lanes whose result is used. An instance walk
    is given the best t of the sources before it as its limit (it can only
    win below it)."""
    n = o.x.shape[0]
    dev = o.x.device
    if scene.n_spheres:
        h_s, t_s, i_s = G.spheres_closest(scene.sphere_cols, o, d, t_max)
    else:
        h_s, t_s, i_s = _zeros_hit(n, dev)
    if scene.n_triangles:
        h_t, t_t, i_t = _triangles(scene, o, d, t_max, live, False)
    else:
        h_t, t_t, i_t = _zeros_hit(n, dev)

    ts = torch.where(h_s, t_s, INF)
    tt = torch.where(h_t, t_t, INF)
    tri_wins = h_t & (tt < ts)
    rec = None
    if scene.n_spheres:
        rec = G.make_hit_spheres(scene.sphere_rows, o, d, time, t_s, i_s,
                                 h_s & ~tri_wins)
    if scene.n_triangles:
        # With exact shared edges the accelerator's (certified) mask is
        # kept: the recompute must not drop a winner exactly on an edge.
        # The brute-force grid ran the same exact test as the recompute.
        rec_t = G.make_hit_triangles(
            scene.triangle_rows, o, d, time, i_t, tri_wins,
            prim_offset=scene.n_spheres, exact_edges=scene.exact_edges,
            trust_valid=scene.exact_edges and scene.accel is not None)
        rec = rec_t if rec is None else G.where_hit(tri_wins, rec_t, rec)
    if scene.instanced:
        rec = _instanced_closest(scene, o, d, t_max, time, live,
                                 torch.minimum(ts, tt), rec)
    if rec is None:
        raise ValueError("scene has no geometry")
    return rec


def _instanced_closest(scene, o: V3, d: V3, t_max, time, live, best,
                       rec):
    """Fold each instanced geometry's walk into ``rec``, the record of the
    sources before it whose least t is ``best``."""
    win = torch.full(best.shape, -1, dtype=torch.int32, device=best.device)
    walks = []
    for k, geom in enumerate(scene.instanced):
        lim = torch.minimum(best, t_max)
        if live is not None:
            lim = torch.where(live, lim, -1.0)
        h_g, t_g, e_g, i_g = geom.traverse(o, d, lim)
        wins = h_g & (t_g < best)
        best = torch.where(wins, t_g, best)
        win = torch.where(wins, k, win)
        walks.append((e_g, i_g))
    for k, (geom, off, (e_g, i_g)) in enumerate(zip(
            scene.instanced, scene.instanced_offsets, walks)):
        sel = win == k
        rec_g = geom.make_hit_record(o, d, time, e_g, i_g, sel,
                                     prim_offset=off)
        rec = rec_g if rec is None else G.where_hit(sel, rec_g, rec)
    return rec


def any_hit(scene, o: V3, d: V3, t_max, live=None):
    """Occlusion predicate (shadow rays): any source's hit within t_max."""
    n = o.x.shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=o.x.device)
    if scene.n_spheres:
        occ = occ | G.spheres_anyhit(scene.sphere_cols, o, d, t_max)
    if scene.n_triangles:
        h, t, _ = _triangles(scene, o, d, t_max, live, True)
        occ = occ | (h if t is None else h & (t <= t_max))
    for geom in scene.instanced:
        # Lanes already occluded, or dead, walk nothing.
        go = ~occ if live is None else live & ~occ
        h, t, _, _ = geom.traverse(o, d, torch.where(go, t_max, -1.0),
                                   any_hit=True)
        occ = occ | (h & (t <= t_max))
    return occ


def unoccluded(scene, p0: V3, p1: V3, n_geom: V3, live=None):
    """Shadow ray p0 -> p1 (t_max 1 - 1e-4), origin nudged along the
    geometric normal by a scale-aware epsilon."""
    d = p1 - p0
    o = p0 + d * SPAWN_EPS
    scale = 1e-4 * p0.abs().max_component().clamp_min(1.0)
    side = torch.sign(n_geom.dot(d))
    o = o + n_geom * (scale * side)
    t_max = torch.full(p0.x.shape, SHADOW_T_MAX, dtype=F32,
                       device=p0.x.device)
    return ~any_hit(scene, o, d, t_max, live)


def sum_over_lights(scene, hit: G.HitP, lobes: S.LobesP, keys,
                    flags: int = S.BSDF_ALL & ~S.BSDF_SPECULAR) -> V3:
    """Direct light from every light through the lobes that ``flags``
    selects (every lobe but the specular ones by default)."""
    total = V3.zeros(hit.t.shape, hit.t.device)
    for j in range(WL.light_count(scene)):
        u0, u1 = uniform2(U.fold_lanes(keys, j))
        radiance, wi, pdf, p_light = WL.sample_li_static(scene, j, hit.p,
                                                         u0, u1)
        f_val = S.f(lobes, hit.wo, wi, flags)
        possible = (~radiance.is_black() & (pdf > 0) & ~f_val.is_black()
                    & hit.valid)
        vis = unoccluded(scene, hit.p, p_light, hit.n, live=possible)
        vis = vis & possible
        contrib = f_val * radiance * (
            wi.dot(hit.ns).abs() / pdf.clamp_min(1e-20))
        total = total + V.where(vis, contrib, 0.0)
    return total


def _dndxy(hit: G.HitP):
    dndx = hit.s_dndu * hit.dudx + hit.s_dndv * hit.dvdx
    dndy = hit.s_dndu * hit.dudy + hit.s_dndv * hit.dvdy
    return dndx, dndy


def reflect_differentials(rd: G.RayP, hit: G.HitP, wi: V3):
    ns, wo = hit.ns, hit.wo
    dndx, dndy = _dndxy(hit)
    dwodx = -rd.rx_direction - wo
    dwody = -rd.ry_direction - wo
    ddndx = dwodx.dot(ns) + wo.dot(dndx)
    ddndy = dwody.dot(ns) + wo.dot(dndy)
    won = wo.dot(ns)
    rx_d = wi - dwodx + (dndx * won + ns * ddndx) * 2.0
    ry_d = wi - dwody + (dndy * won + ns * ddndy) * 2.0
    return hit.p + hit.dpdx, hit.p + hit.dpdy, rx_d, ry_d


def transmit_differentials(rd: G.RayP, hit: G.HitP, lobes: S.LobesP,
                           wi: V3):
    wo = hit.wo
    ns = hit.ns
    dndx, dndy = _dndxy(hit)
    exiting = wo.dot(ns) < 0
    ns = V.where(exiting, -ns, ns)
    dndx = V.where(exiting, -dndx, dndx)
    dndy = V.where(exiting, -dndy, dndy)
    eta_int = lobes.eta.clamp_min(1e-6)
    eta = torch.where(exiting, eta_int, 1.0 / eta_int)
    dwodx = -rd.rx_direction - wo
    dwody = -rd.ry_direction - wo
    ddndx = dwodx.dot(ns) + wo.dot(dndx)
    ddndy = dwody.dot(ns) + wo.dot(dndy)
    won = wo.dot(ns)
    win = wi.dot(ns).abs().clamp_min(1e-9)
    mu = eta * won - win
    nu = eta - eta * eta * won / win
    rx_d = wi - dwodx * eta + (dndx * mu + ns * (nu * ddndx))
    ry_d = wi - dwody * eta + (dndy * mu + ns * (nu * ddndy))
    return hit.p + hit.dpdx, hit.p + hit.dpdy, rx_d, ry_d


def _sample_specular(hit: G.HitP, lobes: S.LobesP, rd: G.RayP, valid, keys,
                     flags: int):
    u0, u1 = uniform2(keys)
    bs = S.sample_f(lobes, hit.wo, u0, u1, flags)
    cos_i = bs.wi.dot(hit.ns)
    ok = valid & (bs.pdf > 0) & ~bs.f.is_black() & (cos_i.abs() > 1e-9)
    factor = bs.f * (cos_i.abs() / bs.pdf.clamp_min(1e-20))
    if flags & S.BSDF_REFLECTION:
        rx_o, ry_o, rx_d, ry_d = reflect_differentials(rd, hit, bs.wi)
    else:
        rx_o, ry_o, rx_d, ry_d = transmit_differentials(rd, hit, lobes, bs.wi)
    child = G.RayP(
        o=hit.p + bs.wi * SPAWN_EPS, d=bs.wi,
        t_max=torch.full_like(hit.time, INF), time=hit.time,
        has_differentials=rd.has_differentials & ok,
        rx_origin=rx_o, ry_origin=ry_o, rx_direction=rx_d, ry_direction=ry_d)
    return child, factor, ok


_RAY_KEYS = ("o", "d", "rx_origin", "ry_origin", "rx_direction",
             "ry_direction")


def _queue_of(rp: G.RayP, beta: V3, slot, path, active) -> dict:
    q = {}
    for k in _RAY_KEYS:
        v = getattr(rp, k)
        q[k + "x"], q[k + "y"], q[k + "z"] = v.x, v.y, v.z
    q.update(t_max=rp.t_max, time=rp.time, has_diff=rp.has_differentials,
             br=beta.x, bg=beta.y, bb=beta.z, slot=slot, path=path,
             active=active)
    return q


def _ray_of(q: dict) -> G.RayP:
    v = {k: V3(q[k + "x"], q[k + "y"], q[k + "z"]) for k in _RAY_KEYS}
    return G.RayP(o=v["o"], d=v["d"], t_max=q["t_max"], time=q["time"],
                  has_differentials=q["has_diff"], rx_origin=v["rx_origin"],
                  ry_origin=v["ry_origin"], rx_direction=v["rx_direction"],
                  ry_direction=v["ry_direction"])


def _compact(queue: dict, capacity: int) -> dict:
    """Keep the ``capacity`` most-alive entries, stably."""
    dead = (~queue["active"]).to(torch.uint8)
    order = torch.argsort(dead, stable=True)[:capacity]
    return V.tree_gather(queue, order)


def li(scene, rd, key, max_depth: int = 5, level_caps=None,
       queue_capacity: int | None = None, sort_materials: bool = False,
       return_aux: bool = True):
    """Radiance [N, 3] for a batch of camera rays, plus the device
    counters {"queue_drops", "useful_rays"} (int64 scalars). The queue
    holds ``max(queue_capacity, N)`` lanes (N by default), or
    ``level_caps[d - 1]`` after level d (ints, at least max_depth - 1 of
    them); children beyond that are dropped and counted.
    ``sort_materials``: each level's lanes in material order before
    shading (module docstring).

    ``return_aux`` false gives the radiance alone (the JAX package's
    default; the port's integrators read the counters).

    ``key``: per-lane keys [N, 2]. The l buffer is accumulated per
    level in rounds of the branch rank, so no two adds of one round hit
    the same pixel and the sum order is fixed (the queue order of the JAX
    twin at depth <= 2)."""
    keys = key
    n = rd.o.shape[0]
    dev = rd.o.device
    ones = torch.ones((n,), dtype=F32, device=dev)
    queue = _queue_of(G.RayP.of(rd), V3(ones, ones, ones),
                      torch.arange(n, device=dev),
                      torch.zeros((n,), dtype=torch.int64, device=dev),
                      torch.ones((n,), dtype=torch.bool, device=dev))
    cap = n if queue_capacity is None else max(int(queue_capacity), n)
    if cap > n:   # dead lanes, copies of lane 0, up to the capacity
        pad = torch.cat([torch.arange(n, device=dev),
                         torch.zeros(cap - n, dtype=torch.int64, device=dev)])
        queue = V.tree_gather(queue, pad)
        queue["active"] = queue["active"] & (torch.arange(cap, device=dev)
                                             < n)

    n_lights = WL.light_count(scene)
    l_buf = torch.zeros((n, 3), dtype=F32, device=dev)
    drops = torch.zeros((), dtype=torch.int64, device=dev)
    useful = torch.zeros((), dtype=torch.int64, device=dev)
    for depth in range(1, max_depth + 1):
        k_depth = U.fold_lanes(U.fold_lanes(keys[queue["slot"]],
                                            queue["path"]), depth)
        q_rd = _ray_of(queue)
        beta = V3(queue["br"], queue["bg"], queue["bb"])
        active = queue["active"]
        hit = closest_hit(scene, q_rd.o, q_rd.d, q_rd.t_max, q_rd.time,
                          live=active)
        valid = active & hit.valid
        useful = useful + active.sum() + n_lights * valid.sum()
        hit = hit._replace(valid=valid)
        if sort_materials:
            order = torch.argsort(torch.where(valid, hit.material_id,
                                              1 << 30), stable=True)
            hit = G.HitP(*[V3(x.x[order], x.y[order], x.z[order])
                           if isinstance(x, V3) else x[order] for x in hit])
            queue = V.tree_gather(queue, order)
            k_depth = k_depth[order]
            q_rd = _ray_of(queue)
            beta = V3(queue["br"], queue["bg"], queue["bb"])
            active, valid = queue["active"], hit.valid
        hit = G.compute_differentials(hit, q_rd)
        lobes = WM.compute_scattering(scene.materials, hit)

        contrib = WL.area_light_radiance(scene, hit, hit.wo)
        contrib = contrib + sum_over_lights(scene, hit, lobes,
                                            U.fold_lanes(k_depth, 0))
        contrib = V.where(valid, sanitize(beta * contrib), 0.0)
        if scene.env is not None:
            # A lane either shades or escapes, so one add holds both.
            bg = sanitize(beta * WL.env_le(scene, q_rd.d))
            contrib = V.where(active & ~valid, bg, contrib)
        c_pack = torch.stack([contrib.x, contrib.y, contrib.z], dim=1)
        rank = queue["path"] - ((1 << (depth - 1)) - 1)
        for r in range(1 << (depth - 1)):
            l_buf.index_add_(0, queue["slot"],
                             torch.where((rank == r)[:, None], c_pack, 0.0))

        if depth == max_depth:
            break  # children of the last level are never traced
        children = []
        for branch, flags in enumerate(
                (S.BSDF_SPECULAR | S.BSDF_REFLECTION,
                 S.BSDF_SPECULAR | S.BSDF_TRANSMISSION)):
            child, factor, ok = _sample_specular(
                hit, lobes, q_rd, valid, U.fold_lanes(k_depth, branch + 1),
                flags)
            children.append(_queue_of(
                child, V.where(ok, beta * factor, 0.0), queue["slot"],
                queue["path"] * 2 + (branch + 1), ok))
        allc = {k: torch.cat([c[k] for c in children]) for k in children[0]}
        nxt = cap if level_caps is None else int(level_caps[depth - 1])
        live = allc["active"].sum()
        drops = drops + (live - nxt).clamp_min(0)
        queue = _compact(allc, nxt)
    if not return_aux:
        return l_buf
    return l_buf, {"queue_drops": drops, "useful_rays": useful}
