"""Planar geometry: rays, hit records, intersectors (port of
trace_tpu/wavefront/geom.py).

Every 3-vector is a V3 of flat [N] tensors. Winner details are built from
one row gather per primitive kind (``sphere_rows``/``triangle_rows``,
device tensors built once per scene, and once per frame of animated
geometry).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vec as V
from ..core.vec import V3

F32 = torch.float32
INF = float("inf")


class RayP(NamedTuple):
    o: V3
    d: V3
    t_max: torch.Tensor
    time: torch.Tensor
    has_differentials: torch.Tensor
    rx_origin: V3
    ry_origin: V3
    rx_direction: V3
    ry_direction: V3

    @staticmethod
    def of(rd) -> "RayP":
        return RayP(V3.of(rd.o), V3.of(rd.d), rd.t_max, rd.time,
                    rd.has_differentials, V3.of(rd.rx_origin),
                    V3.of(rd.ry_origin), V3.of(rd.rx_direction),
                    V3.of(rd.ry_direction))


class HitP(NamedTuple):
    valid: torch.Tensor
    t: torch.Tensor
    p: V3
    time: torch.Tensor
    wo: V3
    n: V3
    u: torch.Tensor
    v: torch.Tensor
    dpdu: V3
    dpdv: V3
    ns: V3
    s_dpdu: V3
    s_dpdv: V3
    s_dndu: V3
    s_dndv: V3
    prim_id: torch.Tensor
    material_id: torch.Tensor
    dudx: torch.Tensor
    dudy: torch.Tensor
    dvdx: torch.Tensor
    dvdy: torch.Tensor
    dpdx: V3
    dpdy: V3


def empty_hitp(n, device="cuda") -> HitP:
    """A record of ``n`` lanes that hit nothing: t +inf, ids -1, every
    other field 0."""
    z = torch.zeros((n,), dtype=F32, device=device)
    zi = torch.zeros((n,), dtype=torch.int32, device=device)
    z3 = V3(z, z, z)
    return HitP(valid=torch.zeros((n,), dtype=torch.bool, device=device),
                t=torch.full((n,), INF, dtype=F32, device=device), p=z3,
                time=z, wo=z3, n=z3, u=z, v=z, dpdu=z3, dpdv=z3, ns=z3,
                s_dpdu=z3, s_dpdv=z3, s_dndu=z3, s_dndv=z3, prim_id=zi - 1,
                material_id=zi - 1, dudx=z, dudy=z, dvdx=z, dvdy=z,
                dpdx=z3, dpdy=z3)


def where_hit(c: torch.Tensor, a: HitP, b: HitP) -> HitP:
    """Lane select between two hit records."""
    out = []
    for x, y in zip(a, b):
        out.append(V.where(c, x, y) if isinstance(x, V3)
                   else torch.where(c, x, y))
    return HitP(*out)


# ---------------------------------------------------------------------------
# Spheres: [N, S] pair grids
# ---------------------------------------------------------------------------


def sphere_cols(sph, device) -> dict:
    """Sphere table as [1, S] component columns on ``device``."""
    t = lambda a: torch.from_numpy(
        np.ascontiguousarray(a, np.float32))[None, :].to(device)
    w2o = sph.w2o
    return {
        "R": [[t(w2o[:, i, j]) for j in range(3)] for i in range(3)],
        "tr": [t(w2o[:, i, 3]) for i in range(3)],
        "radius": t(sph.radius), "z_min": t(sph.z_min),
        "z_max": t(sph.z_max), "phi_max": t(sph.phi_max),
    }


def _refine_p(p: V3, radius) -> V3:
    s = radius / p.length().clamp_min(1e-20)
    p = p * s
    tiny = (p.x.abs() < 1e-10) & (p.y.abs() < 1e-10)
    return V3(torch.where(tiny, 1e-6 * radius, p.x), p.y, p.z)


def _phi_of(p: V3):
    phi = torch.atan2(p.y, p.x)
    return torch.where(phi < 0.0, phi + 2.0 * V.PI, phi)


def _clip_violated(cols, p: V3, phi):
    r, zmin, zmax = cols["radius"], cols["z_min"], cols["z_max"]
    return (((zmin > -r) & (p.z < zmin)) | ((zmax < r) & (p.z > zmax))
            | (phi > cols["phi_max"]))


def _sphere_candidate(cols, o_obj: V3, d_obj: V3, t_max):
    radius = cols["radius"]
    a = d_obj.length_squared()
    b = 2.0 * o_obj.dot(d_obj)
    c = o_obj.length_squared() - radius * radius
    disc = b * b - 4.0 * a * c
    exists = disc >= 0.0
    sq = torch.sqrt(disc.clamp_min(0.0))
    q = -0.5 * (b + torch.where(b < 0.0, -sq, sq))
    r0 = q / a
    r1 = c / torch.where(q == 0.0, 1.0, q)
    r1 = torch.where(q == 0.0, INF, r1)
    t0 = torch.minimum(r0, r1)
    t1 = torch.maximum(r0, r1)
    in_range = exists & (t0 <= t_max) & (t1 >= 0.0)
    t0 = torch.where(t0 < 0.0, t1, t0)

    def clipped(t):
        pr = _refine_p(o_obj + d_obj * t, radius)
        return _clip_violated(cols, pr, _phi_of(pr))

    clip0 = clipped(t0)
    clip1 = clipped(t1)
    t_hit = torch.where(clip0, t1, t0)
    hit = (in_range & ~(clip0 & clip1) & (t_hit <= t_max)
           & torch.isfinite(t_hit))
    return hit, t_hit


def _to_object_grid(cols, o: V3, d: V3):
    R, tr = cols["R"], cols["tr"]
    ox, oy, oz = o.x[:, None], o.y[:, None], o.z[:, None]
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    ob = V3(R[0][0] * ox + R[0][1] * oy + R[0][2] * oz + tr[0],
            R[1][0] * ox + R[1][1] * oy + R[1][2] * oz + tr[1],
            R[2][0] * ox + R[2][1] * oy + R[2][2] * oz + tr[2])
    db = V3(R[0][0] * dx + R[0][1] * dy + R[0][2] * dz,
            R[1][0] * dx + R[1][1] * dy + R[1][2] * dz,
            R[2][0] * dx + R[2][1] * dy + R[2][2] * dz)
    return ob, db


def spheres_closest(sph, o: V3, d: V3, t_max):
    """Closest sphere hit over ``sph``, the spheres' columns
    (sphere_cols): (hit [N], t [N], idx [N] i32)."""
    ob, db = _to_object_grid(sph, o, d)
    hit, t = _sphere_candidate(sph, ob, db, t_max[:, None])
    tm = torch.where(hit, t, INF)
    best, idx = tm.min(dim=-1)
    return torch.isfinite(best), best, idx.to(torch.int32)


def spheres_anyhit(sph, o: V3, d: V3, t_max):
    ob, db = _to_object_grid(sph, o, d)
    hit, _ = _sphere_candidate(sph, ob, db, t_max[:, None])
    return hit.any(dim=-1)


# ---------------------------------------------------------------------------
# Triangles: the watertight test of the winner-detail recompute
# ---------------------------------------------------------------------------


_SPLIT = 4097.0  # 2^12 + 1, the Veltkamp split constant for f32


def _two_prod(a, b):
    """Error-free product: (fl(a*b), err) with a*b == fl + err exactly.
    Dekker/Veltkamp split; each step is its own eager op, so nothing is
    contracted into an FMA."""
    p = a * b
    ah = a * _SPLIT
    ah = ah - (ah - a)
    al = a - ah
    bh = b * _SPLIT
    bh = bh - (bh - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _edge_ds(a, b, c, d_):
    """Sign-exact a*b - c*d in double-single arithmetic. Consumed only
    where fl(fl(ab) - fl(cd)) == 0, i.e. fl(ab) == fl(cd): their
    difference is then exact (Sterbenz) and the result is the error
    terms' difference -- the value the reference's f64 recompute gives."""
    p1, s1 = _two_prod(a, b)
    p2, s2 = _two_prod(c, d_)
    return (p1 - p2) + (s1 - s2)


def _watertight(v0: V3, v1: V3, v2: V3, o: V3, d: V3, t_max,
                exact_edges: bool = False):
    """Permute-shear watertight test; operands broadcast together.
    Returns (hit, t, b0, b1, b2). ``exact_edges``: where an edge function
    is exactly 0 at f32, all three are recomputed in double-single (the
    reference's f64 fallback, triangle_mesh.jl:194-197)."""
    e01, e02 = v2 - v0, v1 - v0
    degenerate = e01.cross(e02).length_squared() == 0.0
    ad_x, ad_y, ad_z = d.x.abs(), d.y.abs(), d.z.abs()
    m0 = (ad_x >= ad_y) & (ad_x >= ad_z)
    m1 = ~m0 & (ad_y >= ad_z)

    def perm3(w: V3):
        vx = torch.where(m0, w.y, torch.where(m1, w.z, w.x))
        vy = torch.where(m0, w.z, torch.where(m1, w.x, w.y))
        vz = torch.where(m0, w.x, torch.where(m1, w.y, w.z))
        return vx, vy, vz

    dx, dy, dz = perm3(d)
    inv_dz = 1.0 / dz
    sx = -dx * inv_dz
    sy = -dy * inv_dz
    sz = inv_dz

    def shear(vv: V3):
        tx, ty, tz = perm3(vv - o)
        return tx + sx * tz, ty + sy * tz, tz

    x0, y0, z0 = shear(v0)
    x1, y1, z1 = shear(v1)
    x2, y2, z2 = shear(v2)
    e0 = x1 * y2 - y1 * x2
    e1 = x2 * y0 - y2 * x0
    e2 = x0 * y1 - y0 * x1
    if exact_edges:
        need = (e0 == 0.0) | (e1 == 0.0) | (e2 == 0.0)
        e0 = torch.where(need, _edge_ds(x1, y2, y1, x2), e0)
        e1 = torch.where(need, _edge_ds(x2, y0, y2, x0), e1)
        e2 = torch.where(need, _edge_ds(x0, y1, y0, x1), e2)
    mixed = (((e0 < 0) | (e1 < 0) | (e2 < 0))
             & ((e0 > 0) | (e1 > 0) | (e2 > 0)))
    det = e0 + e1 + e2
    near_zero_det = det == 0.0
    t_scaled = e0 * (z0 * sz) + e1 * (z1 * sz) + e2 * (z2 * sz)
    bad_neg = (det < 0) & ((t_scaled >= 0) | (t_scaled < t_max * det))
    bad_pos = (det > 0) & ((t_scaled <= 0) | (t_scaled > t_max * det))
    inv_det = 1.0 / torch.where(near_zero_det, 1.0, det)
    t = t_scaled * inv_det
    hit = ~degenerate & ~mixed & ~near_zero_det & ~bad_neg & ~bad_pos
    return hit, t, e0 * inv_det, e1 * inv_det, e2 * inv_det


# ---------------------------------------------------------------------------
# Triangles: brute-force [N, T] pair grids (scenes of 1-64 triangles)
# ---------------------------------------------------------------------------


def triangle_cols(tris, device) -> tuple:
    """Vertices as (v0, v1, v2) V3s of [1, T] columns on ``device``, from
    a host or a device table."""
    def col(a):
        a = torch.as_tensor(a, dtype=F32).to(device)
        return V3(a[None, :, 0], a[None, :, 1], a[None, :, 2])
    return col(tris.v0), col(tris.v1), col(tris.v2)


def _tri_grid(cols, o: V3, d: V3, t_max, exact_edges: bool):
    ob = V3(o.x[:, None], o.y[:, None], o.z[:, None])
    db = V3(d.x[:, None], d.y[:, None], d.z[:, None])
    return _watertight(*cols, ob, db, t_max[:, None], exact_edges)


def _chunks(cols, chunk):
    """(start, cols) over [start, start + chunk) column slices; one slice
    of everything without ``chunk``."""
    t = cols[0].x.shape[1]
    step = chunk or max(t, 1)
    for s in range(0, t, step):
        yield s, tuple(V3(v.x[:, s:s + step], v.y[:, s:s + step],
                          v.z[:, s:s + step]) for v in cols)


def triangles_closest(tris, o: V3, d: V3, t_max, exact_edges: bool = False,
                      chunk: int | None = None):
    """Closest triangle hit over ``tris``, the triangles' columns
    (triangle_cols): (hit [N], t [N], idx [N] i32); among equal t the
    lowest index wins. ``exact_edges``: the double-single edge
    fallback, as the JAX package's packed intersect_all. ``chunk``: at
    most this many triangles a pass (a running min, as the JAX twin's
    chunked reduction; the same result)."""
    best = idx = None
    for s, part in _chunks(tris, chunk):
        hit, t, _, _, _ = _tri_grid(part, o, d, t_max, exact_edges)
        b, i = torch.where(hit, t, INF).min(dim=-1)
        if best is None:
            best, idx = b, i
        else:
            better = b < best
            best = torch.where(better, b, best)
            idx = torch.where(better, i + s, idx)
    return torch.isfinite(best), best, idx.to(torch.int32)


def triangles_anyhit(tris, o: V3, d: V3, t_max, exact_edges: bool = False,
                     chunk: int | None = None):
    occ = None
    for _, part in _chunks(tris, chunk):
        h = _tri_grid(part, o, d, t_max, exact_edges)[0].any(dim=-1)
        occ = h if occ is None else occ | h
    return occ


# ---------------------------------------------------------------------------
# Detail phase: winner row gather + planar frame build
# ---------------------------------------------------------------------------

TRI_FIELDS = 27  # 9 verts + 9 normals + 6 uv + has_n + mat_id + flip
SPH_FIELDS = 32  # w2o 3x4, o2w 3x4, radius, th_min, th_max, phi_max,
#                  mat_id, flip, 2 pad


def triangle_rows(tris, device) -> torch.Tensor:
    """[T, 27] detail rows on ``device``; material ids ride bitcast to
    f32. A device table (animated geometry) is packed where it lies."""
    n = tris.v0.shape[0]
    if n == 0:
        return torch.zeros((1, TRI_FIELDS), dtype=F32, device=device)
    t = [torch.as_tensor(c).to(device) for c in tris]
    cols = [c.to(F32) for c in t[:9]] + [t[9].to(F32)[:, None],
                    t[10].to(torch.int32).contiguous().view(F32)[:, None],
                    t[11].to(F32)[:, None]]
    return torch.cat(cols, 1)


def sphere_rows(sph) -> np.ndarray:
    n = sph.w2o.shape[0]
    out = np.zeros((max(n, 1), SPH_FIELDS), np.float32)
    if n == 0:
        return out
    out[:, 0:12] = sph.w2o[:, :3, :].reshape(n, 12)
    out[:, 12:24] = sph.o2w[:, :3, :].reshape(n, 12)
    out[:, 24] = sph.radius
    out[:, 25] = sph.theta_min
    out[:, 26] = sph.theta_max
    out[:, 27] = sph.phi_max
    out[:, 28] = np.asarray(sph.material_id, np.int32).view(np.float32)
    out[:, 29] = sph.flip_normal.astype(np.float32)
    return out


def _bits_to_int(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def make_hit_triangles(rows: torch.Tensor, o: V3, d: V3, time, idx, valid,
                       prim_offset: int = 0, exact_edges: bool = False,
                       trust_valid: bool = False) -> HitP:
    """Detail phase for each lane's winning triangle: the watertight
    recompute gives t and the barycentrics, from which p, uv, the frames
    and the shading normal follow. ``exact_edges``: the recompute uses the
    double-single edge fallback. ``trust_valid``: keep the caller's valid
    mask instead of AND-ing the recompute's acceptance back in -- for a
    certified accelerator, whose winner may lie exactly on a shared edge
    that the recompute's strict edge signs would reject."""
    mt = rows[idx.long()].T                       # [27, N]
    v0, v1, v2 = (V3(mt[j], mt[j + 1], mt[j + 2]) for j in (0, 3, 6))
    n0, n1, n2 = (V3(mt[j], mt[j + 1], mt[j + 2]) for j in (9, 12, 15))
    uv0u, uv0v, uv1u, uv1v, uv2u, uv2v = (mt[j] for j in range(18, 24))
    has_n = mt[24] != 0.0
    material_id = _bits_to_int(mt[25])
    flip = mt[26] != 0.0

    n = o.x.shape[0]
    dev = o.x.device
    inf = torch.full((n,), INF, dtype=F32, device=dev)
    hit, t, b0, b1, b2 = _watertight(v0, v1, v2, o, d, inf, exact_edges)
    if not trust_valid:
        valid = valid & hit

    duv13u, duv13v = uv0u - uv2u, uv0v - uv2v
    duv23u, duv23v = uv1u - uv2u, uv1v - uv2v
    dp13 = v0 - v2
    dp23 = v1 - v2
    uv_det = duv13u * duv23v - duv13v * duv23u
    uv_degen = uv_det.abs() < 1e-12
    inv_uv_det = 1.0 / torch.where(uv_degen, 1.0, uv_det)
    dpdu = (dp13 * duv23v - dp23 * duv13v) * inv_uv_det
    dpdv = (dp13 * (-duv23u) + dp23 * duv13u) * inv_uv_det
    ng0 = (v2 - v0).cross(v1 - v0).normalize()
    _, fb_u, fb_v = V.coordinate_system(ng0)
    dpdu = V.where(uv_degen, fb_u, dpdu)
    dpdv = V.where(uv_degen, fb_v, dpdv)

    p = v0 * b0 + v1 * b1 + v2 * b2
    u_ = b0 * uv0u + b1 * uv1u + b2 * uv2u
    v_ = b0 * uv0v + b1 * uv1v + b2 * uv2v
    wo = (-d).normalize()
    n_geom = dp13.cross(dp23).normalize()

    ns_interp = n0 * b0 + n1 * b1 + n2 * b2
    ns = V.where(ns_interp.length_squared() > 0, ns_interp.normalize(), n_geom)
    ss0 = dpdu.normalize()
    ts0 = ns.cross(ss0)
    ok = ts0.length_squared() > 0
    ts_n = ts0.normalize()
    ss_n = ts_n.cross(ns)
    _, ss_fb, ts_fb = V.coordinate_system(ns)
    ss = V.where(ok, ss_n, ss_fb)
    ts = V.where(ok, ts_n, ts_fb)

    dn13 = n0 - n2
    dn23 = n1 - n2
    dndu = (dn13 * duv23v - dn23 * duv13v) * inv_uv_det
    dndv = (dn13 * (-duv23u) + dn23 * duv13u) * inv_uv_det
    zero3 = V3.zeros((n,), dev)
    dndu = V.where(uv_degen, zero3, dndu)
    dndv = V.where(uv_degen, zero3, dndv)

    ns_sh = ss.cross(ts).normalize()
    ns_sh = V.where(flip, -ns_sh, ns_sh)
    n_auth = V.face_forward(n_geom, ns_sh)
    new_n = V.where(has_n, n_auth, n_geom)
    new_ns = V.where(has_n, ns_sh, n_geom)
    s_dpdu = V.where(has_n, ss, dpdu)
    s_dpdv = V.where(has_n, ts, dpdv)
    s_dndu = V.where(has_n, dndu, zero3)
    s_dndv = V.where(has_n, dndv, zero3)
    flip_plain = (~has_n) & flip
    new_n = V.where(flip_plain, -new_n, new_n)
    new_ns = V.where(flip_plain, -new_ns, new_ns)

    z = torch.zeros((n,), dtype=F32, device=dev)
    return HitP(
        valid=valid, t=t, p=p, time=time, wo=wo, n=new_n, u=u_, v=v_,
        dpdu=dpdu, dpdv=dpdv, ns=new_ns, s_dpdu=s_dpdu, s_dpdv=s_dpdv,
        s_dndu=s_dndu, s_dndv=s_dndv,
        prim_id=(idx + prim_offset).to(torch.int32), material_id=material_id,
        dudx=z, dudy=z, dvdx=z, dvdy=z, dpdx=zero3, dpdy=zero3,
    )


def make_hit_spheres(rows: torch.Tensor, o: V3, d: V3, time, t, idx, valid,
                     prim_offset: int = 0) -> HitP:
    mt = rows[idx.long()].T                       # [32, N]
    w2o_R = [[mt[0], mt[1], mt[2]], [mt[4], mt[5], mt[6]],
             [mt[8], mt[9], mt[10]]]
    w2o_t = V3(mt[3], mt[7], mt[11])
    o2w_R = [[mt[12], mt[13], mt[14]], [mt[16], mt[17], mt[18]],
             [mt[20], mt[21], mt[22]]]
    o2w_t = V3(mt[15], mt[19], mt[23])
    radius, th_min, th_max, phi_max = mt[24], mt[25], mt[26], mt[27]
    material_id = _bits_to_int(mt[28])
    flip = mt[29] != 0.0

    o_obj = V.mat3_apply(w2o_R, o) + w2o_t
    d_obj = V.mat3_apply(w2o_R, d)
    p = _refine_p(o_obj + d_obj * t, radius)
    phi = _phi_of(p)
    u = phi / phi_max
    theta = torch.arccos((p.z / radius).clamp(-1.0, 1.0))
    v = (theta - th_min) / (th_max - th_min)

    z_radius = torch.sqrt(p.x * p.x + p.y * p.y)
    inv_zr = 1.0 / z_radius.clamp_min(1e-20)
    cos_phi = p.x * inv_zr
    sin_phi = p.y * inv_zr

    n = o.x.shape[0]
    dev = o.x.device
    zeros = torch.zeros((n,), dtype=F32, device=dev)
    dpdu = V3(-phi_max * p.y, phi_max * p.x, zeros)
    dtheta = th_max - th_min
    dpdv = V3(p.z * cos_phi, p.z * sin_phi, -radius * torch.sin(theta)) * dtheta
    d2pduu = V3(p.x, p.y, zeros) * (-phi_max * phi_max)
    d2pduv = V3(-sin_phi, cos_phi, zeros) * (dtheta * p.z * phi_max)
    d2pdvv = -p * (dtheta * dtheta)
    E = dpdu.dot(dpdu)
    Fc = dpdu.dot(dpdv)
    G = dpdv.dot(dpdv)
    n_obj = dpdu.cross(dpdv).normalize()
    e = n_obj.dot(d2pduu)
    f = n_obj.dot(d2pduv)
    g2 = n_obj.dot(d2pdvv)
    inv_egf = 1.0 / (E * G - Fc * Fc).clamp_min(1e-20)
    dndu = dpdu * ((f * Fc - e * G) * inv_egf) + dpdv * (
        (e * Fc - f * E) * inv_egf)
    dndv = dpdu * ((g2 * Fc - f * G) * inv_egf) + dpdv * (
        (f * Fc - g2 * E) * inv_egf)

    p_w = V.mat3_apply(o2w_R, p) + o2w_t
    dpdu_w = V.mat3_apply(o2w_R, dpdu)
    dpdv_w = V.mat3_apply(o2w_R, dpdv)
    dndu_w = V.mat3_apply_t(w2o_R, dndu)
    dndv_w = V.mat3_apply_t(w2o_R, dndv)

    wo = (-d).normalize()
    n_w = dpdu_w.cross(dpdv_w).normalize()
    n_w = V.where(flip, -n_w, n_w)
    zero3 = V3.zeros((n,), dev)
    return HitP(
        valid=valid, t=t, p=p_w, time=time, wo=wo, n=n_w, u=u, v=v,
        dpdu=dpdu_w, dpdv=dpdv_w, ns=n_w, s_dpdu=dpdu_w, s_dpdv=dpdv_w,
        s_dndu=dndu_w, s_dndv=dndv_w,
        prim_id=(idx + prim_offset).to(torch.int32), material_id=material_id,
        dudx=zeros, dudy=zeros, dvdx=zeros, dvdy=zeros,
        dpdx=zero3, dpdy=zero3,
    )


def compute_differentials(hit: HitP, rd: RayP) -> HitP:
    """Screen-space differentials at the hit (planar twin of
    core/interaction.py compute_differentials)."""
    n, p = hit.n, hit.p
    d = -n.dot(p)
    tx = (-n.dot(rd.rx_origin) - d) / n.dot(rd.rx_direction)
    ty = (-n.dot(rd.ry_origin) - d) / n.dot(rd.ry_direction)
    px = rd.rx_origin + rd.rx_direction * tx
    py = rd.ry_origin + rd.ry_direction * ty
    dpdx = px - p
    dpdy = py - p

    an = n.abs()
    use_yz = (an.x > an.y) & (an.x > an.z)
    use_xz = (~use_yz) & (an.y > an.z)

    def pick(v: V3, which):
        if which == 0:
            return torch.where(use_yz, v.y, v.x)
        return torch.where(use_yz | use_xz, v.z, v.y)

    a00 = pick(hit.dpdu, 0)
    a01 = pick(hit.dpdv, 0)
    a10 = pick(hit.dpdu, 1)
    a11 = pick(hit.dpdv, 1)
    det = a00 * a11 - a01 * a10
    inv_det = torch.where(det.abs() < 1e-12, 0.0,
                          1.0 / torch.where(det == 0, 1.0, det))
    bx0 = pick(px, 0) - pick(p, 0)
    bx1 = pick(px, 1) - pick(p, 1)
    by0 = pick(py, 0) - pick(p, 0)
    by1 = pick(py, 1) - pick(p, 1)
    dudx = (a11 * bx0 - a01 * bx1) * inv_det
    dvdx = (a00 * bx1 - a10 * bx0) * inv_det
    dudy = (a11 * by0 - a01 * by1) * inv_det
    dvdy = (a00 * by1 - a10 * by0) * inv_det

    has = rd.has_differentials
    fin = lambda x: torch.where(has & torch.isfinite(x), x, 0.0)
    fin3 = lambda x: V3(fin(x.x), fin(x.y), fin(x.z))
    return hit._replace(dudx=fin(dudx), dvdx=fin(dvdx), dudy=fin(dudy),
                        dvdy=fin(dvdy), dpdx=fin3(dpdx), dpdy=fin3(dpdy))
