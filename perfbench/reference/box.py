"""The Cornell box of the benchmark's path-tracing configuration, for the
reference: its triangles (each quad split as (v0, v1, v2), (v0, v2, v3)),
spheres, materials and area lights from the scene description, closest
and any hits by direct tests, and each hit's frame. Float64 on
``device``; the description's numbers are rounded to float32 first, as
the program stores them.

The frame a BSDF is sampled in is the one the reference renderer derives
from the surface's parametrisation (pbrt-v3's dpdu): a triangle's first
edge, v1 - v0 (its default uvs (0, 0), (1, 0), (1, 1)), a sphere's
azimuthal tangent (-y, x, 0) about its centre; the normal is a
triangle's (v0 - v2) x (v1 - v2) and a sphere's outward normal; the
third axis is n x s."""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
INF = float("inf")


def _f32(x):
    return np.asarray(x, np.float32).astype(np.float64)


class Box:
    """The description's geometry, materials and lights on ``device``."""

    def __init__(self, desc: dict, device):
        self.dev = torch.device(device)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=F64,
                                      device=self.dev)
        names = [m["name"] for m in desc["materials"]]
        self.materials = desc["materials"]
        tris, mat, light = [], [], []
        emitters = []                 # per light: (its triangles, rgb)
        for q in desc["quads"]:
            v = _f32(q["verts"])
            first = len(tris)
            tris += [v[[0, 1, 2]], v[[0, 2, 3]]]
            mat += [names.index(q["material"])] * 2
            if q.get("emission") is not None:
                light += [len(emitters)] * 2
                emitters.append(([first, first + 1], _f32(q["emission"])))
            else:
                light += [-1, -1]
        tv = np.stack(tris)                                  # [T, 3, 3]
        self.n_tris = tv.shape[0]
        self.v0, self.v1, self.v2 = (t(tv[:, k]) for k in range(3))
        n = torch.linalg.cross(self.v0 - self.v2, self.v1 - self.v2)
        self.tri_n = n / n.norm(dim=-1, keepdim=True)
        s = self.v1 - self.v0
        self.tri_s = s / s.norm(dim=-1, keepdim=True)
        self.tri_light = torch.as_tensor(light, device=self.dev)
        sph = desc["spheres"]
        self.n_sph = len(sph)
        self.center = t(np.stack([_f32(s["center"]) for s in sph]))
        self.radius = t(np.array([_f32(s["radius"]) for s in sph]))
        self.mat = torch.as_tensor(
            mat + [names.index(s["material"]) for s in sph], device=self.dev)
        self.lights = []
        for tri_ids, le in emitters:
            a = torch.linalg.cross(self.v1[tri_ids] - self.v0[tri_ids],
                                   self.v2[tri_ids] - self.v0[tri_ids])
            area = 0.5 * a.norm(dim=-1)
            self.lights.append(dict(tris=torch.as_tensor(tri_ids,
                                                         device=self.dev),
                                    cdf=torch.cumsum(area, 0) / area.sum(),
                                    area=float(area.sum()), le=t(le)))

    # -- hits ---------------------------------------------------------

    def _tri_t(self, o, d, t_max):
        """[N, T] hit distances (inf where none) of the triangles,
        Moller-Trumbore in float64; hits at t in (0, t_max]."""
        e1 = (self.v1 - self.v0)[None]
        e2 = (self.v2 - self.v0)[None]
        dd = d[:, None, :]
        pv = torch.linalg.cross(dd, e2, dim=-1)
        det = (e1 * pv).sum(-1)
        ok = det != 0.0
        inv = 1.0 / torch.where(ok, det, 1.0)
        tv = o[:, None, :] - self.v0[None]
        u = (tv * pv).sum(-1) * inv
        qv = torch.linalg.cross(tv, e1, dim=-1)
        v = (dd * qv).sum(-1) * inv
        t = (e2 * qv).sum(-1) * inv
        hit = (ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
               & (t <= t_max[:, None]))
        return torch.where(hit, t, INF)

    def _sph_t(self, o, d, t_max):
        """[N, S] nearest hit distances of the spheres in (0, t_max]."""
        oc = o[:, None, :] - self.center[None]
        dd = d[:, None, :]
        a = (dd * dd).sum(-1)
        b = (oc * dd).sum(-1)
        # The distance of the centre from the ray's line, without the
        # cancellation of |oc|^2 - r^2 far from the sphere.
        perp = (oc - dd * (b / a)[..., None]).norm(dim=-1)
        r = self.radius[None]
        disc = a * (r - perp) * (r + perp)
        sq = disc.clamp_min(0.0).sqrt()
        q = -(b + torch.where(b < 0, -sq, sq))
        t0 = q / a
        t1 = ((oc * oc).sum(-1) - r * r) / torch.where(q == 0, 1.0, q)
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        t = torch.where(lo > 0, lo, hi)
        hit = (disc >= 0) & (t > 0) & (t <= t_max[:, None])
        return torch.where(hit, t, INF)

    def closest(self, o, d, t_max=None):
        """(t, primitive: triangles 0..T-1, then spheres; -1 for a miss)."""
        if t_max is None:
            t_max = torch.full(o.shape[:1], INF, dtype=F64, device=self.dev)
        ts = torch.cat([self._tri_t(o, d, t_max), self._sph_t(o, d, t_max)],
                       1)
        t, prim = ts.min(1)
        return t, torch.where(torch.isfinite(t), prim, -1)

    def occluded(self, o, d, t_max):
        return (torch.isfinite(self._tri_t(o, d, t_max)).any(1)
                | torch.isfinite(self._sph_t(o, d, t_max)).any(1))

    def frame(self, prim, p):
        """(n, s, t) unit frames [N, 3] at points p on primitives ``prim``
        (all hits)."""
        is_tri = prim < self.n_tris
        ti = prim.clamp(0, self.n_tris - 1)
        si = (prim - self.n_tris).clamp(0, self.n_sph - 1)
        pc = p - self.center[si]
        n_s = pc / pc.norm(dim=-1, keepdim=True)
        s_s = torch.stack([-pc[:, 1], pc[:, 0], torch.zeros_like(pc[:, 0])],
                          1)
        s_s = s_s / s_s.norm(dim=-1, keepdim=True)
        n = torch.where(is_tri[:, None], self.tri_n[ti], n_s)
        s = torch.where(is_tri[:, None], self.tri_s[ti], s_s)
        return n, s, torch.linalg.cross(n, s, dim=-1)

    def light_of(self, prim):
        """The light index of each primitive (-1: none)."""
        ti = prim.clamp(0, self.n_tris - 1)
        return torch.where((prim >= 0) & (prim < self.n_tris),
                           self.tri_light[ti], -1)

    def sample_light(self, j: int, p, u0, u1):
        """A point by area on light j's triangles, seen from p ->
        (radiance [N, 3], wi, solid-angle pdf [N], the point)."""
        lt = self.lights[j]
        cdf = lt["cdf"]
        m = cdf.shape[0]
        pick = (cdf[None, :] < u0[:, None]).sum(1).clamp(0, m - 1)
        lo = torch.where(pick > 0, cdf[(pick - 1).clamp_min(0)], 0.0)
        hi = cdf[pick]
        u0r = ((u0 - lo) / (hi - lo).clamp_min(1e-12)).clamp(0.0, 1.0)
        tri = lt["tris"][pick]
        v0, v1, v2 = self.v0[tri], self.v1[tri], self.v2[tri]
        su = u0r.sqrt()
        b0 = (1.0 - su)[:, None]
        b1 = (u1 * su)[:, None]
        pa = v0 * (1.0 - b0 - b1) + v1 * b0 + v2 * b1
        na = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
        na = na / na.norm(dim=-1, keepdim=True)
        to = pa - p
        d2 = (to * to).sum(-1).clamp_min(1e-20)
        wi = to / d2.sqrt()[:, None]
        cos_l = -(na * wi).sum(-1)
        pdf = d2 / (cos_l.abs() * lt["area"]).clamp_min(1e-20)
        le = torch.where((cos_l > 1e-9)[:, None], lt["le"][None], 0.0)
        return le, wi, pdf, pa
