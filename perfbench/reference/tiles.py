"""Ray queries over the heightfield by a plain structure of the
reference's own: the grid's quads in square tiles, each tile's box, then
every triangle of every tile a ray's box test lets through, in float64.

Tile (a, b) holds the quads (i, j) with i // side == a and j // side == b,
both triangles of each: ids q and (n-1)^2 + q of quad q = i (n-1) + j, as
scenes/heightfield.py numbers them. A tile's id list is padded with -1.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
INF = float("inf")


class TileGrid:
    def __init__(self, verts: np.ndarray, n: int, device, side: int = 16,
                 pair_chunk: int = 1 << 13, ray_block: int = 1 << 13):
        q = n - 1
        nt = -(-q // side)
        ti, tj = np.meshgrid(np.arange(nt), np.arange(nt), indexing="ij")
        di, dj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
        qi = ti.reshape(-1, 1) * side + di.reshape(1, -1)    # [tiles, s*s]
        qj = tj.reshape(-1, 1) * side + dj.reshape(1, -1)
        inside = (qi < q) & (qj < q)
        quad = np.where(inside, qi * q + qj, -1)
        ids = np.concatenate([quad, np.where(inside, quad + q * q, -1)], 1)
        v = verts.astype(np.float64)
        corner = lambda a, b: v[np.clip(qi + a, 0, n - 1) * n
                                + np.clip(qj + b, 0, n - 1)]
        pts = np.stack([corner(a, b) for a in (0, 1) for b in (0, 1)], 2)
        big = np.where(inside[:, :, None, None], pts, np.nan)
        lo = np.nanmin(big.reshape(big.shape[0], -1, 3), axis=1)
        hi = np.nanmax(big.reshape(big.shape[0], -1, 3), axis=1)
        pad = 1e-6 * np.maximum(1.0, np.abs(np.concatenate([lo, hi])).max())
        self.device = torch.device(device)
        self.n = n
        self.lo = torch.from_numpy(lo - pad).to(self.device)
        self.hi = torch.from_numpy(hi + pad).to(self.device)
        self.ids = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        self.verts = torch.from_numpy(v).to(self.device)
        self.pair_chunk = pair_chunk
        self.ray_block = ray_block

    def triangle_vertices(self, tri: torch.Tensor):
        """[..., 3, 3] float64 vertices of triangle ids (>= 0)."""
        n, q = self.n, self.n - 1
        second = tri >= q * q
        quad = torch.where(second, tri - q * q, tri)
        i, j = quad // q, quad % q
        v00 = i * n + j
        a = torch.where(second, v00 + 1, v00)
        b = v00 + n
        c = torch.where(second, v00 + n + 1, v00 + 1)
        return torch.stack([self.verts[a], self.verts[b], self.verts[c]], -2)

    def _pairs(self, o, d, t_max):
        """(ray, tile) pairs whose boxes the rays enter within [0, t_max]."""
        out_r, out_t = [], []
        for s in range(0, o.shape[0], self.ray_block):
            oo, dd = o[s:s + self.ray_block], d[s:s + self.ray_block]
            inv = 1.0 / torch.where(dd == 0.0, 1e-300, dd)
            t1 = (self.lo[None] - oo[:, None]) * inv[:, None]
            t2 = (self.hi[None] - oo[:, None]) * inv[:, None]
            t_in = torch.minimum(t1, t2).amax(-1)
            t_out = torch.maximum(t1, t2).amin(-1)
            tm = t_max[s:s + self.ray_block, None]
            r, t = torch.nonzero((t_in <= t_out) & (t_out >= 0.0)
                                 & (t_in <= tm), as_tuple=True)
            out_r.append(r + s)
            out_t.append(t)
        return torch.cat(out_r), torch.cat(out_t)

    def intersect(self, o, d, t_max):
        """Closest hit (t [N] float64, +inf for none, triangle id [N], -1
        for none) of rays o, d [N, 3] float64 with t in (0, t_max]."""
        n_rays = o.shape[0]
        best = torch.full((n_rays,), INF, dtype=F64, device=self.device)
        none = torch.iinfo(torch.int64).max
        best_id = torch.full((n_rays,), none, dtype=torch.int64,
                             device=self.device)
        rays, tiles = self._pairs(o, d, t_max)
        for s in range(0, rays.shape[0], self.pair_chunk):
            r = rays[s:s + self.pair_chunk]
            ids = self.ids[tiles[s:s + self.pair_chunk]]     # [P, K]
            t = moller_trumbore(o[r][:, None], d[r][:, None],
                                self.triangle_vertices(ids.clamp_min(0)))
            t = torch.where((ids >= 0) & (t <= t_max[r][:, None]), t, INF)
            tb, kb = t.min(1)
            best.scatter_reduce_(0, r, tb, "amin")
            win = tb == best[r]
            cand = torch.where(win & torch.isfinite(tb),
                               ids.gather(1, kb[:, None])[:, 0],
                               none)
            best_id.scatter_reduce_(0, r, cand, "amin")
        best_id = torch.where(torch.isfinite(best) & (best_id != none),
                              best_id, -1)
        return best, best_id


def moller_trumbore(o, d, tri):
    """t of rays o, d [..., 3] against triangles [..., 3, 3]; +inf where
    the ray misses or t <= 0 (edges and vertices count as hits)."""
    v0, v1, v2 = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    e1, e2 = v1 - v0, v2 - v0
    p = torch.linalg.cross(*torch.broadcast_tensors(d, e2))
    det = (e1 * p).sum(-1)
    ok = det.abs() > 1e-300
    inv = 1.0 / torch.where(ok, det, 1.0)
    s = o - v0
    u = (s * p).sum(-1) * inv
    qv = torch.linalg.cross(*torch.broadcast_tensors(s, e1))
    v = (d * qv).sum(-1) * inv
    t = (e2 * qv).sum(-1) * inv
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 0.0)
    return torch.where(hit, t, INF)


def sphere_t(o, d, center, radius: float, t_max):
    """The program's rule for a sphere: the nearer root at or past 0, else
    the farther, within t_max; +inf for none. Float64."""
    oc = o - torch.as_tensor(center, dtype=F64, device=o.device)
    a = (d * d).sum(-1)
    b = 2.0 * (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    t = torch.where(t0 >= 0.0, t0, t1)
    hit = (disc >= 0.0) & (t1 >= 0.0) & (t <= t_max)
    return torch.where(hit, t, INF)
