"""Cluster cut of the SAH tree, the slab/sort helpers of the sweep, and the
demand-ordered cluster traversal (port of trace_tpu/accel/clusters.py).

The SAH tree is cut into clusters of at most ``leaf_tris`` triangles in
depth-first order; each cluster row carries its triangles' vertices and
Moller-Trumbore constants. The build runs on the host (native C++,
accel/native.py) and is bit-equal to the JAX package's.

``traverse`` is the JAX package's dense cluster sweep, as tensor code (JAX
runs it as plain XLA; it holds no Pallas kernel):

1. one [N, C] slab pass gives every ray's entry distance to every cluster
   (or, with ``super_size`` G > 1, to every union of G consecutive
   clusters);
2. clusters are ordered once by demand (how many rays enter them) and
   swept in stages of ``stage_clusters``, each stage testing its
   triangles against the batch's lanes not yet done (the factored
   Moller-Trumbore test, or the watertight one);
3. a lane retires when the least entry distance over the unswept stages
   (a suffix-min over the demand order) passes its best hit.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from ..shapes import triangle as tri_mod
from ..wavefront.geom import _watertight
from ..core.sync import sync_free
from ..core.vec import V3
from . import mxu as mxu_mod
from . import native

F32 = torch.float32
INF = float("inf")


class ClusterAccel(NamedTuple):
    """Host numpy (the SAH build), or device tensors (accel/morton.py, or
    a ClusterAccelerator's copy), in the JAX package's field order (so a
    positional construction reads the same in both). ``s_lo``/``s_hi``,
    ``packed`` and ``super_size`` serve ``traverse`` (None and 1 from the
    device build); the sweep reads ``c_lo``, ``c_hi``, ``packed_mt``,
    ``tri_id`` and ``leaf_tris``."""
    c_lo: np.ndarray       # [C, 3] cluster AABBs
    c_hi: np.ndarray
    s_lo: np.ndarray | None    # [S, 3] super AABBs, S = ceil(C/G)
    s_hi: np.ndarray | None
    packed: np.ndarray | None  # [C, 9L->%128] v0 | v1 | v2 rows
    packed_mt: np.ndarray  # [C, 16L->%128] MT constants n|e1|e2|w|q|v0n
    tri_id: np.ndarray     # [C, L->%128] int32 global id; -1 = padding
    leaf_tris: int
    super_size: int


def _super_bounds(c_lo: np.ndarray, c_hi: np.ndarray, g: int):
    """Union AABBs of groups of g consecutive clusters; the last group is
    padded with the last cluster's box."""
    c = c_lo.shape[0]
    pad = (-c) % g
    lo = np.concatenate([c_lo, np.repeat(c_lo[-1:], pad, axis=0)])
    hi = np.concatenate([c_hi, np.repeat(c_hi[-1:], pad, axis=0)])
    return (np.ascontiguousarray(lo.reshape(-1, g, 3).min(axis=1)),
            np.ascontiguousarray(hi.reshape(-1, g, 3).max(axis=1)))


def build_clusters(tris: tri_mod.Triangles, leaf_tris: int = 32,
                   max_prims_per_leaf: int = 4,
                   super_size: int = 1) -> ClusterAccel:
    """Build the SAH tree, then cut it at subtrees of <= leaf_tris prims.
    With ``super_size`` G > 1 the cluster tables are padded to whole groups
    of G (padding rows: the last cluster's box, tri_id -1, zero rows)."""
    bvh = native.build_bvh(tri_mod.world_bounds_np(tris), max_prims_per_leaf)
    order = bvh["prim_order"]
    nodes, starts, counts = native.cluster_cut(
        bvh["right_child"], bvh["n_prims"], leaf_tris)
    c_lo = bvh["lo"][nodes]
    c_hi = bvh["hi"][nodes]
    k_grid = np.arange(leaf_tris)[None, :]
    in_range = k_grid < counts[:, None]
    src = np.minimum(starts[:, None] + k_grid, len(order) - 1)
    tri_id = np.where(in_range, order[src], -1).astype(np.int32)
    packed, packed_mt, _, _ = native.cluster_pack(tris.v0, tris.v1, tris.v2,
                                                  tri_id, leaf_tris)
    tri_id = np.pad(tri_id, ((0, 0), (0, (-leaf_tris) % 128)),
                    constant_values=-1)
    g = max(1, int(super_size))
    s_lo, s_hi = _super_bounds(c_lo, c_hi, g)
    pad = (-c_lo.shape[0]) % g
    if pad:
        c_lo = np.concatenate([c_lo, np.repeat(c_lo[-1:], pad, 0)])
        c_hi = np.concatenate([c_hi, np.repeat(c_hi[-1:], pad, 0)])
        packed = np.pad(packed, ((0, pad), (0, 0)))
        packed_mt = np.pad(packed_mt, ((0, pad), (0, 0)))
        tri_id = np.pad(tri_id, ((0, pad), (0, 0)), constant_values=-1)
    return ClusterAccel(np.ascontiguousarray(c_lo),
                        np.ascontiguousarray(c_hi), s_lo, s_hi, packed,
                        packed_mt, tri_id, int(leaf_tris), g)


def refit_clusters(accel: ClusterAccel, v0, v1, v2) -> ClusterAccel:
    """The clusters' bounds, vertex rows and constants for moved vertices
    (host numpy [T, 3]) with the same topology, on the host as in the JAX
    package: the constants through the build's double-precision route,
    the boxes as the clusters' vertex AABBs (and the supers' as their
    unions), so a refit equals a static build of the same clusters bit
    for bit."""
    packed, packed_mt, lo, hi = native.cluster_pack(
        v0, v1, v2, np.asarray(accel.tri_id), accel.leaf_tris)
    s_lo, s_hi = _super_bounds(lo, hi, accel.super_size)
    return accel._replace(c_lo=lo, c_hi=hi, packed_mt=packed_mt,
                          packed=packed, s_lo=s_lo, s_hi=s_hi)


def entry_boxes(lo: torch.Tensor, hi: torch.Tensor, o: torch.Tensor,
                d: torch.Tensor, t_max: torch.Tensor) -> torch.Tensor:
    """Slab entry distance per (ray, box): [N, B], inf on a miss.

    Same rule as the JAX twin, one axis at a time so no [N, B, 3]
    temporary exists: NaN (0 * inf at a slab plane) counts as an open
    slab, and the far plane is widened by 1.00000024 (2 ulp)."""
    inv_d = 1.0 / d
    tn = tf = None
    for a in range(3):
        t0 = (lo[None, :, a] - o[:, a, None]) * inv_d[:, a, None]
        t1 = (hi[None, :, a] - o[:, a, None]) * inv_d[:, a, None]
        near = torch.minimum(t0, t1).nan_to_num_(nan=-float("inf"),
                                                 posinf=float("inf"),
                                                 neginf=-float("inf"))
        far = torch.maximum(t0, t1).nan_to_num_(nan=float("inf"),
                                                posinf=float("inf"),
                                                neginf=-float("inf"))
        tn = near if tn is None else torch.maximum(tn, near)
        tf = far if tf is None else torch.minimum(tf, far)
    tf = tf * 1.00000024
    hit = (tn <= tf) & (tf > 0.0) & (tn < t_max[:, None])
    return torch.where(hit, tn.clamp_min(0.0), float("inf"))


def sort_key(o: torch.Tensor, d: torch.Tensor, lo: torch.Tensor,
             inv_extent: torch.Tensor) -> torch.Tensor:
    """Coherence key per ray: direction octant (3 high bits), then a
    21-bit Morton code of the quantized origin. uint32 arithmetic runs in
    int64."""
    octant = ((d[:, 0] < 0).long() | ((d[:, 1] < 0).long() << 1)
              | ((d[:, 2] < 0).long() << 2))
    q = ((o - lo) * inv_extent * 127.0).clamp(0.0, 127.0).long()

    def spread(x):  # 7 bits -> every third bit
        x = (x | (x << 8)) & 0x0100F00F
        x = (x | (x << 4)) & 0x010C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    morton = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    return (octant << 21) | morton


def sorted_chunks(o, d, t_max, lo, inv_extent, chunk: int, run,
                  sort: bool = True):
    """``run(o, d, t_max)`` -> a tuple of per-ray [n] tensors, over
    ``chunk`` rays at a time (contiguous slices; one empty call for no
    rays); with ``sort`` the rays go in stable :func:`sort_key` order and
    the outputs come back in the caller's."""
    n = o.shape[0]
    order = None
    if sort and n > 1:
        order = torch.argsort(sort_key(o, d, lo, inv_extent), stable=True)
        o, d, t_max = o[order], d[order], t_max[order]
    outs = [run(o[s:s + chunk].contiguous(), d[s:s + chunk].contiguous(),
                t_max[s:s + chunk].contiguous())
            for s in range(0, max(n, 1), chunk)]
    res = tuple(torch.cat(x) for x in zip(*outs))
    if order is None:
        return res
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=order.device)
    return tuple(x[inv] for x in res)


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------


def _bf16_floor(x: torch.Tensor) -> torch.Tensor:
    """f32 truncated onto the bf16 grid (the low 16 mantissa bits masked):
    round toward zero, so a non-negative entry distance stays a lower
    bound and +inf stays +inf; the cast of a value already on the grid is
    exact."""
    bits = x.contiguous().view(torch.int32) & -65536
    return bits.view(F32).to(torch.bfloat16)


def _stage_ids(perm: torch.Tensor, stage: int, h: int) -> torch.Tensor:
    return perm[stage * h:(stage + 1) * h].long()


def _test_stage(accel: ClusterAccel, stage: int, h: int, perm, o, d,
                limit):
    """One stage's h clusters (h*L triangles) against every ray with the
    watertight test -> (best t [N], its triangle id [N])."""
    l = accel.leaf_tris
    seg = l * 3
    cids = _stage_ids(perm, stage, h)
    rows = accel.packed[cids]                                  # [h, P]

    def col(k):
        v = rows[:, k * seg:(k + 1) * seg].reshape(h * l, 3)
        return V3(v[None, :, 0], v[None, :, 1], v[None, :, 2])

    tid = accel.tri_id[cids][:, :l].reshape(h * l)
    ob = V3(o[:, 0, None], o[:, 1, None], o[:, 2, None])
    db = V3(d[:, 0, None], d[:, 1, None], d[:, 2, None])
    hit, t, _, _, _ = _watertight(col(0), col(1), col(2), ob, db,
                                  limit[:, None])
    t = torch.where(hit & (tid[None, :] >= 0), t, INF)
    best_t, j = t.min(dim=-1)
    return best_t, tid[j]


def _dot3(a, r):
    """(a0 r0 + a1 r1) + a2 r2 for rows a [N, 3] and columns r [3, K],
    elementwise (two in-place multiply-adds after a product: three passes
    over the [N, K] result), so a lane's value does not depend on which
    other lanes are tested with it, as a matrix product's could."""
    out = a[:, 0:1] * r[0]
    out.addcmul_(a[:, 1:2], r[1])
    return out.addcmul_(a[:, 2:3], r[2])


def _test_stage_mt(accel: ClusterAccel, stage: int, h: int, perm, o, d, m,
                   limit, certified: bool = False):
    """_test_stage with the factored Moller-Trumbore test: six [N, 3] x
    [3, h*L] three-term dot products, elementwise in f32 (:func:`_dot3`:
    a matrix product's bits could depend on how many lanes a stage tests).
    ``m`` = o x d per ray. ``certified``: every boundary test widened by
    its rounding-error bound (mxu.mt_epilogue_certified)."""
    l = accel.leaf_tris
    seg = l * 3
    cids = _stage_ids(perm, stage, h)
    rows = accel.packed_mt[cids]                               # [h, 16L]

    def rhs(k):
        return rows[:, k * seg:(k + 1) * seg].reshape(h, 3, l).transpose(
            0, 1).reshape(3, h * l)

    n_m, e1_m, e2_m, w_m, q_m = rhs(0), rhs(1), rhs(2), rhs(3), rhs(4)
    v0n = rows[:, 5 * seg:5 * seg + l].reshape(h * l)
    tid = accel.tri_id[cids][:, :l].reshape(h * l)
    det = -_dot3(d, n_m)
    u_det = _dot3(m, e2_m) - _dot3(d, w_m)
    v_det = -_dot3(m, e1_m) - _dot3(d, q_m)
    t_det = _dot3(o, n_m) - v0n[None, :]
    if certified:
        o_a, d_a = o.abs(), d.abs()
        ma = mxu_mod.abs_cross(o_a, d_a)
        eps = mxu_mod.MT_ERR_EPS
        err_det = eps * _dot3(d_a, n_m.abs())
        err_u = eps * (_dot3(ma, e2_m.abs()) + _dot3(d_a, w_m.abs()))
        err_v = eps * (_dot3(ma, e1_m.abs()) + _dot3(d_a, q_m.abs()))
        err_t = eps * (_dot3(o_a, n_m.abs()) + v0n.abs()[None, :])
        ok, t = mxu_mod.mt_epilogue_certified(det, u_det, v_det, t_det,
                                              err_det, err_u, err_v, err_t)
    else:
        ok, t = mxu_mod.mt_epilogue(det, u_det, v_det, t_det)
    hit = ok & (t < limit[:, None]) & (tid[None, :] >= 0)
    t = torch.where(hit, t, INF)
    best_t, j = t.min(dim=-1)
    return best_t, tid[j]


def _stage_table(entry: torch.Tensor, h: int):
    """(perm [K] i32 by descending demand, stable; entry_stage [N, S]: the
    least entry of each stage of h columns in that order; S)."""
    n, k = entry.shape
    demand = torch.isfinite(entry).sum(dim=0)
    perm = torch.argsort(-demand, stable=True).to(torch.int32)
    entry_g = entry[:, perm.long()]
    n_stages = -(-k // h)
    pad = n_stages * h - k
    if pad:
        entry_g = torch.cat([entry_g, entry_g.new_full((n, pad), INF)], 1)
    return perm, entry_g.reshape(n, n_stages, h).amin(dim=2), n_stages


def traverse(accel: ClusterAccel, o, d, t_max, stage_clusters: int = 64,
             any_hit: bool = False, use_mxu: bool = True,
             entry_bf16: bool = True, certified: bool = False,
             stats: dict | None = None):
    """Closest-hit (or any-hit) through the dense demand-ordered cluster
    sweep. ``accel`` holds tensors on the rays' device. Returns (hit [N]
    bool, t [N], tri_id [N] i32). ``stats`` (a dict) receives the stages
    swept (``stages``), the calls (``calls``) and the most stages a call
    has (``most_stages``). Under core/sync.py's no_host_reads every stage
    runs over every lane (a lane that is done tests against a limit of
    -inf, so the result is the same); otherwise each stage tests only the
    lanes not yet done, the sweep stops once every lane is done, and a
    call with no lane whose t_max >= 0 (uncertified) returns at once."""
    n = o.shape[0]
    c = accel.c_lo.shape[0]
    g = accel.super_size
    dev = o.device
    if not certified and not sync_free() and not bool((t_max >= 0).any()):
        # No lane can hit (the plain epilogue's t is > 0, and a hit needs
        # t < t_max): every lane gives what the sweep gives it, without
        # the [N, C] entry table.
        if stats is not None:
            for k in ("stages", "most_stages"):
                stats[k] = stats.get(k, 0)
            stats["calls"] = stats.get("calls", 0) + 1
        return (torch.zeros(n, dtype=torch.bool, device=dev),
                torch.full((n,), INF, dtype=F32, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev))
    if g > 1:
        # A super's entry lower-bounds its members': the demand order and
        # the early-out stay conservative.
        h = max(g, (min(stage_clusters, c) // g) * g)
        entry = entry_boxes(accel.s_lo, accel.s_hi, o, d, t_max)  # [N, S]
        if entry_bf16:
            entry = _bf16_floor(entry)
        perm_s, entry_stage, n_stages = _stage_table(entry, h // g)
        perm = (perm_s[:, None] * g + torch.arange(
            g, dtype=torch.int32, device=dev)[None, :]).reshape(-1)
    else:
        h = min(stage_clusters, c)
        entry = entry_boxes(accel.c_lo, accel.c_hi, o, d, t_max)  # [N, C]
        if entry_bf16:
            entry = _bf16_floor(entry)
        perm, entry_stage, n_stages = _stage_table(entry, h)
    # Zero-padded to a whole last stage (it repeats cluster 0: harmless).
    perm = torch.cat([perm, perm.new_zeros(n_stages * h - perm.shape[0])])
    # suffix[:, s] = least entry over stages >= s; inf past the last.
    suffix = torch.flip(torch.cummin(torch.flip(entry_stage, [1]), 1).values,
                        [1])
    suffix = torch.cat([suffix, suffix.new_full((n, 1), INF)], 1)

    m = torch.stack([o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1],
                     o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
                     o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0]], 1)
    best_t = torch.full((n,), INF, dtype=F32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    s = 0
    static = sync_free()   # every stage: no host read (core/sync.py)
    while s < n_stages:
        if static:
            # Every lane, a done one against a limit of -inf.
            lane = None
            limit = torch.where(done, -INF, torch.minimum(best_t, t_max))
            oa, da, ma = o, d, m
        else:
            # Only the lanes not done (the stage's one host read): each
            # lane's test reads its own row alone, so the result is the
            # same as testing every lane.
            lane = (~done).nonzero().squeeze(1)
            if lane.numel() == 0:
                break
            limit = torch.minimum(best_t[lane], t_max[lane])
            oa, da, ma = o[lane], d[lane], m[lane]
        if use_mxu:
            st, si = _test_stage_mt(accel, s, h, perm, oa, da, ma, limit,
                                    certified)
        else:
            st, si = _test_stage(accel, s, h, perm, oa, da, limit)
        if lane is None:
            better = st < best_t
            best_t = torch.where(better, st, best_t)
            best_i = torch.where(better, si, best_i)
        else:
            bt, bi = best_t[lane], best_i[lane]
            better = st < bt
            best_t[lane] = torch.where(better, st, bt)
            best_i[lane] = torch.where(better, si, bi)
        if any_hit:
            # Retire on a hit only: JAX's best_t <= t_max also retires a
            # lane with no hit when t_max = inf (ROADMAP C).
            done = done | ((best_i >= 0) & (best_t <= t_max))
        done = done | (suffix[:, s + 1] >= torch.minimum(best_t, t_max))
        s += 1
    if stats is not None:
        stats["stages"] = stats.get("stages", 0) + s
        stats["calls"] = stats.get("calls", 0) + 1
        stats["most_stages"] = max(stats.get("most_stages", 0), n_stages)
    hit = (best_i >= 0) & (best_t <= t_max)
    return hit, torch.where(hit, best_t, INF), best_i.clamp_min(0)


ARRAY_FIELDS = ("c_lo", "c_hi", "s_lo", "s_hi", "packed", "packed_mt",
                "tri_id")


def to_device(accel: ClusterAccel, device) -> ClusterAccel:
    """The accel's arrays as tensors on ``device`` (a tensor already
    there is kept, not copied)."""
    def dev(a):
        return None if a is None else torch.as_tensor(a).to(device)
    return accel._replace(**{f: dev(getattr(accel, f)) for f in ARRAY_FIELDS})


def to_host(accel: ClusterAccel) -> ClusterAccel:
    """The accel's arrays as host numpy arrays."""
    def host(a):
        return a.cpu().numpy() if torch.is_tensor(a) else a
    return accel._replace(**{f: host(getattr(accel, f)) for f in ARRAY_FIELDS})


class ClusterAccelerator:
    """Triangle closest-hit / any-hit through :func:`traverse` (the
    interface of ops/sweep.py::SweepAccelerator). Rays go in chunks of
    ``ray_chunk``, so the [rays x clusters] entry table stays bounded; a
    batch of several chunks is coherence-sorted first (``sort_key``), so
    each chunk's sweep retires early. ``certified``: the widened epilogue
    (exact_shared_edges)."""

    def __init__(self, accel: ClusterAccel, device, stage_clusters: int = 64,
                 ray_chunk: int = 16384, sort_rays: bool = True,
                 certified: bool = False):
        self.device = torch.device(device)
        self.stage_clusters = int(stage_clusters)
        self.ray_chunk = int(ray_chunk)
        self.sort_rays = bool(sort_rays)
        self.certified = bool(certified)
        self.stats = {}
        self._load(accel)

    def _load(self, accel: ClusterAccel) -> None:
        self.clusters = accel
        self.dev_clusters = to_device(accel, self.device)
        host = lambda a: a.cpu().numpy() if torch.is_tensor(a) else \
            np.asarray(a)
        lo = host(accel.c_lo).min(axis=0)
        hi = host(accel.c_hi).max(axis=0)
        self.world_lo = torch.from_numpy(lo).to(self.device)
        self.world_inv_extent = torch.from_numpy(
            (1.0 / np.maximum(hi - lo, 1e-12)).astype(np.float32)).to(
                self.device)

    def view(self, stage_clusters: int | None = None,
             ray_chunk: int | None = None,
             certified: bool | None = None) -> "ClusterAccelerator":
        """A copy with other traversal options that shares this one's
        device tensors (a frame's accelerator, integrators/common.py)."""
        v = copy.copy(self)
        if stage_clusters is not None:
            v.stage_clusters = int(stage_clusters)
        if ray_chunk is not None:
            v.ray_chunk = int(ray_chunk)
        if certified is not None:
            v.certified = bool(certified)
        v.stats = {}
        return v

    def refit(self, v0, v1, v2) -> None:
        """Refresh the clusters for moved vertices [T, 3] (host or device)
        with the same topology (refit_clusters, on the host)."""
        host = [x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                for x in (v0, v1, v2)]
        self._load(refit_clusters(self.clusters, *host))

    def _run(self, o, d, t_max, any_hit):
        return traverse(self.dev_clusters, o, d, t_max, self.stage_clusters,
                        any_hit, certified=self.certified, stats=self.stats)

    def intersect(self, o, d, t_max, any_hit: bool):
        """Rays o, d [N, 3], t_max [N] -> (hit [N], t [N], tri [N] i32)."""
        if o.shape[0] <= self.ray_chunk:
            return self._run(o, d, t_max, any_hit)
        return sorted_chunks(o, d, t_max, self.world_lo,
                             self.world_inv_extent, self.ray_chunk,
                             lambda *r: self._run(*r, any_hit),
                             self.sort_rays)


def attach(scene, leaf_tris: int = 32, stage_clusters: int = 64,
           max_prims_per_leaf: int = 4, ray_chunk: int = 16384,
           super_size: int = 1, certified: bool | None = None):
    """Build the cluster accelerator for the scene's triangles and install
    it; ``certified`` defaults to the scene's exact_shared_edges."""
    if scene.n_triangles == 0:
        return scene
    if certified is None:
        certified = bool(scene.exact_edges)
    acc = build_clusters(tri_mod.to_numpy(scene.triangles), leaf_tris,
                         max_prims_per_leaf, super_size=super_size)
    scene.accel = ClusterAccelerator(acc, scene.device, stage_clusters,
                                     ray_chunk, certified=certified)
    return scene
