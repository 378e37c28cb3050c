"""Per-ray BVH walk over packed row matrices (port of
trace_tpu/accel/wbvh.py).

The SAH tree (accel/bvh.py) is packed once on the host into an [M, 8]
node matrix and leaf-ordered [T, 12] triangle rows, bit for bit as the
JAX package packs them. Each ray then walks the tree from the root with
its own stack: front to back by the sign of its direction on each node's
split axis, every triangle of a leaf through the watertight test
(wavefront/geom.py::_watertight), any-hit retiring at the first hit. On a
card the walk is one CUDA kernel, a thread a ray (csrc/bvh_walk.cu via
ops/bvh_walk.py); on the CPU it is :func:`walk_plain`, the batched
translation of the JAX package's ``traverse_batch`` with the kernel's
signature and arithmetic. :func:`walk` picks by device and never falls
back from one to the other.

Two faults of the JAX walks are not carried over: a leaf is scanned to
its ``n_prims`` (the JAX walks stop at ``max_leaf``, and the builders'
coincident-centroid leaves are larger), and an accelerator refuses a
stack too small for its tree (the JAX walks drop the far child on
overflow).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.vec import V3
from ..shapes import triangle as tri_mod
from ..ops.bvh_walk import LIMITS, STACK_CAP, walk_kernel
from ..utils.stats import spanned
from ..wavefront.geom import _watertight
from .bvh import LinearBVH, build_bvh
from .clusters import sorted_chunks

F32 = torch.float32
I32 = torch.int32
INF = float("inf")
# Rays a launch: the kernel runs a thread a ray, and a launch lasts as
# long as its slowest warp, so one launch a call overlaps every walk of the
# call with the longest (the card holds ~170k of its threads at once, 132
# SMs x 10 CTAs of 128); the JAX package's 16384 a chunk would run the
# longest walks one chunk after another.
RAY_CHUNK = 1 << 20


def pack_nodes(bvh: LinearBVH) -> np.ndarray:
    """Host [M, 8] node matrix: cols 0-2 lo, 3-5 hi, col 6 the link (leaf:
    its first row of the leaf-ordered triangle matrix; interior: the
    right child), col 7 the meta ``(n_prims << 2) | axis``; both int32
    bitcast to f32."""
    lo = np.asarray(bvh.lo, np.float32)
    hi = np.asarray(bvh.hi, np.float32)
    m = lo.shape[0]
    right = np.asarray(bvh.right_child, np.int32)
    start = np.asarray(bvh.prim_start, np.int32)
    count = np.asarray(bvh.n_prims, np.int32)
    axis = np.asarray(bvh.axis, np.int32)
    out = np.zeros((m, 8), np.float32)
    out[:, 0:3] = lo
    out[:, 3:6] = hi
    link = np.where(count > 0, start, right).astype(np.int32)
    meta = ((count << 2) | axis).astype(np.int32)
    out[:, 6] = link.view(np.float32)
    out[:, 7] = meta.view(np.float32)
    return out


def pack_leaf_tris(tris, order: np.ndarray) -> np.ndarray:
    """Host [T, 12] leaf-ordered triangle rows: v0 v1 v2, the original id
    (bitcast) and two zero pads; a leaf's triangles are consecutive rows."""
    v0 = np.asarray(tris.v0, np.float32)[order]
    v1 = np.asarray(tris.v1, np.float32)[order]
    v2 = np.asarray(tris.v2, np.float32)[order]
    t = order.shape[0]
    out = np.zeros((max(t, 1), 12), np.float32)
    if t:
        out[:, 0:3] = v0
        out[:, 3:6] = v1
        out[:, 6:9] = v2
        out[:, 9] = np.asarray(order, np.int32).view(np.float32)
    return out


def _depth(count: np.ndarray, right: np.ndarray) -> int:
    """Interior depth by breadth-first frontiers over the flattened layout
    (first child i + 1, second ``right``)."""
    count = np.asarray(count, np.int64)
    right = np.asarray(right, np.int64)
    frontier = np.array([0], np.int64)
    depth = 0
    while frontier.size:
        interior = frontier[count[frontier] == 0]
        if interior.size == 0:
            break
        frontier = np.concatenate([interior + 1, right[interior]])
        depth += 1
    return depth


def tree_depth(bvh: LinearBVH) -> int:
    """The tree's interior depth: the most far children a walk can hold
    on its stack at once."""
    return _depth(bvh.n_prims, bvh.right_child)


def nodes_depth(nodes_mat: np.ndarray) -> int:
    """:func:`tree_depth` of a packed node matrix."""
    bits = np.ascontiguousarray(nodes_mat[:, 6:8]).view(np.int32)
    return _depth(bits[:, 1] >> 2, bits[:, 0])


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------


def _slab(rows, o: V3, ix, iy, iz, limit):
    """Whether each lane enters its node's box before ``limit``: per axis
    a NaN-propagating min / max, a NaN (the origin on the slab plane, d =
    0) healed to an open slab, the far distance padded by 1.00000024."""
    def near_far(lo, hi, oc, inv):
        a = (lo - oc) * inv
        b = (hi - oc) * inv
        near = torch.minimum(a, b)
        far = torch.maximum(a, b)
        return (torch.where(torch.isnan(near), -INF, near),
                torch.where(torch.isnan(far), INF, far))

    nx, fx = near_far(rows[:, 0], rows[:, 3], o.x, ix)
    ny, fy = near_far(rows[:, 1], rows[:, 4], o.y, iy)
    nz, fz = near_far(rows[:, 2], rows[:, 5], o.z, iz)
    tn = torch.maximum(torch.maximum(nx, ny), nz)
    tf = torch.minimum(torch.minimum(fx, fy), fz) * 1.00000024
    return (tn <= tf) & (tf > 0.0) & (tn < limit)


def walk_plain(nodes, tris, o, d, t_max, *, any_hit: bool,
               limit: str = "wbvh", stack_depth: int = STACK_CAP,
               collect_stats: bool = False, seen=None):
    """Plain PyTorch version of the walk kernel (ops/bvh_walk.py): every
    ray takes one tree step a loop trip, with an [N, stack_depth] stack,
    until no lane is live. Same signature, rules and association order
    as the kernel (csrc/bvh_walk.cu's note): (t [N], +inf on a miss; id
    [N] i32, -1 on a miss[; stats [2, N] i32: node visits, triangle
    tests]); ``seen`` (u8 [M + T], with ``collect_stats``) gets a 1 at
    every node row and (after the M nodes) triangle row a walk touched."""
    if limit not in LIMITS:
        raise ValueError(f"limit must be one of {LIMITS}, not {limit!r}")
    if seen is not None and not collect_stats:
        raise ValueError("seen is filled only with collect_stats")
    n = o.shape[0]
    dev = o.device
    n_tri = tris.shape[0]
    bits = nodes[:, 6:8].contiguous().view(I32)
    link_col, meta_col = bits[:, 0].long(), bits[:, 1]
    ids_col = tris[:, 9].contiguous().view(I32)
    ov, dv = V3.of(o), V3.of(d)
    ix, iy, iz = 1.0 / dv.x, 1.0 / dv.y, 1.0 / dv.z
    negx, negy, negz = ix < 0.0, iy < 0.0, iz < 0.0
    bvh_limit = limit == "bvh"
    t_inf = torch.full((n,), INF, dtype=F32, device=dev)

    cur = torch.where(t_max > 0.0, 0, -1).long()
    sp = torch.zeros(n, dtype=torch.long, device=dev)
    stack = torch.zeros((n, stack_depth), dtype=torch.long, device=dev)
    bt = t_max.clone()
    bi = torch.full((n,), -1, dtype=I32, device=dev)
    visits = torch.zeros(n, dtype=I32, device=dev)
    tests = torch.zeros(n, dtype=I32, device=dev)
    while True:
        live = cur >= 0
        if not bool(live.any()):
            break
        c = cur.clamp_min(0)
        rows = nodes[c]
        link = link_col[c]
        meta = meta_col[c]
        nprim = meta >> 2
        box = live & _slab(rows, ov, ix, iy, iz, bt)
        is_leaf = nprim > 0
        do_leaf = box & is_leaf
        visits += live.to(I32)
        if seen is not None:
            seen[c[live]] = 1
        if bool(do_leaf.any()):
            for k in range(int(nprim[do_leaf].max())):
                act = do_leaf & (k < nprim)
                r = (link + k).clamp(0, n_tri - 1)
                tr = tris[r]
                h, t, _, _, _ = _watertight(
                    V3(tr[:, 0], tr[:, 1], tr[:, 2]),
                    V3(tr[:, 3], tr[:, 4], tr[:, 5]),
                    V3(tr[:, 6], tr[:, 7], tr[:, 8]), ov, dv,
                    t_inf if bvh_limit else bt)
                # bt starts at t_max and only falls: t < bt is also the
                # "bvh" walk's t <= t_max.
                better = act & h & (t < bt)
                bt = torch.where(better, t, bt)
                bi = torch.where(better, ids_col[r], bi)
                tests += act.to(I32)
                if seen is not None:
                    seen[nodes.shape[0] + r[act]] = 1
        # Interior: the near child next (by the direction's sign on the
        # split axis), the far one pushed; otherwise pop.
        axis = meta & 3
        neg = torch.where(axis == 0, negx, torch.where(axis == 1, negy, negz))
        first = cur + 1
        near = torch.where(neg, link, first)
        far = torch.where(neg, first, link)
        descend = box & ~is_leaf
        push = descend & (sp < stack_depth)
        lanes = push.nonzero()[:, 0]
        stack[lanes, sp[lanes]] = far[lanes]
        sp2 = torch.where(push, sp + 1, sp)
        pop_sp = (sp2 - 1).clamp_min(0)
        popped = torch.where(sp2 > 0, stack.gather(1, pop_sp[:, None])[:, 0],
                             -1)
        nxt = torch.where(descend, near, popped)
        sp = torch.where(descend, sp2, pop_sp)
        if any_hit:
            nxt = torch.where(bi >= 0, -1, nxt)
        cur = torch.where(live, nxt, -1)
    out_t = torch.where(bi >= 0, bt, INF)
    if collect_stats:
        return out_t, bi, torch.stack([visits, tests])
    return out_t, bi


def walk(nodes, tris, o, d, t_max, *, any_hit: bool, limit: str = "wbvh",
         stack_depth: int = STACK_CAP, collect_stats: bool = False,
         seen=None):
    """The walk: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    kw = dict(any_hit=any_hit, limit=limit, stack_depth=stack_depth,
              collect_stats=collect_stats, seen=seen)
    if o.device.type == "cuda":
        return walk_kernel(nodes, tris, o, d, t_max, **kw)
    if o.device.type == "cpu":
        return walk_plain(nodes, tris, o, d, t_max, **kw)
    raise ValueError(f"bvh walk: unsupported device {o.device}")


class TreeWalk:
    """A packed tree on a device and its walk, answering the accelerator
    interface ``intersect(o, d, t_max, any_hit) -> (hit, t, tri)``.
    ``limit``: the walk kernel's "wbvh" or "bvh" arm. With ``sort_rays``
    the rays are coherence-sorted first (direction octant, then the Morton
    order of the origin; on a card neighbouring threads then walk similar
    paths) and walked ``ray_chunk`` at a time. ValueError when
    ``stack_depth`` is below the tree's depth + 2 or above STACK_CAP."""

    def __init__(self, nodes_mat: np.ndarray, tris_mat: np.ndarray, device,
                 stack_depth: int, limit: str = "wbvh",
                 ray_chunk: int = RAY_CHUNK, sort_rays: bool = False):
        self.depth = nodes_depth(nodes_mat)
        need = self.depth + 2
        if need > STACK_CAP:
            raise ValueError(f"the tree is {self.depth} deep: its walk needs "
                             f"a stack of {need}, above the kernel's "
                             f"{STACK_CAP}")
        if not need <= stack_depth <= STACK_CAP:
            raise ValueError(f"stack_depth {stack_depth}: the tree is "
                             f"{self.depth} deep, so it must be in "
                             f"[{need}, {STACK_CAP}]")
        if limit not in LIMITS:
            raise ValueError(f"limit must be one of {LIMITS}, not {limit!r}")
        dev = torch.device(device)
        self.nodes_mat = nodes_mat
        self.tris_mat = tris_mat
        self.nodes = torch.from_numpy(np.ascontiguousarray(nodes_mat)).to(dev)
        self.tris = torch.from_numpy(np.ascontiguousarray(tris_mat)).to(dev)
        self.stack_depth = int(stack_depth)
        self.limit = limit
        self.ray_chunk = int(ray_chunk)
        self.sort_rays = bool(sort_rays)
        lo = np.asarray(nodes_mat[0, 0:3], np.float32)
        hi = np.asarray(nodes_mat[0, 3:6], np.float32)
        self.world_lo = torch.from_numpy(lo).to(dev)
        self.world_inv_extent = torch.from_numpy(
            (1.0 / np.maximum(hi - lo, 1e-12)).astype(np.float32)).to(dev)

    def run(self, o, d, t_max, any_hit: bool):
        """One walk of these rays, unsorted: (t, id) as :func:`walk`."""
        return walk(self.nodes, self.tris, o, d, t_max, any_hit=any_hit,
                    limit=self.limit, stack_depth=self.stack_depth)

    @spanned("intersect")
    def intersect(self, o, d, t_max, any_hit: bool):
        """Rays o, d [N, 3], t_max [N] -> (hit [N], t [N], tri [N] i32)."""
        t, i = sorted_chunks(o, d, t_max, self.world_lo,
                             self.world_inv_extent, self.ray_chunk,
                             lambda *r: self.run(*r, any_hit),
                             self.sort_rays)
        hit = i >= 0
        return hit, t, i.clamp_min(0)


class WBVHAccelerator(TreeWalk):
    """The wavefront BVH accelerator: the "wbvh" limit, rays walked
    ``ray_chunk`` a launch in the order they come. ``sort_rays`` sorts
    them first; it is off by default because on an H100 the sort and its
    gathers cost more device time than they save the walk on every call
    of the 1M Whitted frame and SPPM iteration (PERF.md §5).
    ``max_leaf`` is the build's leaf size (informational: every leaf is
    scanned whole)."""

    def __init__(self, nodes_mat: np.ndarray, tris_mat: np.ndarray,
                 max_leaf: int, device, stack_depth: int = 48,
                 ray_chunk: int = RAY_CHUNK, sort_rays: bool = False):
        super().__init__(nodes_mat, tris_mat, device, stack_depth, "wbvh",
                         ray_chunk, sort_rays)
        self.max_leaf = int(max_leaf)


def attach(scene, max_prims_per_leaf: int = 4, stack_depth: int = 48,
           ray_chunk: int = RAY_CHUNK):
    """Build the wavefront-BVH accelerator for the scene's triangles and
    install it; the stack is raised to the tree's depth + 2 where that is
    more than ``stack_depth``."""
    if scene.n_triangles == 0:
        return scene
    tris = tri_mod.to_numpy(scene.triangles)
    bvh = build_bvh(tri_mod.world_bounds_np(tris), max_prims_per_leaf)
    nodes_mat = pack_nodes(bvh)
    tris_mat = pack_leaf_tris(tris, np.asarray(bvh.prim_order, np.int64))
    stack_depth = max(stack_depth, tree_depth(bvh) + 2)
    scene.accel = WBVHAccelerator(nodes_mat, tris_mat, max_prims_per_leaf,
                                  scene.device, stack_depth, ray_chunk)
    return scene
