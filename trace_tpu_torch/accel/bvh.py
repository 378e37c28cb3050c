"""Bounding-volume hierarchy: the host SAH build and refit, and the BVH
accelerator (port of trace_tpu/accel/bvh.py).

The build is the reference's 12-bucket SAH recursion over primitive AABBs
in the flattened depth-first layout (first child at i + 1, the second at
``right_child``). ``native=True`` runs the port's C++ builder
(accel/native.py, csrc/bvh_builder.cpp) and raises if it cannot be built;
``native=False`` runs the numpy builder, line for line the JAX package's
test oracle. Both give the same tree.

``BVHAccelerator`` walks the tree per ray through the walk kernel's "bvh"
limit (ops/bvh_walk.py on the card, accel/wbvh.py::walk_plain on the
CPU): the leaf test runs with t_max = inf and a hit is kept when it is
nearer than the best and within t_max, as the JAX package's
``_traverse_one``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..shapes import triangle as tri_mod
from . import native as native_mod

STACK_DEPTH = 64
N_BUCKETS = 12


class LinearBVH(NamedTuple):
    """The flattened tree, host numpy, with the JAX package's fields."""
    lo: np.ndarray           # [M, 3]
    hi: np.ndarray           # [M, 3]
    right_child: np.ndarray  # [M] int32 (second child; first = i + 1)
    prim_start: np.ndarray   # [M] int32 offset into prim_order
    n_prims: np.ndarray      # [M] int32 (0: interior)
    axis: np.ndarray         # [M] int32 split axis
    prim_order: np.ndarray   # [T] int32 leaf-ordered primitive ids


def build_bvh(bounds: np.ndarray, max_prims_per_leaf: int = 4,
              native: bool = True) -> LinearBVH:
    """SAH build over primitive AABBs [T, 2, 3]: the C++ builder, or with
    ``native=False`` the numpy one."""
    if native and bounds.shape[0] > 0:
        return LinearBVH(**native_mod.build_bvh(bounds, max_prims_per_leaf))
    return _build_bvh_numpy(bounds, max_prims_per_leaf)


def _build_bvh_numpy(bounds: np.ndarray,
                     max_prims_per_leaf: int = 4) -> LinearBVH:
    t_count = bounds.shape[0]
    lo_all = bounds[:, 0]
    hi_all = bounds[:, 1]
    centroids = 0.5 * (lo_all + hi_all)

    # Node arrays, grown geometrically.
    cap = max(2 * t_count, 16)
    n_lo = np.zeros((cap, 3), np.float32)
    n_hi = np.zeros((cap, 3), np.float32)
    n_right = np.full(cap, -1, np.int32)
    n_start = np.zeros(cap, np.int32)
    n_count = np.zeros(cap, np.int32)
    n_axis = np.zeros(cap, np.int32)
    order = np.arange(t_count, dtype=np.int32)
    n_nodes = 0

    def alloc():
        nonlocal n_nodes, cap, n_lo, n_hi, n_right, n_start, n_count, n_axis
        if n_nodes >= cap:
            cap *= 2
            n_lo = np.resize(n_lo, (cap, 3))
            n_hi = np.resize(n_hi, (cap, 3))
            n_right = np.resize(n_right, cap)
            n_start = np.resize(n_start, cap)
            n_count = np.resize(n_count, cap)
            n_axis = np.resize(n_axis, cap)
        i = n_nodes
        n_nodes += 1
        return i

    # Work stack of (range_start, range_end, parent_slot, is_second_child):
    # depth-first, the first child right after its parent.
    stack = [(0, t_count, -1, False)]
    while stack:
        start, end, parent, is_second = stack.pop()
        node = alloc()
        if parent >= 0 and is_second:
            n_right[parent] = node
        ids = order[start:end]
        blo = lo_all[ids].min(0)
        bhi = hi_all[ids].max(0)
        n_lo[node] = blo
        n_hi[node] = bhi
        count = end - start

        def make_leaf():
            n_start[node] = start
            n_count[node] = count

        if count <= 1:
            make_leaf()
            continue

        cent = centroids[ids]
        c_lo, c_hi = cent.min(0), cent.max(0)
        diag = c_hi - c_lo
        axis = int(np.argmax(diag))
        n_axis[node] = axis
        if diag[axis] < 1e-12:
            # Coincident centroids: one leaf of every primitive, however
            # many (the walk scans them all).
            make_leaf()
            continue

        if count <= 2:
            key = np.argsort(cent[:, axis], kind="stable")
            order[start:end] = ids[key]
            mid = start + count // 2
        else:
            rel = (cent[:, axis] - c_lo[axis]) / diag[axis]
            b = np.minimum((rel * N_BUCKETS).astype(np.int32), N_BUCKETS - 1)
            costs = np.full(N_BUCKETS - 1, np.inf, np.float64)
            for split in range(N_BUCKETS - 1):
                left = b <= split
                nl = int(left.sum())
                nr = count - nl
                if nl == 0 or nr == 0:
                    continue
                llo = lo_all[ids[left]].min(0)
                lhi = hi_all[ids[left]].max(0)
                rlo = lo_all[ids[~left]].min(0)
                rhi = hi_all[ids[~left]].max(0)
                sa = lambda l, h: 2.0 * (
                    (h - l)[0] * (h - l)[1] + (h - l)[1] * (h - l)[2]
                    + (h - l)[0] * (h - l)[2]
                )
                total_sa = max(sa(blo, bhi), 1e-20)
                costs[split] = 1.0 + (nl * sa(llo, lhi)
                                      + nr * sa(rlo, rhi)) / total_sa
            best = int(np.argmin(costs))
            leaf_cost = float(count)
            if count <= max_prims_per_leaf and costs[best] >= leaf_cost:
                make_leaf()
                continue
            left_mask = b <= best
            if not left_mask.any() or left_mask.all():
                make_leaf()
                continue
            order[start:end] = np.concatenate([ids[left_mask],
                                               ids[~left_mask]])
            mid = start + int(left_mask.sum())

        # The second child first, so the first child is built next.
        stack.append((mid, end, node, True))
        stack.append((start, mid, node, False))

    return LinearBVH(
        n_lo[:n_nodes], n_hi[:n_nodes],
        n_right[:n_nodes], n_start[:n_nodes],
        n_count[:n_nodes], n_axis[:n_nodes],
        order,
    )


def refit_bvh(bvh: LinearBVH, bounds: np.ndarray,
              native: bool = True) -> LinearBVH:
    """Node bounds refreshed for moved primitives (AABBs [T, 2, 3]) with
    the same topology: one bottom-up sweep (children have larger indices
    than their parents); the C++ refit, or with ``native=False`` numpy."""
    if native:
        out = native_mod.refit_bvh(bvh._asdict(), bounds)
        return bvh._replace(lo=out["lo"], hi=out["hi"])
    lo = np.array(bvh.lo, np.float32)
    hi = np.array(bvh.hi, np.float32)
    right, start, count, order = (np.asarray(a) for a in (
        bvh.right_child, bvh.prim_start, bvh.n_prims, bvh.prim_order))
    b = np.ascontiguousarray(bounds, np.float32)
    for node in range(lo.shape[0] - 1, -1, -1):
        if count[node] > 0:
            ids = order[start[node]:start[node] + count[node]]
            lo[node] = b[ids, 0].min(0)
            hi[node] = b[ids, 1].max(0)
        else:
            c0, c1 = node + 1, right[node]
            lo[node] = np.minimum(lo[c0], lo[c1])
            hi[node] = np.maximum(hi[c0], hi[c1])
    return bvh._replace(lo=lo, hi=hi)


class BVHAccelerator:
    """Triangle closest-hit / any-hit by a per-ray walk of ``bvh`` with the
    "bvh" limit (the interface of ops/sweep.py::SweepAccelerator), over
    the triangles ``tris`` the tree was built from. ``stack_depth``: the
    walk's stack; ValueError when it is below the tree's depth + 2 or
    above the kernel's STACK_CAP (64)."""

    def __init__(self, bvh: LinearBVH, tris, max_leaf: int, device,
                 stack_depth: int = STACK_DEPTH):
        from . import wbvh

        self.bvh = bvh
        self.max_leaf = int(max_leaf)
        self.walk = wbvh.TreeWalk(
            wbvh.pack_nodes(bvh),
            wbvh.pack_leaf_tris(tri_mod.to_numpy(tris),
                                np.asarray(bvh.prim_order, np.int64)),
            device, stack_depth, limit="bvh")

    def intersect(self, o, d, t_max, any_hit: bool):
        """Rays o, d [N, 3], t_max [N] -> (hit [N], t [N], tri [N] i32)."""
        return self.walk.intersect(o, d, t_max, any_hit)


def attach(scene, max_prims_per_leaf: int = 4):
    """Build a triangle BVH for the scene and install it."""
    if scene.n_triangles == 0:
        return scene
    tris = tri_mod.to_numpy(scene.triangles)
    bvh = build_bvh(tri_mod.world_bounds_np(tris), max_prims_per_leaf)
    scene.accel = BVHAccelerator(bvh, tris, max_prims_per_leaf, scene.device)
    return scene
