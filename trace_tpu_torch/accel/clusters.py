"""Cluster cut of the SAH tree, and the slab/sort helpers of the sweep
(port of the build half of trace_tpu/accel/clusters.py).

The SAH tree is cut into clusters of at most ``leaf_tris`` triangles in
depth-first order; each cluster row carries its triangles'
Moller-Trumbore constants. The build runs on the host (native C++,
accel/native.py) and is bit-equal to the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..shapes import triangle as tri_mod
from . import native


class ClusterAccel(NamedTuple):
    """Host numpy (the SAH build), or device tensors (accel/morton.py)."""
    c_lo: np.ndarray       # [C, 3] cluster AABBs
    c_hi: np.ndarray
    packed_mt: np.ndarray  # [C, 16L->%128] MT constants n|e1|e2|w|q|v0n
    tri_id: np.ndarray     # [C, L->%128] int32 global id; -1 = padding
    leaf_tris: int


def build_clusters(tris: tri_mod.Triangles, leaf_tris: int = 32,
                   max_prims_per_leaf: int = 4) -> ClusterAccel:
    """Build the SAH tree, then cut it at subtrees of <= leaf_tris prims."""
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
    packed_mt = native.cluster_pack(tris.v0, tris.v1, tris.v2, tri_id,
                                    leaf_tris)[0]
    tri_id = np.pad(tri_id, ((0, 0), (0, (-leaf_tris) % 128)),
                    constant_values=-1)
    return ClusterAccel(np.ascontiguousarray(c_lo),
                        np.ascontiguousarray(c_hi), packed_mt, tri_id,
                        int(leaf_tris))


def refit_clusters(accel: ClusterAccel, v0, v1, v2) -> ClusterAccel:
    """The clusters' bounds and constants for moved vertices (host numpy
    [T, 3]) with the same topology, on the host as in the JAX package:
    the constants through the build's double-precision route, the boxes
    as the clusters' vertex AABBs, so a refit equals a static build of the
    same clusters bit for bit."""
    packed_mt, lo, hi = native.cluster_pack(v0, v1, v2, accel.tri_id,
                                            accel.leaf_tris)
    return accel._replace(c_lo=lo, c_hi=hi, packed_mt=packed_mt)


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
