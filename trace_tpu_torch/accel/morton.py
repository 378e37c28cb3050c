"""Device cluster build: Morton-ordered clusters for animated geometry
(port of trace_tpu/accel/morton.py).

Every frame of an animation moves the mesh, so its clusters are rebuilt
on the device with tensor ops, never on the host:

1. 30-bit Morton codes of the triangle centroids;
2. one stable argsort of the codes;
3. the sorted order cut into blocks of ``leaf_tris`` triangles, one
   cluster each: its AABB and its Moller-Trumbore constants in f32.

The result is a ClusterAccel of device tensors with the layout of the SAH
build (accel/clusters.py). ``ops.sweep.SweepTables`` groups its clusters
into supers on the same device, so the sweep kernel serves animated
frames as it serves static ones. The cut is spatially looser than the SAH
cut; the sweep is exact, so only its cost depends on the cut.

uint32 arithmetic runs in int64: each product is masked with a constant
below 2^32, which keeps exactly the bits a uint32 product keeps.
"""
from __future__ import annotations

import numpy as np
import torch

from .clusters import ClusterAccel

F32 = torch.float32
# The upper clip of the normalised centroid: the f32 value of 1 - 1e-7.
CLIP_HI = float(np.float32(1.0 - 1e-7))
BIG = float(np.float32(3e38))


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v to every third bit."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(p: torch.Tensor, lo: torch.Tensor,
                 inv_extent: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (int64) of points p [N, 3] within
    [lo, lo + extent]."""
    q = ((p - lo) * inv_extent).clamp(0.0, CLIP_HI)
    g = (q * 1024.0).to(torch.int64)
    return ((_expand_bits(g[:, 0]) << 2) | (_expand_bits(g[:, 1]) << 1)
            | _expand_bits(g[:, 2]))


def _cross(a, b):
    """jnp.cross's component order: a1 b2 - a2 b1, a2 b0 - a0 b2,
    a0 b1 - a1 b0."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], -1)


def build_clusters_device(tris, leaf_tris: int = 32) -> ClusterAccel:
    """Clusters of ``leaf_tris`` Morton-consecutive triangles from a
    Triangles of device tensors (shapes/triangle.py::to_device), on their
    device. Padding slots of the last cluster hold zero vertices, so their
    constants are zero (det = 0: never hit)."""
    v0, v1, v2 = tris.v0, tris.v1, tris.v2
    t = v0.shape[0]
    l = int(leaf_tris)
    pad = (-t) % l
    dev = v0.device

    # A divisor held as a tensor on the device: on CUDA, torch turns a
    # division by a host scalar into a multiply by its reciprocal, which
    # rounds otherwise than the division the JAX build (and the CPU) does.
    cent = (v0 + v1 + v2) / v0.new_tensor(3.0)
    lo = cent.amin(0)
    hi = cent.amax(0)
    inv_extent = 1.0 / (hi - lo).clamp_min(1e-12)
    codes = morton_codes(cent, lo, inv_extent)
    order = torch.argsort(codes, stable=True).to(torch.int32)

    order_p = torch.cat([order, order.new_full((pad,), -1)])
    c = (t + pad) // l
    tri_id = order_p.reshape(c, l)
    safe = tri_id.clamp_min(0).long()
    mask = (tri_id >= 0)[..., None]
    b0, b1, b2 = (torch.where(mask, v[safe], 0.0) for v in (v0, v1, v2))

    lo_b = torch.where(mask, torch.minimum(torch.minimum(b0, b1), b2),
                       BIG).amin(1)
    hi_b = torch.where(mask, torch.maximum(torch.maximum(b0, b1), b2),
                       -BIG).amax(1)

    e1 = b1 - b0
    e2 = b2 - b0
    nrm = _cross(e1, e2)
    w = _cross(e2, b0)
    q = _cross(b0, e1)
    # v0 . n as (x x + y y) + z z: the order XLA's CPU reduction of the
    # JAX build's einsum gives (tests/test_torch_morton.py).
    v0n = (b0[..., 0] * nrm[..., 0] + b0[..., 1] * nrm[..., 1]
           + b0[..., 2] * nrm[..., 2])
    seg = 3 * l
    flat = lambda x: x.transpose(1, 2).reshape(c, seg)
    mt_pad = (-16 * l) % 128
    packed_mt = torch.cat([flat(nrm), flat(e1), flat(e2), flat(w), flat(q),
                           v0n, torch.zeros((c, mt_pad), dtype=F32,
                                            device=dev)], 1)
    tri_id_p = torch.cat([tri_id, tri_id.new_full((c, (-l) % 128), -1)], 1)
    return ClusterAccel(lo_b, hi_b, None, None, None, packed_mt, tri_id_p, l,
                        1)


def attach(scene, leaf_tris: int = 32, stage_clusters: int = 64,
           ray_chunk: int = 16384):
    """Install a cluster accelerator over the device Morton build of the
    scene's triangles (accel/clusters.py::ClusterAccelerator, certified
    with the scene's exact_shared_edges) and bump the scene's version."""
    if scene.n_triangles == 0:
        return scene
    from ..shapes import triangle as tri_mod
    from .clusters import ClusterAccelerator

    acc = build_clusters_device(tri_mod.to_device(scene.triangles,
                                                  scene.device), leaf_tris)
    scene.bump_version()
    scene.accel = ClusterAccelerator(acc, scene.device, stage_clusters,
                                     ray_chunk,
                                     certified=bool(scene.exact_edges))
    return scene
