"""Brute-force fused ray/triangle intersection (port of
trace_tpu/ops/intersect_pallas.py).

Every ray is tested against every triangle with the matmul-factored
Moller-Trumbore test, keeping a running per-ray (t, id) minimum. The
kernel is ``csrc/intersect.cu`` on CUDA tensors and
:func:`intersect_plain` on CPU tensors; ``intersect`` picks by device
and never falls back from one to the other.

Layouts: the JAX package packs rays as A [N, 16] (o | d | o x d | 1) and
triangles as B [16, NT*640], five column groups per 128-triangle block
(det | u | v | t | id, signs folded in) for one MXU product per block.
The port keeps the same constants per triangle, unsigned and compact:
``pack_tris`` gives a panel [NT, 16, 128] (rows n, e1, e2, w, q, v0.n,
the sweep panel's rows) and int32 ids [NT*128]; ``pack_rays`` gives the
sweep's ray rows [10, Np] (o, d, o x d, t_max). ``tris_from_b`` reads
the JAX package's B into the port's layout.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..accel.mxu import mt_epilogue
from .nvcc import CudaLibrary, check_tensors

F32 = torch.float32
INF = float("inf")
RAY_BLOCK = 128     # rays per CTA, 2 a thread (the TPU kernel: 1024)
TRI_BLOCK = 128     # triangles per staged block, as in the TPU kernel
GROUPS = 5          # the JAX B layout: det, u, v, t, id


def pack_tris(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    """Triangles [T, 3] x 3 -> (panel f32 [NT, 16, 128], ids i32 [NT*128]).
    Constants are computed in f64 and rounded once, as the JAX packer
    does; padding slots are zero with id -1."""
    t = v0.shape[0]
    pad = (-t) % TRI_BLOCK

    def padv(x):
        return np.pad(np.asarray(x, np.float64), ((0, pad), (0, 0)))

    v0p, v1p, v2p = padv(v0), padv(v1), padv(v2)
    e1 = v1p - v0p
    e2 = v2p - v0p
    nrm = np.cross(e1, e2)
    w = np.cross(e2, v0p)
    q = np.cross(v0p, e1)
    v0n = np.einsum("ij,ij->i", v0p, nrm)
    rows = np.concatenate([nrm, e1, e2, w, q, v0n[:, None]], 1)  # [Tp, 16]
    nt = (t + pad) // TRI_BLOCK
    panel = rows.reshape(nt, TRI_BLOCK, 16).transpose(0, 2, 1)
    return (np.ascontiguousarray(panel, np.float32),
            np.pad(np.arange(t, dtype=np.int32), (0, pad),
                   constant_values=-1))


def tris_from_b(b: np.ndarray):
    """The JAX package's pack_tris B [16, NT*640] -> (panel, ids) as
    :func:`pack_tris` gives them (negations are exact)."""
    b = np.asarray(b, np.float32)
    nt = b.shape[1] // (GROUPS * TRI_BLOCK)
    g = b.reshape(16, nt, GROUPS, TRI_BLOCK)
    rows = np.concatenate([
        g[0:3, :, 3],            # n
        -g[6:9, :, 2],           # e1
        g[6:9, :, 1],            # e2
        -g[3:6, :, 1],           # w
        -g[3:6, :, 2],           # q
        -g[9:10, :, 3],          # v0.n
    ], 0)                        # [16, NT, 128]
    panel = np.ascontiguousarray(rows.transpose(1, 0, 2))
    return panel, g[9, :, 4].reshape(-1).astype(np.int32)


def pack_rays(o: torch.Tensor, d: torch.Tensor, t_max: torch.Tensor):
    """o, d [N, 3], t_max [N] -> (rays f32 [10, Np], n_pad), Np a multiple
    of RAY_BLOCK. Padding lanes are zero with t_max 0, so they never hit."""
    n = o.shape[0]
    pad = (-n) % RAY_BLOCK
    o = torch.cat([o, o.new_zeros((pad, 3))])
    d = torch.cat([d, d.new_zeros((pad, 3))])
    t_max = torch.cat([t_max, t_max.new_zeros((pad,))])
    m = torch.stack([o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1],
                     o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
                     o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0]], 1)
    return torch.cat([o.T, d.T, m.T, t_max[None]], 0).contiguous(), pad


def _dot3(a0, a1, a2, p, r):
    """(a0 * p[r] + a1 * p[r+1]) + a2 * p[r+2], the kernel's order."""
    return a0 * p[None, r] + a1 * p[None, r + 1] + a2 * p[None, r + 2]


def intersect_plain(rays: torch.Tensor, tris: torch.Tensor,
                    ids: torch.Tensor, tri_chunk: int = 8):
    """Plain PyTorch version of the fused kernel.

    rays f32 [10, N]; tris f32 [NT, 16, 128]; ids i32 [NT*128] ->
    (best_t f32 [N], +inf on a miss; best_id i32 [N], -1 on a miss).
    Works through ``tri_chunk`` triangle blocks at a time ([N, chunk*128]
    temporaries). Same rules as the kernel: strict t < t_max, id < 0 never
    hits, the lowest id among equal t within a block, and across blocks
    the earlier block wins a tie."""
    n = rays.shape[1]
    nt = tris.shape[0]
    dev = rays.device
    o0, o1, o2, d0, d1, d2, m0, m1, m2, t_max = (rays[i, :, None]
                                                 for i in range(10))
    best_t = torch.full((n,), INF, dtype=F32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    big = torch.iinfo(torch.int32).max
    for c in range(0, nt, tri_chunk):
        blk = tris[c:c + tri_chunk]
        k = blk.shape[0]
        p = blk.permute(1, 0, 2).reshape(16, k * TRI_BLOCK)
        idc = ids[c * TRI_BLOCK:(c + k) * TRI_BLOCK]
        det = -_dot3(d0, d1, d2, p, 0)
        u_det = _dot3(m0, m1, m2, p, 6) - _dot3(d0, d1, d2, p, 9)
        v_det = -_dot3(m0, m1, m2, p, 3) - _dot3(d0, d1, d2, p, 12)
        t_det = _dot3(o0, o1, o2, p, 0) - p[None, 15]
        ok, t = mt_epilogue(det, u_det, v_det, t_det)
        t = torch.where(ok & (t < t_max) & (idc >= 0), t, INF)
        t = t.reshape(n, k, TRI_BLOCK)
        bmin = t.amin(dim=2)                                  # [N, k]
        bid = torch.where(t == bmin[..., None], idc.reshape(k, TRI_BLOCK),
                          big).amin(dim=2)
        gmin = bmin.amin(dim=1)
        first = (bmin == gmin[:, None]).to(torch.uint8).argmax(dim=1)
        better = gmin < best_t
        best_t = torch.where(better, gmin, best_t)
        best_i = torch.where(better, bid.gather(1, first[:, None])[:, 0],
                             best_i)
    return best_t, best_i


class IntersectKernel:
    """ctypes binding of csrc/intersect.cu (ops/nvcc.py), built at the
    first launch. ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self.lib = CudaLibrary("intersect", "intersect_launch",
                               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                               + [ctypes.c_void_p])

    def reset_counts(self) -> None:
        self.launches = 0

    def __call__(self, rays, tris, ids):
        """Same contract as :func:`intersect_plain`, on CUDA tensors; N
        must be a multiple of RAY_BLOCK."""
        n = rays.shape[1]
        nt = tris.shape[0]
        dev = rays.device
        check_tensors("intersect kernel", dev, (
            (rays, F32, (10, n)), (tris, F32, (nt, 16, TRI_BLOCK)),
            (ids, torch.int32, (nt * TRI_BLOCK,))))
        if dev.type != "cuda" or n % RAY_BLOCK or any(
                t.data_ptr() % 16 for t in (tris, ids)):
            raise ValueError(f"intersect kernel: CUDA tensors, N a multiple "
                             f"of {RAY_BLOCK}, tris and ids 16-byte aligned")
        launch = self.lib.load()
        best_t = torch.empty(n, dtype=F32, device=dev)
        best_i = torch.empty(n, dtype=torch.int32, device=dev)
        if n == 0:
            return best_t, best_i
        err = launch(rays.data_ptr(), tris.data_ptr(), ids.data_ptr(),
                     best_t.data_ptr(), best_i.data_ptr(), n // RAY_BLOCK,
                     RAY_BLOCK, nt, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(
                f"intersect kernel launch failed: CUDA error {err}")
        self.launches += 1
        return best_t, best_i


intersect_kernel = IntersectKernel()


def intersect(rays, tris, ids):
    """The fused intersection: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if rays.device.type == "cuda":
        return intersect_kernel(rays, tris, ids)
    if rays.device.type == "cpu":
        return intersect_plain(rays, tris, ids)
    raise ValueError(f"intersect: unsupported device {rays.device}")


class IntersectAccelerator:
    """Triangle closest-hit / any-hit by brute force through the fused
    kernel (the interface of ops/sweep.py::SweepAccelerator). Any-hit
    runs the closest-hit test, as in the JAX package."""

    def __init__(self, panel: np.ndarray, ids: np.ndarray, device):
        dev = torch.device(device)
        self.tris = torch.from_numpy(np.ascontiguousarray(panel)).to(dev)
        self.ids = torch.from_numpy(np.ascontiguousarray(ids)).to(dev)

    def intersect(self, o, d, t_max, any_hit: bool):
        """Rays o, d [N, 3], t_max [N] -> (hit [N], t [N], tri [N] i32)."""
        n = o.shape[0]
        rays, _ = pack_rays(o, d, t_max)
        bt, bi = intersect(rays, self.tris, self.ids)
        bt, bi = bt[:n], bi[:n]
        hit = bi >= 0   # a hit has t < t_max, so it is finite
        return hit, bt, bi.clamp_min(0)


def attach(scene, b: np.ndarray | None = None):
    """Install the fused brute-force accelerator on ``scene`` (from the
    JAX package's B when given). The scene keeps its other tables."""
    if scene.n_triangles == 0:
        return scene
    if b is None:
        tr = scene.triangles
        panel, ids = pack_tris(tr.v0, tr.v1, tr.v2)
    else:
        panel, ids = tris_from_b(b)
    scene.accel = IntersectAccelerator(panel, ids, scene.device)
    return scene
