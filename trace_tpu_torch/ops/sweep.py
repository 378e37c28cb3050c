"""Per-ray-block sparse sweep: the hot-path traversal (port of
trace_tpu/ops/sweep_pallas.py).

Each block of ``block_rays`` rays walks its own demand-ordered list of
super-clusters (G clusters x L triangles each) and tests every triangle
of every super it visits with the matmul-factored Moller-Trumbore test;
it stops once the suffix-min of the remaining entry distances passes
every live lane's limit. The sweep itself is ``csrc/sweep.cu`` on CUDA
tensors and :func:`sweep_plain` on CPU tensors; ``sweep`` picks by device
and never falls back from one to the other. The prologue (entry
distances, per-block order and suffix) and the ray sort stay PyTorch.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np
import torch

from ..accel.clusters import ClusterAccel, entry_boxes, sort_key

F32 = torch.float32
INF = float("inf")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "sweep.cu")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libsweep.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]


class SweepTables:
    """Kernel tables from a ClusterAccel (host numpy, bit-equal to the
    JAX package's SweepTables with an f32 panel).

    ``panel`` [S, 16, GLP]: row k is MT component k across the super's G
    clusters (GLP = G*L padded to 128). ``slot_to_tri`` [S*GLP] maps a
    local slot s*GLP + k to the global triangle id (-1 = padding; padding
    slots carry zero constants, so det = 0 and they never hit).
    ``s_lo``/``s_hi`` [S, 3] are the super AABBs."""

    def __init__(self, accel: ClusterAccel, group: int = 8):
        l = accel.leaf_tris
        c = accel.tri_id.shape[0]
        g = int(group)
        pad_c = (-c) % g
        mt = accel.packed_mt[:, :16 * l]
        tid = accel.tri_id[:, :l]
        c_lo, c_hi = accel.c_lo, accel.c_hi
        if pad_c:
            mt = np.pad(mt, ((0, pad_c), (0, 0)))
            tid = np.pad(tid, ((0, pad_c), (0, 0)), constant_values=-1)
            c_lo = np.concatenate([c_lo, np.repeat(c_lo[-1:], pad_c, 0)])
            c_hi = np.concatenate([c_hi, np.repeat(c_hi[-1:], pad_c, 0)])
        s = (c + pad_c) // g
        gl = g * l
        self.gl_pad = -(-gl // 128) * 128
        panel = mt.reshape(s, g, 16, l).transpose(0, 2, 1, 3).reshape(s, 16, gl)
        self.panel = np.asarray(
            np.pad(panel, ((0, 0), (0, 0), (0, self.gl_pad - gl))), np.float32)
        slot = np.full((s, self.gl_pad), -1, np.int32)
        slot[:, :gl] = tid.reshape(s, gl)
        self.slot_to_tri = np.ascontiguousarray(slot.reshape(-1))
        self.s_lo = np.ascontiguousarray(c_lo.reshape(s, g, 3).min(axis=1))
        self.s_hi = np.ascontiguousarray(c_hi.reshape(s, g, 3).max(axis=1))
        self.n_supers = s
        self.group = g
        self.leaf_tris = l

    @classmethod
    def from_arrays(cls, panel, slot_to_tri, s_lo, s_hi) -> "SweepTables":
        """Wrap tables packed elsewhere (group/leaf sizes are not kept)."""
        tb = object.__new__(cls)
        tb.panel = np.ascontiguousarray(panel, np.float32)
        tb.slot_to_tri = np.ascontiguousarray(slot_to_tri, np.int32)
        tb.s_lo = np.ascontiguousarray(s_lo, np.float32)
        tb.s_hi = np.ascontiguousarray(s_hi, np.float32)
        tb.n_supers = tb.panel.shape[0]
        tb.gl_pad = tb.panel.shape[2]
        tb.group = tb.leaf_tris = None
        return tb


# ---------------------------------------------------------------------------
# The sweep: plain PyTorch version and CUDA kernel, same signature.
# ---------------------------------------------------------------------------


def _dot3(a0, a1, a2, p, r):
    """(a0 * p[r] + a1 * p[r+1]) + a2 * p[r+2], the kernel's order."""
    return a0 * p[:, None, r] + a1 * p[:, None, r + 1] + a2 * p[:, None, r + 2]


def sweep_plain(rays: torch.Tensor, order: torch.Tensor,
                suffix: torch.Tensor, panel: torch.Tensor, block_rays: int,
                any_hit: bool):
    """Plain PyTorch version of the sweep kernel.

    rays f32 [10, NB*B] (o, d, m = o x d, t_lim); order i32 [NB, S];
    suffix f32 [NB, S]; panel f32 [S, 16, GL] ->
    (best_t f32 [NB*B], +inf where nothing was found;
     best_i i32 [NB*B], local slot s*GL + k, -1 where nothing).

    Vectorised over blocks with a Python loop over steps; a block stops
    at the first step where no lane can improve, as in the kernel. Same
    tie rule: within a super the lowest slot among equal t, across
    supers strict '<' (the earlier-visited super wins)."""
    nb, n_supers = order.shape
    b = int(block_rays)
    gl = panel.shape[2]
    dev = rays.device
    r = rays.reshape(10, nb, b)
    t_lim = r[9]
    best_t = torch.full((nb, b), INF, dtype=F32, device=dev)
    best_i = torch.full((nb, b), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    cols = torch.arange(gl, dtype=torch.int32, device=dev)
    big = torch.iinfo(torch.int32).max
    for s in range(n_supers):
        if any_hit:
            lane_limit = torch.where(best_t <= t_lim, -INF, t_lim)
        else:
            lane_limit = torch.minimum(best_t, t_lim)
        done |= ~(suffix[:, s] < lane_limit.amax(dim=1))
        blocks = (~done).nonzero().squeeze(1)
        if blocks.numel() == 0:
            break
        sid = order[blocks, s].long()
        p = panel[sid]                                   # [A, 16, GL]
        ra = r[:, blocks, :, None]                       # [10, A, B, 1]
        o0, o1, o2, d0, d1, d2, m0, m1, m2 = (ra[i] for i in range(9))
        det = -_dot3(d0, d1, d2, p, 0)
        u_det = _dot3(m0, m1, m2, p, 6) - _dot3(d0, d1, d2, p, 9)
        v_det = -_dot3(m0, m1, m2, p, 3) - _dot3(d0, d1, d2, p, 12)
        t_det = _dot3(o0, o1, o2, p, 0) - p[:, None, 15]
        sign = torch.where(det < 0.0, -1.0, 1.0)
        adet = det * sign
        u = u_det * sign
        v = v_det * sign
        tn = t_det * sign
        live = adet > 1e-12
        t = tn / torch.where(live, adet, 1.0)
        bt = best_t[blocks]
        limit = torch.minimum(bt, t_lim[blocks])[..., None]
        ok = (live & (u >= 0.0) & (v >= 0.0) & (u + v <= adet) & (tn > 0.0)
              & (t < limit))
        t = torch.where(ok, t, INF)
        tmin = t.amin(dim=2)
        kmin = torch.where(t <= tmin[..., None], cols, big).amin(dim=2)
        better = tmin < bt
        best_t[blocks] = torch.where(better, tmin, bt)
        best_i[blocks] = torch.where(
            better, sid[:, None].to(torch.int32) * gl + kmin, best_i[blocks])
    return best_t.reshape(-1), best_i.reshape(-1)


class SweepKernel:
    """ctypes binding of csrc/sweep.cu, built with nvcc for sm_90a into
    ``build/`` at the first launch. ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._lock = threading.Lock()

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._lib = ctypes.CDLL(self._build())
                fn = self._lib.sweep_launch
                fn.restype = ctypes.c_int
                fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                               + [ctypes.c_void_p])
            return self._lib

    @staticmethod
    def _build() -> str:
        if (os.path.exists(LIB_PATH)
                and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)):
            return LIB_PATH
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                           check=True, capture_output=True, text=True,
                           timeout=600)
            os.replace(tmp, LIB_PATH)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return LIB_PATH

    def __call__(self, rays, order, suffix, panel, block_rays: int,
                 any_hit: bool):
        """Same contract as :func:`sweep_plain`, on CUDA tensors."""
        nb, n_supers = order.shape
        gl = panel.shape[2]
        b = int(block_rays)
        dev = rays.device
        checks = (
            (rays, F32, (10, nb * b)), (order, torch.int32, (nb, n_supers)),
            (suffix, F32, (nb, n_supers)), (panel, F32, (n_supers, 16, gl)),
        )
        for t, dtype, shape in checks:
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                    or not t.is_contiguous():
                raise ValueError(
                    f"sweep kernel: want {dtype} {shape} contiguous on {dev}, "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if dev.type != "cuda" or not 32 <= b <= 1024 or b % 32 or gl % 4:
            raise ValueError("sweep kernel: CUDA tensors, 32 <= block_rays "
                             "<= 1024 (a multiple of 32), GL % 4 == 0")
        lib = self.load()
        best_t = torch.empty(nb * b, dtype=F32, device=dev)
        best_i = torch.empty(nb * b, dtype=torch.int32, device=dev)
        if nb == 0:
            return best_t, best_i
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sweep_launch(
            rays.data_ptr(), order.data_ptr(), suffix.data_ptr(),
            panel.data_ptr(), best_t.data_ptr(), best_i.data_ptr(),
            nb, b, n_supers, gl, int(bool(any_hit)), stream)
        if err != 0:
            raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
        self.launches += 1
        return best_t, best_i


sweep_kernel = SweepKernel()


def sweep(rays, order, suffix, panel, block_rays: int, any_hit: bool):
    """The sweep: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if rays.device.type == "cuda":
        return sweep_kernel(rays, order, suffix, panel, block_rays, any_hit)
    if rays.device.type == "cpu":
        return sweep_plain(rays, order, suffix, panel, block_rays, any_hit)
    raise ValueError(f"sweep: unsupported device {rays.device}")


# ---------------------------------------------------------------------------
# The accelerator around it
# ---------------------------------------------------------------------------


class SweepAccelerator:
    """Triangle closest-hit / any-hit through the sweep. Tables are device
    tensors built once per scene.

    ``block_rays``: rays per kernel block (one CTA). ``ray_chunk``: rays
    per launch; the [chunk, S] entry table bounds its memory."""

    def __init__(self, tables: SweepTables, device, block_rays: int = 32,
                 ray_chunk: int = 65536):
        dev = torch.device(device)
        self.tables = tables
        self.block_rays = int(block_rays)
        self.ray_chunk = int(ray_chunk)
        self.panel = torch.from_numpy(tables.panel).to(dev)
        self.slot_to_tri = torch.from_numpy(
            tables.slot_to_tri.astype(np.int64)).to(dev)
        self.s_lo = torch.from_numpy(tables.s_lo).to(dev)
        self.s_hi = torch.from_numpy(tables.s_hi).to(dev)
        lo = tables.s_lo.min(axis=0)
        hi = tables.s_hi.max(axis=0)
        self.world_lo = torch.from_numpy(lo).to(dev)
        self.world_inv_extent = torch.from_numpy(
            (1.0 / np.maximum(hi - lo, 1e-12)).astype(np.float32)).to(dev)

    def prologue(self, o, d, t_max):
        """One chunk's kernel inputs: (rays [10, NB*B], order i32 [NB, S],
        suffix [NB, S]). Padding lanes are dead (t_lim = -1); t_max = inf
        becomes 3e38."""
        b = self.block_rays
        n = o.shape[0]
        pad = (-n) % b
        nb = (n + pad) // b
        dev = o.device
        o_p = torch.cat([o, o.new_zeros((pad, 3))])
        d_p = torch.cat([d, d.new_zeros((pad, 3))])
        t_p = torch.cat([torch.where(torch.isfinite(t_max), t_max, 3e38),
                         torch.full((pad,), -1.0, dtype=F32, device=dev)])
        # Per-block demand order + suffix-min over super entry distances.
        entry = entry_boxes(self.s_lo, self.s_hi, o_p, d_p, t_p.clamp_min(0.0))
        entry = torch.where(t_p[:, None] < 0.0, INF, entry)
        entry_b = entry.reshape(nb, b, self.tables.n_supers).amin(dim=1)
        del entry
        order = torch.argsort(entry_b, dim=1, stable=True)
        entry_o = torch.gather(entry_b, 1, order)
        suffix = torch.flip(torch.cummin(torch.flip(entry_o, [1]), 1).values,
                            [1]).contiguous()
        m = torch.stack([o_p[:, 1] * d_p[:, 2] - o_p[:, 2] * d_p[:, 1],
                         o_p[:, 2] * d_p[:, 0] - o_p[:, 0] * d_p[:, 2],
                         o_p[:, 0] * d_p[:, 1] - o_p[:, 1] * d_p[:, 0]], 1)
        rays = torch.cat([o_p.T, d_p.T, m.T, t_p[None]], 0).contiguous()
        return rays, order.to(torch.int32).contiguous(), suffix

    def _traverse_chunk(self, o, d, t_max, any_hit: bool):
        n = o.shape[0]
        rays, order, suffix = self.prologue(o, d, t_max)
        bt, bi = sweep(rays, order, suffix, self.panel, self.block_rays,
                       any_hit)
        bt, bi = bt[:n], bi[:n]
        found = bi >= 0
        tri = self.slot_to_tri[torch.where(found, bi, 0).long()]
        hit = found & (tri >= 0) & (bt <= t_max)
        return (hit, torch.where(hit, bt, INF),
                tri.clamp_min(0).to(torch.int32))

    def coherence_order(self, o, d, t_max) -> torch.Tensor:
        """Stable ray permutation by sort_key, dead lanes (t_max < 0)
        last."""
        key = sort_key(o, d, self.world_lo, self.world_inv_extent)
        return torch.argsort(key | ((t_max < 0).long() << 24), stable=True)

    def intersect(self, o, d, t_max, any_hit: bool):
        """Rays o, d [N, 3], t_max [N] -> (hit [N], t [N], tri [N] i32).

        Rays are coherence-sorted first (direction octant, then Morton
        order of the origin) so each block enters few supers; lanes with
        t_max < 0 are dead and sort last, so their blocks exit at once."""
        n = o.shape[0]
        perm = self.coherence_order(o, d, t_max)
        o, d, t_max = o[perm], d[perm], t_max[perm]
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n, device=perm.device)
        outs = [self._traverse_chunk(o[s:s + self.ray_chunk],
                                     d[s:s + self.ray_chunk],
                                     t_max[s:s + self.ray_chunk], any_hit)
                for s in range(0, n, self.ray_chunk)]
        hit, t, idx = (torch.cat(x) for x in zip(*outs))
        return hit[inv], t[inv], idx[inv]
