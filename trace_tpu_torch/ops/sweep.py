"""Per-ray-block sparse sweep: the hot-path traversal (port of
trace_tpu/ops/sweep_pallas.py).

Each block of ``block_rays`` rays walks its own demand-ordered list of
super-clusters (G clusters x L triangles each) and tests every triangle
of every super it visits with the matmul-factored Moller-Trumbore test;
it stops once the suffix-min of the remaining entry distances passes
every live lane's limit. The sweep itself is ``csrc/sweep.cu`` on CUDA
tensors and :func:`sweep_plain` on CPU tensors; ``sweep`` picks by device
and never falls back from one to the other. So does the prologue, from a
chunk's rays to each block's demand order and suffix-min
(:func:`prologue`: ``csrc/entry.cu`` or :func:`prologue_plain`); the ray
sort stays PyTorch.

Options, as in the JAX package (all off by default):

- ``certified``: the epilogue is widened by proven error bounds
  (accel/mxu.py::mt_epilogue_certified), so shared mesh edges do not
  leak; the scene's ``exact_shared_edges`` switch sets it.
- ``panel_bf16`` / ``panel_hilo`` (SweepTables): the panel is stored as
  bf16, or as an f32(hi) + f32(lo) pair of bf16 rows; the certified
  bound widens to match (``err_eps``).
- ``collect_stats``: the number of supers each block swept.
- ``pipeline``: the kernel copies the next super's panel while it tests
  the current one (same results, bit for bit).
"""
from __future__ import annotations

import collections
import copy
import ctypes

import numpy as np
import torch

from ..accel.clusters import (ClusterAccel, build_clusters, entry_boxes,
                              refit_clusters, sort_key)
from ..accel.mxu import MT_ERR_EPS, mt_epilogue, mt_epilogue_certified
from ..core.sync import sync_free
from .nvcc import CudaLibrary, check_tensors

F32 = torch.float32
INF = float("inf")

# Certified widening for half-precision panels (the JAX package's
# constants): a bf16 constant carries <= 2^-9 relative error, a hi/lo
# pair ~2^-18 plus one f32 add; the 1.25x / 2x margins only fatten
# silhouettes.
BF16_PANEL_ERR_EPS = 1.25 * 2.0 ** -9
HILO_PANEL_ERR_EPS = 2.0 ** -17

# The CUDA kernel's CTA (csrc/sweep.cu's kWarps, kBlockRays, kMaxBlockRays,
# kTileCols): a block of B = 32k rays, 1 <= k <= 16, runs 16 / k column
# groups of B threads, a thread a ray; at B = KERNEL_BLOCK_RAYS SWEEP_WARPS
# warps serve the block. A super's panel is staged whole at B = 32 when it
# has at most KERNEL_TILE_COLS columns, else in tiles of that many. The
# plain version takes any block.
SWEEP_WARPS = 16
KERNEL_BLOCK_RAYS = 32
KERNEL_MAX_BLOCK_RAYS = SWEEP_WARPS * KERNEL_BLOCK_RAYS
KERNEL_TILE_COLS = 1024


def kernel_serves(block_rays: int) -> bool:
    """Whether the CUDA sweep serves blocks of ``block_rays`` rays: 32k
    with 1 <= k <= 16."""
    b = int(block_rays)
    return KERNEL_BLOCK_RAYS <= b <= KERNEL_MAX_BLOCK_RAYS \
        and b % KERNEL_BLOCK_RAYS == 0


def kernel_tiled(block_rays: int, gl: int) -> bool:
    """Whether a launch takes the tiled kernel (any block but 32, or a
    panel wider than KERNEL_TILE_COLS columns)."""
    return int(block_rays) != KERNEL_BLOCK_RAYS or gl > KERNEL_TILE_COLS


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 on the host (round to nearest even), as uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bits -> f32 (exact)."""
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def panel_err_eps(bf16: bool, hilo: bool) -> float:
    """The certified epilogue's eps for a panel precision."""
    return (BF16_PANEL_ERR_EPS if bf16 else HILO_PANEL_ERR_EPS if hilo
            else MT_ERR_EPS)


class SweepTables:
    """Kernel tables from a ClusterAccel, bit-equal to the JAX package's
    SweepTables: host numpy from the SAH build, or tensors on the
    clusters' device from the device build (accel/morton.py), packed
    there without a host round trip.

    ``panel`` [S, 16, GLP]: row k is MT component k (n, e1, e2, w, q,
    v0.n) across the super's G clusters (GLP = G*L padded to 128); f32,
    or with ``panel_bf16`` the same as bf16 bits (uint16; a bf16 tensor on
    a device), or with ``panel_hilo`` [S, 32, GLP] bf16 bits, rows 0-15 hi
    and rows 16-31 lo = bf16(f32 - hi). ``slot_to_tri`` [S*GLP] maps a
    local slot s*GLP + k to the global triangle id (-1 = padding; padding
    slots carry zero constants, so det = 0 and they never hit).
    ``s_lo``/``s_hi`` [S, 3] are the super AABBs. The cluster count is
    padded to a multiple of G with empty clusters that repeat the last
    cluster's box."""

    def __init__(self, accel: ClusterAccel, group: int = 8,
                 panel_bf16: bool = False, panel_hilo: bool = False):
        l = accel.leaf_tris
        g = int(group)
        on_device = torch.is_tensor(accel.packed_mt)
        mt, tid, c_lo, c_hi = (torch.as_tensor(a) for a in (
            accel.packed_mt[:, :16 * l], accel.tri_id[:, :l], accel.c_lo,
            accel.c_hi))
        c = tid.shape[0]
        pad_c = (-c) % g
        if pad_c:
            mt = torch.cat([mt, mt.new_zeros((pad_c, 16 * l))])
            tid = torch.cat([tid, tid.new_full((pad_c, l), -1)])
            c_lo = torch.cat([c_lo, c_lo[-1:].expand(pad_c, 3)])
            c_hi = torch.cat([c_hi, c_hi[-1:].expand(pad_c, 3)])
        s = (c + pad_c) // g
        gl = g * l
        gl_pad = -(-gl // 128) * 128
        panel = mt.reshape(s, g, 16, l).transpose(1, 2).reshape(s, 16, gl)
        panel = torch.nn.functional.pad(panel.to(F32), (0, gl_pad - gl))
        slot = tid.new_full((s, gl_pad), -1)
        slot[:, :gl] = tid.reshape(s, gl)
        tables = (panel, slot.reshape(-1), c_lo.reshape(s, g, 3).amin(1),
                  c_hi.reshape(s, g, 3).amax(1))
        if on_device:
            self._set(cast_panel_tensor(panel, panel_bf16, panel_hilo),
                      *tables[1:])
        else:
            self._set(cast_panel(panel.numpy(), panel_bf16, panel_hilo),
                      *(t.numpy() for t in tables[1:]))
        self.group = g
        self.leaf_tris = l

    def _set(self, panel, slot_to_tri, s_lo, s_hi):
        if torch.is_tensor(panel):
            kind = _panel_kind(panel)
            self.panel_bf16 = kind == "bf16"
            self.panel_hilo = kind == "hilo"
            self.panel = panel.contiguous()
            self.slot_to_tri = slot_to_tri.to(torch.int32).contiguous()
            self.s_lo = s_lo.to(F32).contiguous()
            self.s_hi = s_hi.to(F32).contiguous()
            self.n_supers = self.panel.shape[0]
            self.gl_pad = self.panel.shape[2]
            return
        self.panel = np.ascontiguousarray(panel)
        rows = (16, 32) if self.panel.dtype == np.uint16 else (16,)
        if self.panel.dtype not in (np.float32, np.uint16) \
                or self.panel.ndim != 3 or self.panel.shape[1] not in rows:
            raise ValueError(f"panel: f32 or bf16 bits [S, 16, GL], or bf16 "
                             f"bits [S, 32, GL]; got {self.panel.dtype} "
                             f"{self.panel.shape}")
        self.panel_bf16 = self.panel.dtype == np.uint16 \
            and self.panel.shape[1] == 16
        self.panel_hilo = self.panel.shape[1] == 32
        self.slot_to_tri = np.ascontiguousarray(slot_to_tri, np.int32)
        self.s_lo = np.ascontiguousarray(s_lo, np.float32)
        self.s_hi = np.ascontiguousarray(s_hi, np.float32)
        self.n_supers = self.panel.shape[0]
        self.gl_pad = self.panel.shape[2]

    @property
    def err_eps(self) -> float:
        return panel_err_eps(self.panel_bf16, self.panel_hilo)

    @classmethod
    def from_arrays(cls, panel, slot_to_tri, s_lo, s_hi) -> "SweepTables":
        """Wrap tables packed elsewhere: ``panel`` is f32, or bf16 bits
        (uint16) with 16 rows (bf16) or 32 rows (hi/lo). Group and leaf
        sizes are not kept."""
        tb = object.__new__(cls)
        tb._set(panel, slot_to_tri, s_lo, s_hi)
        tb.group = tb.leaf_tris = None
        return tb


def cast_panel(panel: np.ndarray, bf16: bool = False,
               hilo: bool = False) -> np.ndarray:
    """An f32 panel [S, 16, GL] in the stored precision: itself, bf16
    bits, or hi/lo bf16 bits [S, 32, GL]."""
    if bf16 and hilo:
        raise ValueError("panel_bf16 and panel_hilo are mutually exclusive")
    if bf16:
        return bf16_bits(panel)
    if hilo:
        hi = bf16_bits(panel)
        lo = bf16_bits(panel - bits_to_f32(hi))
        return np.concatenate([hi, lo], axis=1)
    return np.asarray(panel, np.float32)


def cast_panel_tensor(panel: torch.Tensor, bf16: bool = False,
                      hilo: bool = False) -> torch.Tensor:
    """:func:`cast_panel` on a device: the same values, as an f32 or bf16
    tensor where it lies."""
    if bf16 and hilo:
        raise ValueError("panel_bf16 and panel_hilo are mutually exclusive")
    if bf16:
        return panel.to(torch.bfloat16)
    if hilo:
        hi = panel.to(torch.bfloat16)
        return torch.cat([hi, (panel - hi.to(F32)).to(torch.bfloat16)], 1)
    return panel


def panel_tensor(panel, device) -> torch.Tensor:
    """A panel as a device tensor: f32, or bf16 for host bf16 bits."""
    if torch.is_tensor(panel):
        return panel.to(device)
    p = np.ascontiguousarray(panel)
    if p.dtype == np.uint16:
        return torch.from_numpy(p.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(p).to(device)


# ---------------------------------------------------------------------------
# The sweep: plain PyTorch version and CUDA kernel, same signature.
# ---------------------------------------------------------------------------


def _panel_kind(panel: torch.Tensor) -> str:
    if panel.dtype == F32 and panel.shape[1] == 16:
        return "f32"
    if panel.dtype == torch.bfloat16 and panel.shape[1] in (16, 32):
        return "bf16" if panel.shape[1] == 16 else "hilo"
    raise ValueError(f"sweep: panel must be f32 [S, 16, GL] or bf16 "
                     f"[S, 16|32, GL], got {panel.dtype} {tuple(panel.shape)}")


def _upcast(p: torch.Tensor) -> torch.Tensor:
    """Panel rows as f32: a bf16 upcast is exact; hi/lo is f32(hi) +
    f32(lo), one rounding."""
    if p.dtype == F32:
        return p
    if p.shape[1] == 32:
        return p[:, :16].float() + p[:, 16:].float()
    return p.float()


def _dot3(a0, a1, a2, p, r):
    """(a0 * p[r] + a1 * p[r+1]) + a2 * p[r+2], the kernel's order."""
    return a0 * p[:, None, r] + a1 * p[:, None, r + 1] + a2 * p[:, None, r + 2]


def _panel_test(ra, p, certified: bool, err_eps: float):
    """(ok, t) for rays ra [10, A, B, 1] against panels p [A, 16, GL] (f32),
    in the kernel's association order."""
    o0, o1, o2, d0, d1, d2, m0, m1, m2 = (ra[i] for i in range(9))
    det = -_dot3(d0, d1, d2, p, 0)
    u_det = _dot3(m0, m1, m2, p, 6) - _dot3(d0, d1, d2, p, 9)
    v_det = -_dot3(m0, m1, m2, p, 3) - _dot3(d0, d1, d2, p, 12)
    t_det = _dot3(o0, o1, o2, p, 0) - p[:, None, 15]
    if not certified:
        return mt_epilogue(det, u_det, v_det, t_det)
    oa0, oa1, oa2, da0, da1, da2 = (x.abs() for x in (o0, o1, o2, d0, d1, d2))
    ma0 = oa1 * da2 + oa2 * da1                 # abs_cross(|o|, |d|)
    ma1 = oa2 * da0 + oa0 * da2
    ma2 = oa0 * da1 + oa1 * da0
    pa = p.abs()
    err_det = err_eps * _dot3(da0, da1, da2, pa, 0)
    err_u = err_eps * (_dot3(ma0, ma1, ma2, pa, 6)
                       + _dot3(da0, da1, da2, pa, 9))
    err_v = err_eps * (_dot3(ma0, ma1, ma2, pa, 3)
                       + _dot3(da0, da1, da2, pa, 12))
    err_t = err_eps * (_dot3(oa0, oa1, oa2, pa, 0) + pa[:, None, 15])
    return mt_epilogue_certified(det, u_det, v_det, t_det, err_det, err_u,
                                 err_v, err_t)


def sweep_plain(rays: torch.Tensor, order: torch.Tensor,
                suffix: torch.Tensor, panel: torch.Tensor, block_rays: int,
                any_hit: bool, certified: bool = False,
                err_eps: float | None = None, collect_stats: bool = False):
    """Plain PyTorch version of the sweep kernel.

    rays f32 [10, NB*B] (o, d, m = o x d, t_lim); order i32 [NB, S];
    suffix f32 [NB, S]; panel f32 [S, 16, GL], bf16 [S, 16, GL] or hi/lo
    bf16 [S, 32, GL] -> (best_t f32 [NB*B], +inf where nothing was found;
    best_i i32 [NB*B], local slot s*GL + k, -1 where nothing), and with
    ``collect_stats`` steps i32 [NB], the supers each block swept.
    ``err_eps`` (certified only) defaults to the panel precision's.

    Vectorised over blocks with a Python loop over steps; a block stops
    at the first step where no lane can improve, as in the kernel. Same
    tie rule: within a super the lowest slot among equal t, across
    supers strict '<' (the earlier-visited super wins)."""
    kind = _panel_kind(panel)
    if err_eps is None:
        err_eps = panel_err_eps(kind == "bf16", kind == "hilo")
    nb, n_supers = order.shape
    b = int(block_rays)
    gl = panel.shape[2]
    dev = rays.device
    r = rays.reshape(10, nb, b)
    t_lim = r[9]
    best_t = torch.full((nb, b), INF, dtype=F32, device=dev)
    best_i = torch.full((nb, b), -1, dtype=torch.int32, device=dev)
    done = torch.zeros(nb, dtype=torch.bool, device=dev)
    steps = torch.zeros(nb, dtype=torch.int32, device=dev)
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
        steps += (~done).to(torch.int32)
        sid = order[blocks, s].long()
        ok, t = _panel_test(r[:, blocks, :, None], _upcast(panel[sid]),
                            certified, err_eps)
        bt = best_t[blocks]
        limit = torch.minimum(bt, t_lim[blocks])[..., None]
        t = torch.where(ok & (t < limit), t, INF)
        tmin = t.amin(dim=2)
        kmin = torch.where(t <= tmin[..., None], cols, big).amin(dim=2)
        better = tmin < bt
        best_t[blocks] = torch.where(better, tmin, bt)
        best_i[blocks] = torch.where(
            better, sid[:, None].to(torch.int32) * gl + kmin, best_i[blocks])
    if collect_stats:
        return best_t.reshape(-1), best_i.reshape(-1), steps
    return best_t.reshape(-1), best_i.reshape(-1)


_KIND_CODE = {"f32": 0, "bf16": 1, "hilo": 2}


def arm_name(kind: str, certified: bool, pipeline: bool,
             collect_stats: bool) -> str:
    """The kernel arm's name in ``SweepKernel.arm_launches``, e.g.
    ``certified_bf16_pipelined``."""
    return "_".join(
        (["certified"] if certified else []) + [kind]
        + (["pipelined"] if pipeline else [])
        + (["stats"] if collect_stats else []))


class SweepKernel:
    """ctypes binding of csrc/sweep.cu (ops/nvcc.py), built at the first
    launch. ``launches`` counts kernel launches, ``arm_launches`` the same
    per arm (:func:`arm_name`), ``tiled_launches`` those that took the
    tiled kernel (:func:`kernel_tiled`)."""

    def __init__(self):
        self.launches = 0
        self.tiled_launches = 0
        self.arm_launches = collections.Counter()
        self.lib = CudaLibrary(
            "sweep", "sweep_launch",
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])

    def reset_counts(self) -> None:
        self.launches = 0
        self.tiled_launches = 0
        self.arm_launches.clear()

    def __call__(self, rays, order, suffix, panel, block_rays: int,
                 any_hit: bool, certified: bool = False,
                 err_eps: float | None = None, collect_stats: bool = False,
                 pipeline: bool = False):
        """Same contract as :func:`sweep_plain`, on CUDA tensors;
        ``pipeline`` double-buffers the panel copy (same results)."""
        nb, n_supers = order.shape
        kind = _panel_kind(panel)
        if err_eps is None:
            err_eps = panel_err_eps(kind == "bf16", kind == "hilo")
        gl = panel.shape[2]
        b = int(block_rays)
        dev = rays.device
        check_tensors("sweep kernel", dev, (
            (rays, F32, (10, nb * b)), (order, torch.int32, (nb, n_supers)),
            (suffix, F32, (nb, n_supers)),
            (panel, panel.dtype, (n_supers, panel.shape[1], gl))))
        if dev.type != "cuda" or gl % 8:
            raise ValueError("sweep kernel: CUDA tensors, GL % 8 == 0")
        if not kernel_serves(b):
            raise ValueError(
                f"sweep kernel: block_rays {b}; the kernel serves blocks of "
                f"32k rays, 1 <= k <= 16 ({KERNEL_BLOCK_RAYS} to "
                f"{KERNEL_MAX_BLOCK_RAYS}: a thread a ray, at most "
                f"{KERNEL_MAX_BLOCK_RAYS} threads a CTA)")
        launch = self.lib.load()
        best_t = torch.empty(nb * b, dtype=F32, device=dev)
        best_i = torch.empty(nb * b, dtype=torch.int32, device=dev)
        steps = torch.empty(nb, dtype=torch.int32, device=dev)
        out = (best_t, best_i, steps) if collect_stats else (best_t, best_i)
        if nb == 0:
            return out
        err = launch(
            rays.data_ptr(), order.data_ptr(), suffix.data_ptr(),
            panel.data_ptr(), best_t.data_ptr(), best_i.data_ptr(),
            steps.data_ptr() if collect_stats else None,
            nb, b, n_supers, gl, int(bool(any_hit)), int(bool(certified)),
            _KIND_CODE[kind], int(bool(pipeline)), float(err_eps),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
        self.launches += 1
        self.arm_launches[arm_name(kind, certified, pipeline,
                                   collect_stats)] += 1
        if kernel_tiled(b, gl):
            self.tiled_launches += 1
        return out


sweep_kernel = SweepKernel()


def sweep(rays, order, suffix, panel, block_rays: int, any_hit: bool,
          certified: bool = False, err_eps: float | None = None,
          collect_stats: bool = False, pipeline: bool = False):
    """The sweep: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (``pipeline`` only changes how the kernel stages its
    panels, so the plain version has no such option)."""
    opts = dict(certified=certified, err_eps=err_eps,
                collect_stats=collect_stats)
    if rays.device.type == "cuda":
        return sweep_kernel(rays, order, suffix, panel, block_rays, any_hit,
                            pipeline=pipeline, **opts)
    if rays.device.type == "cpu":
        return sweep_plain(rays, order, suffix, panel, block_rays, any_hit,
                           **opts)
    raise ValueError(f"sweep: unsupported device {rays.device}")


# ---------------------------------------------------------------------------
# The prologue: plain PyTorch version and CUDA kernel (csrc/entry.cu).
# ---------------------------------------------------------------------------

# Keys the prologue kernel sorts in shared memory (32 KB: the 1M mesh's
# 2760 supers fit whole); a row with more finite entries sorts in a global
# workspace.
PROLOGUE_KEYS = 4096


def block_entry_plain(s_lo, s_hi, o_p, d_p, t_p, block_rays: int):
    """Least slab entry distance over each block's rays, per super: f32
    [NB, S], +inf where no live ray of the block enters the box.

    s_lo, s_hi [S, 3]; o_p, d_p [NB*B, 3]; t_p [NB*B] (t_lim; < 0 dead).
    Builds the [NB*B, S] table of :func:`entry_boxes` and reduces it."""
    entry = entry_boxes(s_lo, s_hi, o_p, d_p, t_p.clamp_min(0.0))
    entry = torch.where(t_p[:, None] < 0.0, INF, entry)
    return entry.reshape(-1, int(block_rays), s_lo.shape[0]).amin(dim=1)


def order_suffix(entry_b: torch.Tensor):
    """Per row of an entry table [NB, S]: the demand order (stable argsort,
    i32) and the suffix-min of the ordered entries."""
    order = torch.argsort(entry_b, dim=1, stable=True)
    entry_o = torch.gather(entry_b, 1, order)
    suffix = torch.flip(torch.cummin(torch.flip(entry_o, [1]), 1).values,
                        [1]).contiguous()
    return order.to(torch.int32).contiguous(), suffix


def prologue_plain(s_lo, s_hi, o_p, d_p, t_p, block_rays: int):
    """Plain PyTorch version of the prologue kernel: (order i32 [NB, S],
    suffix f32 [NB, S]) from the entry table of :func:`block_entry_plain`,
    as the JAX wrapper computes them (sweep_pallas.py:527-536)."""
    return order_suffix(block_entry_plain(s_lo, s_hi, o_p, d_p, t_p,
                                          block_rays))


class BlockEntryKernel:
    """ctypes binding of csrc/entry.cu, built at the first launch.

    Calling it launches the prologue kernel: the same (order, suffix) as
    :func:`prologue_plain` on CUDA tensors, without the [NB*B, S] table or
    the [NB, S] entry table; ``launches`` counts its launches.
    :meth:`table` launches the entry table kernel alone (the same as
    :func:`block_entry_plain`) for :func:`prologue_torch`, a yardstick no
    render path takes; ``table_launches`` counts those."""

    def __init__(self):
        self.launches = 0
        self.table_launches = 0
        self.lib = CudaLibrary("entry", "prologue_launch",
                               [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])

    def reset_counts(self) -> None:
        self.launches = 0
        self.table_launches = 0

    @staticmethod
    def _check(s_lo, s_hi, o_p, d_p, t_p, b):
        n, s = o_p.shape[0], s_lo.shape[0]
        dev = o_p.device
        check_tensors("block entry kernel", dev, (
            (s_lo, F32, (s, 3)), (s_hi, F32, (s, 3)), (o_p, F32, (n, 3)),
            (d_p, F32, (n, 3)), (t_p, F32, (n,))))
        if dev.type != "cuda" or b < 1 or n % b:
            raise ValueError("block entry kernel: CUDA tensors, rays a "
                             "multiple of block_rays")
        return n // b, s, dev

    def __call__(self, s_lo, s_hi, o_p, d_p, t_p, block_rays: int,
                 key_capacity: int = PROLOGUE_KEYS):
        """(order i32 [NB, S], suffix f32 [NB, S]). ``key_capacity``: the
        keys a row may sort in shared memory (1..PROLOGUE_KEYS); a smaller
        value sends more rows through the workspace, which the tests use
        to reach it on small scenes."""
        b = int(block_rays)
        nb, s, dev = self._check(s_lo, s_hi, o_p, d_p, t_p, b)
        if not 1 <= key_capacity <= PROLOGUE_KEYS:
            raise ValueError(f"key_capacity {key_capacity}: 1.."
                             f"{PROLOGUE_KEYS}")
        launch = self.lib.load()
        order = torch.empty((nb, s), dtype=torch.int32, device=dev)
        suffix = torch.empty((nb, s), dtype=F32, device=dev)
        if nb == 0 or s == 0:
            return order, suffix
        cap = min(int(key_capacity), s)
        ws = (torch.empty((nb, s), dtype=torch.int64, device=dev)
              if cap < s else None)
        err = launch(s_lo.data_ptr(), s_hi.data_ptr(), o_p.data_ptr(),
                     d_p.data_ptr(), t_p.data_ptr(), order.data_ptr(),
                     suffix.data_ptr(), None if ws is None else ws.data_ptr(),
                     nb, b, s, cap, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"prologue kernel launch failed: CUDA error "
                               f"{err}")
        self.launches += 1
        return order, suffix

    def table(self, s_lo, s_hi, o_p, d_p, t_p, block_rays: int):
        """The entry table f32 [NB, S] (:func:`block_entry_plain`)."""
        b = int(block_rays)
        nb, s, dev = self._check(s_lo, s_hi, o_p, d_p, t_p, b)
        launch = self.lib.function("entry_launch", [ctypes.c_void_p] * 6
                                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        out = torch.empty((nb, s), dtype=F32, device=dev)
        if nb == 0 or s == 0:
            return out
        err = launch(s_lo.data_ptr(), s_hi.data_ptr(), o_p.data_ptr(),
                     d_p.data_ptr(), t_p.data_ptr(), out.data_ptr(), nb, b, s,
                     torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"block entry kernel launch failed: CUDA "
                               f"error {err}")
        self.table_launches += 1
        return out


block_entry_kernel = BlockEntryKernel()


def block_entry(s_lo, s_hi, o_p, d_p, t_p, block_rays: int):
    """The block entry table: the table kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if o_p.device.type == "cuda":
        return block_entry_kernel.table(s_lo, s_hi, o_p, d_p, t_p, block_rays)
    if o_p.device.type == "cpu":
        return block_entry_plain(s_lo, s_hi, o_p, d_p, t_p, block_rays)
    raise ValueError(f"block_entry: unsupported device {o_p.device}")


def prologue_torch(s_lo, s_hi, o_p, d_p, t_p, block_rays: int):
    """The prologue the kernel replaced on the card -- the entry table
    kernel, torch.argsort and a reverse cummin -- kept as the prologue
    kernel's yardstick; no render path calls it."""
    return order_suffix(block_entry(s_lo, s_hi, o_p, d_p, t_p, block_rays))


def prologue(s_lo, s_hi, o_p, d_p, t_p, block_rays: int):
    """(order, suffix): the prologue kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if o_p.device.type == "cuda":
        return block_entry_kernel(s_lo, s_hi, o_p, d_p, t_p, block_rays)
    if o_p.device.type == "cpu":
        return prologue_plain(s_lo, s_hi, o_p, d_p, t_p, block_rays)
    raise ValueError(f"prologue: unsupported device {o_p.device}")


# ---------------------------------------------------------------------------
# The accelerator around it
# ---------------------------------------------------------------------------


class SweepAccelerator:
    """Triangle closest-hit / any-hit through the sweep (the JAX package's
    PallasSweepAccelerator). Tables are device tensors, moved to
    ``device`` once here; a table that already lies there is kept, not
    copied.

    ``accel``: a ClusterAccel, packed here into SweepTables of ``group``
    clusters a super (8 when None) with ``panel_bf16`` / ``panel_hilo``;
    or SweepTables packed elsewhere (then ``group`` and the panel options
    must be left unset). ``block_rays``: rays per kernel block (one CTA):
    32k with 1 <= k <= 16 on a card, any on the CPU. The port's default is
    32 (the JAX package's 512: ROADMAP §C). ``ray_chunk``: rays per
    launch. ``sort_rays``: coherence-sort the rays first (so each block
    enters few supers). ``certified``, ``pipeline``, ``collect_stats``:
    the sweep's options (module docstring); with ``collect_stats`` every
    launch appends its per-block step counts [NB] to ``last_steps``.
    ``skipped_chunks`` counts the chunks :meth:`intersect` gave the miss
    result without a launch (no live lane). The world box of the ray sort
    is reduced from the super boxes on the device."""

    def __init__(self, accel, device="cuda", group: int | None = None,
                 block_rays: int = 32, ray_chunk: int = 65536,
                 sort_rays: bool = True, pipeline: bool = False,
                 certified: bool = False, panel_bf16: bool = False,
                 panel_hilo: bool = False, collect_stats: bool = False):
        if isinstance(accel, SweepTables):
            if (group is not None and group != accel.group) or panel_bf16 \
                    or panel_hilo:
                raise ValueError("SweepAccelerator: group and the panel "
                                 "options pack a ClusterAccel; these tables "
                                 "are packed already")
            tables = accel
        elif isinstance(accel, ClusterAccel):
            tables = SweepTables(accel, 8 if group is None else group,
                                 panel_bf16=panel_bf16, panel_hilo=panel_hilo)
        else:
            raise TypeError(f"SweepAccelerator: a ClusterAccel or "
                            f"SweepTables, not {type(accel).__name__}")
        self.device = torch.device(device)
        self.block_rays = int(block_rays)
        self.ray_chunk = int(ray_chunk)
        self.sort_rays = bool(sort_rays)
        self.certified = bool(certified)
        self.pipeline = bool(pipeline)
        self.collect_stats = bool(collect_stats)
        self.last_steps = []
        self.skipped_chunks = 0
        self._load(tables)

    @classmethod
    def from_tables(cls, tables: SweepTables, *, device="cuda",
                    block_rays: int = 128, ray_chunk: int = 8192,
                    sort_rays: bool = True, pipeline: bool = False,
                    certified: bool = False) -> "SweepAccelerator":
        """The sweep over pre-packed tables, with the JAX package's
        from_tables defaults (blocks of 128 rays, 8192 rays a launch): the
        route of huge static scenes, whose tables the caller packs once
        and hands to every frame (integrators/common.py)."""
        return cls(tables, device, block_rays=block_rays,
                   ray_chunk=ray_chunk, sort_rays=sort_rays,
                   pipeline=pipeline, certified=certified)

    def _load(self, tables: SweepTables) -> None:
        dev = self.device
        self.tables = tables
        self.panel = panel_tensor(tables.panel, dev)
        self.slot_to_tri = torch.as_tensor(tables.slot_to_tri).to(
            dev, torch.int64)
        self.s_lo = torch.as_tensor(tables.s_lo).to(dev)
        self.s_hi = torch.as_tensor(tables.s_hi).to(dev)
        self.world_lo = self.s_lo.amin(0)
        self.world_inv_extent = 1.0 / (self.s_hi.amax(0)
                                       - self.world_lo).clamp_min(1e-12)

    def view(self, block_rays: int | None = None,
             ray_chunk: int | None = None,
             certified: bool | None = None) -> "SweepAccelerator":
        """A copy with another block, chunk or certification that shares
        this one's device tensors (a frame's accelerator,
        integrators/common.py)."""
        v = copy.copy(self)
        if block_rays is not None:
            v.block_rays = int(block_rays)
        if ray_chunk is not None:
            v.ray_chunk = int(ray_chunk)
        if certified is not None:
            v.certified = bool(certified)
        v.last_steps = []
        v.skipped_chunks = 0
        return v

    def refit(self, v0, v1, v2) -> None:
        """Refresh the tables for moved vertices [T, 3] (host or device)
        with the same topology (port of the JAX package's
        PallasSweepAccelerator.refit): each cluster keeps its triangles
        (``slot_to_tri``), its constants and box are recomputed on the
        host through the static build's double-precision route, and the
        super boxes follow. The result equals a static build of the same
        clusters bit for bit."""
        tb = self.tables
        if tb.group is None:
            raise ValueError("refit needs tables packed from clusters "
                             "(SweepTables.from_arrays keeps no group)")
        l = tb.leaf_tris
        slot = torch.as_tensor(tb.slot_to_tri).cpu().numpy().reshape(
            tb.n_supers, -1)[:, :tb.group * l].reshape(-1, l)
        host = [x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
                for x in (v0, v1, v2)]
        acc = refit_clusters(ClusterAccel(
            c_lo=None, c_hi=None, s_lo=None, s_hi=None, packed=None,
            packed_mt=None, tri_id=slot, leaf_tris=l, super_size=1), *host)
        self._load(SweepTables(acc, tb.group, panel_bf16=tb.panel_bf16,
                               panel_hilo=tb.panel_hilo))

    def pad_rays(self, o, d, t_max):
        """(o_p, d_p, t_p): the chunk padded to whole blocks. Padding lanes
        are dead (t_lim = -1); t_max = +inf or NaN becomes 3e38, and -inf
        becomes -1: such a lane is dead, not swept in full (no hit has t
        <= -inf, so its hit and t are what they were)."""
        pad = (-o.shape[0]) % self.block_rays
        o_p = torch.cat([o, o.new_zeros((pad, 3))])
        d_p = torch.cat([d, d.new_zeros((pad, 3))])
        t_lim = torch.where(t_max == -INF, -1.0, t_max)
        t_p = torch.cat([torch.where(torch.isfinite(t_lim), t_lim, 3e38),
                         torch.full((pad,), -1.0, dtype=F32,
                                    device=o.device)])
        return o_p, d_p, t_p

    def prologue(self, o, d, t_max):
        """One chunk's kernel inputs: (rays [10, NB*B], order i32 [NB, S],
        suffix [NB, S])."""
        o_p, d_p, t_p = self.pad_rays(o, d, t_max)
        # Per-block demand order + suffix-min over super entry distances.
        order, suffix = prologue(self.s_lo, self.s_hi, o_p, d_p, t_p,
                                 self.block_rays)
        m = torch.stack([o_p[:, 1] * d_p[:, 2] - o_p[:, 2] * d_p[:, 1],
                         o_p[:, 2] * d_p[:, 0] - o_p[:, 0] * d_p[:, 2],
                         o_p[:, 0] * d_p[:, 1] - o_p[:, 1] * d_p[:, 0]], 1)
        rays = torch.cat([o_p.T, d_p.T, m.T, t_p[None]], 0).contiguous()
        return rays, order, suffix

    def _traverse_chunk(self, o, d, t_max, any_hit: bool):
        n = o.shape[0]
        rays, order, suffix = self.prologue(o, d, t_max)
        out = sweep(rays, order, suffix, self.panel, self.block_rays, any_hit,
                    certified=self.certified, err_eps=self.tables.err_eps,
                    collect_stats=self.collect_stats, pipeline=self.pipeline)
        if self.collect_stats:
            self.last_steps.append(out[2])
        bt, bi = out[0][:n], out[1][:n]
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

    def live_chunks(self, t_max) -> list:
        """The starts of the chunks of ``t_max`` (in launch order) that hold
        a lane the kernels treat as live: t_max >= 0 or NaN (pad_rays sends
        +inf and NaN to 3e38, -inf to -1). One host read."""
        live = ~(t_max < 0)
        n, c = t_max.shape[0], self.ray_chunk
        pad = (-n) % c
        if pad:
            live = torch.cat([live, live.new_zeros(pad)])
        flags = live.reshape(-1, c).any(dim=1).tolist()
        return [i * c for i, f in enumerate(flags) if f]

    def intersect(self, o, d, t_max, any_hit: bool):
        """Rays o, d [N, 3], t_max [N] -> (hit [N], t [N], tri [N] i32).

        With ``sort_rays`` the rays are coherence-sorted first (direction
        octant, then Morton order of the origin) so each block enters few
        supers; lanes with t_max < 0 are dead and sort last. Only the
        chunks that hold a live lane run the prologue and the sweep
        (``live_chunks``); the others get what the sweep gives a dead lane
        -- hit false, t +inf and the triangle of slot 0 -- and count in
        ``skipped_chunks``. In the sync-free mode (core/sync.py) every
        chunk launches, with no host read: a chunk with no live lane gives
        the same result."""
        n = o.shape[0]
        perm = None
        if self.sort_rays:
            perm = self.coherence_order(o, d, t_max)
            o, d, t_max = o[perm], d[perm], t_max[perm]
        c = self.ray_chunk
        hit = torch.zeros(n, dtype=torch.bool, device=o.device)
        t = torch.full((n,), INF, dtype=F32, device=o.device)
        idx = self.slot_to_tri[0].clamp_min(0).to(torch.int32).expand(
            n).clone()
        starts = (range(0, n, c) if sync_free() else
                  self.live_chunks(t_max))
        self.skipped_chunks += -(-n // c) - len(starts)
        for s in starts:
            hit[s:s + c], t[s:s + c], idx[s:s + c] = self._traverse_chunk(
                o[s:s + c], d[s:s + c], t_max[s:s + c], any_hit)
        if perm is None:
            return hit, t, idx
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n, device=perm.device)
        return hit[inv], t[inv], idx[inv]


def attach(scene, leaf_tris: int = 64, group: int = 8,
           max_prims_per_leaf: int = 4, block_rays: int = 32,
           ray_chunk: int = 16384, pipeline: bool = False,
           certified: bool | None = None):
    """Install the sweep over an SAH cluster build of the scene's
    triangles (the JAX package's sweep_pallas.attach; the port's block is
    32 rays, JAX's 512: ROADMAP §C) and bump the scene's version.
    ``certified`` defaults to the scene's exact_shared_edges."""
    if scene.n_triangles == 0:
        return scene
    from ..shapes import triangle as tri_mod

    if certified is None:
        certified = bool(scene.exact_edges)
    accel = build_clusters(tri_mod.to_numpy(scene.triangles), leaf_tris,
                           max_prims_per_leaf)
    scene.bump_version()
    scene.accel = SweepAccelerator(
        accel, scene.device, group=group, block_rays=block_rays,
        ray_chunk=ray_chunk, pipeline=pipeline, certified=certified)
    return scene
