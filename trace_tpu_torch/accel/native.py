"""The SAH BVH builder, refit and cluster packer in C++, bound with ctypes.

The source is the port's own ``csrc/bvh_builder.cpp`` (a copy of the JAX
package's builder, the same code). It is compiled at first use into this
package's ``build/`` directory with ``g++ -O3 -ffp-contract=off -shared
-fPIC``: no ``-march=native``, so the library runs on whatever host
builds it, and no FMA contraction, so the double-precision
Moller-Trumbore constants round exactly like the JAX package's.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "bvh_builder.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libbvh_builder.so")

_lock = threading.Lock()
_lib = None

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)


def _build() -> str:
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name and rename: concurrent test workers may
    # race to build, and a rename is atomic.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-ffp-contract=off", "-shared", "-fPIC",
           "-o", tmp, SOURCE]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIB_PATH


def load() -> ctypes.CDLL:
    """Compile (if needed) and load the library; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.bvh_build.restype = ctypes.c_int64
            lib.bvh_build.argtypes = [
                _F, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                _F, _F, _I32, _I32, _I32, _I32, _I32]
            lib.bvh_cluster_cut.restype = ctypes.c_int64
            lib.bvh_cluster_cut.argtypes = [
                ctypes.c_int64, _I32, _I32, ctypes.c_int32, ctypes.c_int64,
                _I32, _I64, _I64]
            lib.bvh_refit.restype = None
            lib.bvh_refit.argtypes = [
                _F, ctypes.c_int64, ctypes.c_int64, _F, _F, _I32, _I32, _I32,
                _I32]
            lib.cluster_pack.restype = None
            lib.cluster_pack.argtypes = [
                _F, _F, _F, _I32, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int64, ctypes.c_int64, _F, _F, _F, _F]
            _lib = lib
        return _lib


def _fp(a):
    return a.ctypes.data_as(_F)


def _ip(a):
    return a.ctypes.data_as(_I32)


def _lp(a):
    return a.ctypes.data_as(_I64)


def build_bvh(bounds: np.ndarray, max_prims_per_leaf: int = 4):
    """12-bucket SAH build over AABBs [T, 2, 3] -> dict of the flattened
    depth-first layout (lo, hi, right_child, prim_start, n_prims, axis,
    prim_order), as trace_tpu/accel/bvh.py:build_bvh."""
    lib = load()
    t_count = bounds.shape[0]
    cap = max(2 * t_count, 16)
    b = np.ascontiguousarray(bounds, np.float32)
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    right = np.empty(cap, np.int32)
    start = np.empty(cap, np.int32)
    count = np.empty(cap, np.int32)
    axis = np.empty(cap, np.int32)
    order = np.empty(t_count, np.int32)
    n = lib.bvh_build(_fp(b), t_count, max_prims_per_leaf, cap, _fp(lo),
                      _fp(hi), _ip(right), _ip(start), _ip(count),
                      _ip(axis), _ip(order))
    if n < 0:
        raise RuntimeError("bvh_build: node capacity exceeded")
    return dict(lo=lo[:n], hi=hi[:n], right_child=right[:n],
                prim_start=start[:n], n_prims=count[:n], axis=axis[:n],
                prim_order=order)


def refit_bvh(bvh: dict, bounds: np.ndarray) -> dict:
    """The tree's node bounds refreshed from primitive AABBs [T, 2, 3] of
    moved geometry with the same topology: one bottom-up sweep (children
    have larger indices than their parents). Returns a new dict; the
    topology arrays are shared."""
    lib = load()
    lo = np.array(bvh["lo"], np.float32, order="C")
    hi = np.array(bvh["hi"], np.float32, order="C")
    right, start, count, order = (
        np.ascontiguousarray(bvh[k], np.int32)
        for k in ("right_child", "prim_start", "n_prims", "prim_order"))
    b = np.ascontiguousarray(bounds, np.float32)
    lib.bvh_refit(_fp(b), b.shape[0], lo.shape[0], _fp(lo), _fp(hi),
                  _ip(right), _ip(start), _ip(count), _ip(order))
    return dict(bvh, lo=lo, hi=hi)


def cluster_cut(right_child: np.ndarray, n_prims: np.ndarray,
                leaf_tris: int):
    """Cut the tree at subtrees of <= leaf_tris prims -> (nodes, starts,
    counts) in left-child-first depth-first order."""
    lib = load()
    m = int(n_prims.shape[0])
    right = np.ascontiguousarray(right_child, np.int32)
    nprims = np.ascontiguousarray(n_prims, np.int32)
    nodes = np.empty(m, np.int32)
    starts = np.empty(m, np.int64)
    counts = np.empty(m, np.int64)
    c = lib.bvh_cluster_cut(m, _ip(right), _ip(nprims), leaf_tris, m,
                            _ip(nodes), _lp(starts), _lp(counts))
    if c < 0:
        raise RuntimeError("bvh_cluster_cut: capacity exceeded")
    return nodes[:c].astype(np.int64), starts[:c], counts[:c]


def cluster_pack(v0, v1, v2, tri_id: np.ndarray, leaf_tris: int):
    """(packed, packed_mt, lo, hi): each cluster's vertex rows [C, 9*L
    padded to 128] (v0 | v1 | v2, each L x 3 row-major, padding slots
    zero); its Moller-Trumbore constants, computed in double and rounded
    once: [C, 16*L padded to 128] rows n|e1|e2|w|q (3L each,
    component-major) then v0.n (L), padding slots zero; and its vertex
    AABB [C, 3] (an empty cluster gets lo 3e38, hi -3e38)."""
    lib = load()
    c = tri_id.shape[0]
    l = int(leaf_tris)
    p_stride = 9 * l + ((-9 * l) % 128)
    mt_stride = 16 * l + ((-16 * l) % 128)
    tid = np.ascontiguousarray(tri_id[:, :l], np.int32)
    v0c, v1c, v2c = (np.ascontiguousarray(v, np.float32)
                     for v in (v0, v1, v2))
    packed = np.empty((c, p_stride), np.float32)
    packed_mt = np.empty((c, mt_stride), np.float32)
    lo = np.empty((c, 3), np.float32)
    hi = np.empty((c, 3), np.float32)
    lib.cluster_pack(_fp(v0c), _fp(v1c), _fp(v2c), _ip(tid), c, l,
                     p_stride, mt_stride, _fp(packed), _fp(packed_mt),
                     _fp(lo), _fp(hi))
    return packed, packed_mt, lo, hi
