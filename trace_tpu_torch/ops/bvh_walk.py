"""The per-ray BVH stack walk's CUDA kernel (csrc/bvh_walk.cu), bound with
ctypes (ops/nvcc.py).

It replaces the JAX package's two walks, trace_tpu/accel/wbvh.py::
traverse_batch ("wbvh" limit) and trace_tpu/accel/bvh.py::_traverse_one
("bvh" limit); both are XLA while_loops, not Pallas kernels. Its plain
PyTorch twin, with the same signature and arithmetic, is
accel/wbvh.py::walk_plain; accel/wbvh.py::walk picks by device. Inputs:
the node matrix [M, 8] and leaf-ordered triangle rows [T, 12] of
accel/wbvh.py::pack_nodes / pack_leaf_tris, rays o, d [N, 3], t_max [N].
Outputs: (t [N] f32, +inf on a miss; id [N] i32, -1 on a miss), and with
``collect_stats`` the per-ray node visits and triangle tests [2, N] i32;
with ``collect_stats`` and ``seen`` (u8 [M + T], zeroed by the caller) the
kernel also sets to 1 every node row (first M) and triangle row (last T)
a walk touched: the distinct rows a launch must read.
"""
from __future__ import annotations

import ctypes

import torch

from .nvcc import CudaLibrary, check_tensors

F32 = torch.float32
# The kernel's per-thread stack (csrc/bvh_walk.cu kStackCap), the JAX
# package's STACK_DEPTH (trace_tpu/accel/bvh.py:25).
STACK_CAP = 64
LIMITS = ("wbvh", "bvh")


class WalkKernel:
    """ctypes binding of csrc/bvh_walk.cu, built at the first launch.
    ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self.lib = CudaLibrary("bvh_walk", "bvh_walk_launch",
                               [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p])

    def reset_counts(self) -> None:
        self.launches = 0

    def __call__(self, nodes, tris, o, d, t_max, *, any_hit: bool,
                 limit: str = "wbvh", stack_depth: int = STACK_CAP,
                 collect_stats: bool = False, seen=None):
        n = o.shape[0]
        m = nodes.shape[0]
        dev = o.device
        check_tensors("bvh walk kernel", dev, (
            (nodes, F32, (nodes.shape[0], 8)),
            (tris, F32, (tris.shape[0], 12)),
            (o, F32, (n, 3)), (d, F32, (n, 3)), (t_max, F32, (n,)))
            + (() if seen is None else (
                (seen, torch.uint8, (m + tris.shape[0],)),)))
        for bad, what in (
                (limit not in LIMITS, f"limit in {LIMITS}"),
                (not 1 <= stack_depth <= STACK_CAP,
                 f"1 <= stack_depth <= {STACK_CAP}"),
                (any(t.data_ptr() % 16 for t in (nodes, tris)),
                 "nodes and tris 16-byte aligned"),
                (seen is not None and not collect_stats,
                 "seen only with collect_stats"),
                (dev.type != "cuda", "CUDA tensors (walk_plain takes the "
                 "CPU's)")):
            if bad:
                raise ValueError(f"bvh walk kernel: wants {what}")
        launch = self.lib.load()
        out_t = torch.empty(n, dtype=F32, device=dev)
        out_i = torch.empty(n, dtype=torch.int32, device=dev)
        stats = (torch.empty((2, n), dtype=torch.int32, device=dev)
                 if collect_stats else None)
        if n:
            err = launch(nodes.data_ptr(), tris.data_ptr(), o.data_ptr(),
                         d.data_ptr(), t_max.data_ptr(), out_t.data_ptr(),
                         out_i.data_ptr(),
                         None if stats is None else stats.data_ptr(),
                         None if seen is None else seen.data_ptr(),
                         None if seen is None else seen[m:].data_ptr(), n,
                         int(stack_depth), int(any_hit),
                         int(limit == "bvh"),
                         torch.cuda.current_stream(dev).cuda_stream)
            if err != 0:
                raise RuntimeError(
                    f"bvh walk kernel launch failed: CUDA error {err}")
            self.launches += 1
        return (out_t, out_i) if stats is None else (out_t, out_i, stats)


walk_kernel = WalkKernel()
