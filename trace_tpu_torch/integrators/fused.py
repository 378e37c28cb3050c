"""SPPM's fused blocks on the card: one CUDA graph a block.

The card's counterpart of the JAX package's one-dispatch iteration block
(trace_tpu/integrators/sppm.py::_iterations_fused) is a CUDA graph of
``SPPMIntegrator._iterations_body``: captured once per (scene view,
block length, pair chunks) and replayed with nothing read back inside the
block. Before its capture a block runs once eagerly on a side stream (on
a copy of the state, the result dropped), so that modules load and the
caches of the path (device constants, a view's area-light tables) fill
outside the capture; the capture then runs under
``torch.cuda.set_sync_debug_mode("error")``, so any host read in the body
raises. Nothing falls back: a capture or a kernel build that fails
raises.

A replay copies the caller's state into the graph's input buffers and
the iteration number into a device scalar (a fill), replays, and clones
the outputs: a state the caller holds is never written.

Every accelerator of the package has a route with no host read under
core/sync.py's ``no_host_reads``: the sweep's every chunk, the walk
kernels, the all-pairs tests, the ``clusters`` traversal's every stage
and the instance walk's every group over a fixed pair buffer (whose
overflow sends the block back to the stepwise path, as the pair total
does). A scene with an accelerator of another kind is refused on the
card, by the accelerator's name: its route is not known to read nothing.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import fields

import torch

from ..accel.bvh import BVHAccelerator
from ..accel.clusters import ClusterAccelerator
from ..accel.instances import InstancedGeometry, InstancedSpheres
from ..accel.mxu import MXUAccelerator
from ..accel.wbvh import WBVHAccelerator
from ..ops.intersect import IntersectAccelerator
from ..ops.sweep import SweepAccelerator

# The accelerators whose routes read nothing on the host under
# no_host_reads.
CAPTURABLE = (SweepAccelerator, WBVHAccelerator, BVHAccelerator,
              ClusterAccelerator, IntersectAccelerator, MXUAccelerator,
              InstancedGeometry, InstancedSpheres)


def kernel_counts() -> dict:
    """Launches so far of each hand-written kernel, by wrapper."""
    from ..ops.bvh_walk import walk_kernel
    from ..ops.intersect import intersect_kernel
    from ..ops.sweep import block_entry_kernel, sweep_kernel

    return {"sweep": sweep_kernel.launches,
            "prologue": block_entry_kernel.launches,
            "bvh_walk": walk_kernel.launches,
            "intersect": intersect_kernel.launches}


def check_capturable(scene) -> None:
    """NotImplementedError for a scene with an accelerator (or instanced
    geometry) of a kind whose route may read the host."""
    for acc in [scene.accel] + list(scene.instanced):
        if acc is not None and not isinstance(acc, CAPTURABLE):
            raise NotImplementedError(
                f"fused SPPM blocks on the card: {type(acc).__name__} has "
                f"no route known to read nothing on the host, so a CUDA "
                f"graph cannot capture it; render stepwise "
                f"(fused_iterations=False)")


@contextlib.contextmanager
def _sync_errors():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _clone(state):
    return type(state)(*[getattr(state, f.name).clone()
                         for f in fields(state)])


class _Block:
    """One captured block: its input buffers, graph and outputs."""

    def __init__(self, integ, scene, state, it: int, n_iters: int, pixels,
                 key, light_cdf, light_pmf, pair_chunks: int):
        dev = state.ld.device
        # The graph reads these at their capture addresses: keep them.
        self.inputs = (scene, pixels, key, light_cdf, light_pmf)
        self.state = _clone(state)
        self.it = torch.full((), it, dtype=torch.int64, device=dev)

        def body():
            return integ._iterations_body(
                scene, self.state, n_iters, self.it, pixels, key, light_cdf,
                light_pmf, pair_chunks)

        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        before = kernel_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            with _sync_errors():
                self.out, self.totals, self.pairs = body()
        torch.cuda.synchronize(dev)
        after = kernel_counts()
        self.record = dict(
            n_iters=n_iters, pair_chunks=pair_chunks,
            warm_ms=(t1 - t0) * 1e3,
            capture_ms=(time.perf_counter() - t1) * 1e3,
            launches={k: after[k] - before[k] for k in after})

    def replay(self, state, it: int):
        for f in fields(state):
            getattr(self.state, f.name).copy_(getattr(state, f.name))
        self.it.fill_(it)
        self.graph.replay()
        return _clone(self.out), self.totals.clone(), self.pairs.clone()


class BlockGraphs:
    """One integrator's captured blocks, for one scene view at a time: a
    view other than the last one (another scene, light table,
    accelerator or sweep tables, triangle table or camera, a scene whose
    version was bumped, or changed integrator settings) drops every graph
    first. A block is captured per block length, pair chunks and the
    instance walks' pair capacities. ``captures`` lists
    each capture's block length, pair chunks, warm-up and capture host
    ms, and kernel launches per replay (the wrappers count launches while
    the graph is captured, and a replay repeats them)."""

    def __init__(self):
        self.view = None
        self.graphs = {}
        self.captures = []

    def _view(self, integ, scene):
        # A refit replaces the sweep's tables in place.
        objects = (scene, scene.lights, scene.accel,
                   getattr(scene.accel, "tables", None), scene.triangles,
                   integ.camera)
        settings = (integ.seed, integ.max_depth, integ.n_iterations,
                    integ.photons_per_iteration, integ.pixel_chunk,
                    integ.pair_chunk, scene._version)
        if self.view is None or settings != self.view[1] or any(
                a is not b for a, b in zip(objects, self.view[0])):
            self.graphs.clear()
            self.view = (objects, settings)

    def run(self, integ, scene, state, it: int, n_iters: int, pixels, key,
            light_cdf, light_pmf, pair_chunks: int):
        """Iterations it .. it + n_iters - 1 from ``state`` -> (state, pair
        totals [n_iters], instance pairs [G]), by a replay of the block's
        graph (captured here at its first use)."""
        check_capturable(scene)
        self._view(integ, scene)
        key_ = (n_iters, pair_chunks,
                tuple(integ.fused_pair_capacity.get(g)
                      for g in scene.instanced))
        blk = self.graphs.get(key_)
        if blk is None:
            blk = _Block(integ, scene, state, it, n_iters, pixels, key,
                         light_cdf, light_pmf, pair_chunks)
            self.graphs[key_] = blk
            self.captures.append(blk.record)
        return blk.replay(state, it)
