"""CUDA graphs of the render path on the card: SPPM's fused blocks and the
Whitted frame.

The card's counterpart of the JAX package's one-dispatch iteration block
(trace_tpu/integrators/sppm.py::_iterations_fused) is a CUDA graph of
``SPPMIntegrator._iterations_body``: captured once per (scene view,
block length, pair chunks) and replayed with nothing read back inside the
block. Before a block's capture it runs once eagerly on the current stream
(on a copy of the state, the result dropped), so that modules load and
the caches of the path (device constants, a view's area-light tables)
fill outside the capture. A Whitted frame (``SamplerIntegrator.
frame_body``: the film zeroed, every chunk's sample passes and splats) is
one graph per scene view (:class:`FrameGraphs`), which pays only where a
view is rendered again: a view's first frame is its body run eagerly on
the current stream (the same warm-up, and the caller's frame), its second
captures the body, and each frame from the second on is a replay. A
capture runs under ``torch.cuda.set_sync_debug_mode("error")``, so any
host read in the body raises. Nothing falls back: a capture or a kernel
build that fails raises.

A block's replay copies the caller's state into the graph's input buffers
and the iteration number into a device scalar (a fill), replays, and
clones the outputs; a frame's replay clones the film. A state the caller
holds is never written.

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
from ..core.sync import no_host_reads
from ..ops.intersect import IntersectAccelerator
from ..ops.sweep import SweepAccelerator
from ..utils.stats import collect, count, spanned

# The accelerators whose routes read nothing on the host under
# no_host_reads.
CAPTURABLE = (SweepAccelerator, WBVHAccelerator, BVHAccelerator,
              ClusterAccelerator, IntersectAccelerator, MXUAccelerator,
              InstancedGeometry, InstancedSpheres)


def kernel_counts() -> dict:
    """Launches so far of each hand-written kernel, by wrapper."""
    from ..ops.bvh_walk import walk_kernel
    from ..ops.intersect import intersect_kernel
    from ..ops.splat import splat_kernel
    from ..ops.sweep import block_entry_kernel, sweep_kernel

    return {"sweep": sweep_kernel.launches,
            "prologue": block_entry_kernel.launches,
            "bvh_walk": walk_kernel.launches,
            "intersect": intersect_kernel.launches,
            "splat": splat_kernel.launches}


def uncapturable(scene):
    """The scene's first accelerator (or instanced geometry) of a kind
    whose route may read the host, or None."""
    for acc in [scene.accel] + list(scene.instanced):
        if acc is not None and not isinstance(acc, CAPTURABLE):
            return acc
    return None


def check_capturable(scene) -> None:
    """NotImplementedError for a scene that :func:`uncapturable` names."""
    acc = uncapturable(scene)
    if acc is not None:
        raise NotImplementedError(
            f"CUDA graphs on the card: {type(acc).__name__} has no route "
            f"known to read nothing on the host, so a graph cannot capture "
            f"it; render without one (SPPM: fused_iterations=False)")


@contextlib.contextmanager
def _sync_errors():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _clone(state):
    """A copy of a dataclass (SPPMState) or NamedTuple (FilmState) of
    tensors."""
    if isinstance(state, tuple):
        return type(state)(*[x.clone() for x in state])
    return type(state)(*[getattr(state, f.name).clone()
                         for f in fields(state)])


def _capture(dev, body):
    """``body()`` captured into a CUDA graph under :func:`_sync_errors` ->
    (the graph, the captured outputs, a record: capture host ms and kernel
    launches per replay by wrapper, the host counters the captured body
    added). The capture's counters go to a RenderStats of its own, not the
    ambient one: a capture runs nothing."""
    t0 = time.perf_counter()
    before = kernel_counts()
    graph = torch.cuda.CUDAGraph()
    with collect() as counted:
        with torch.cuda.graph(graph):
            with _sync_errors():
                out = body()
    torch.cuda.synchronize(dev)
    after = kernel_counts()
    record = dict(capture_ms=(time.perf_counter() - t0) * 1e3,
                  launches={k: after[k] - before[k] for k in after})
    return graph, out, record, counted.as_dict()


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
        body()
        torch.cuda.synchronize(dev)
        warm_ms = (time.perf_counter() - t0) * 1e3
        self.graph, out, rec, _ = _capture(dev, body)
        self.out, self.totals, self.pairs = out
        self.record = dict(n_iters=n_iters, pair_chunks=pair_chunks,
                           warm_ms=warm_ms, **rec)

    @spanned("sppm.replay")
    def replay(self, state, it: int):
        for f in fields(state):
            getattr(self.state, f.name).copy_(getattr(state, f.name))
        self.it.fill_(it)
        self.graph.replay()
        return _clone(self.out), self.totals.clone(), self.pairs.clone()


class _Views:
    """Graphs captured for one scene view at a time: a view other than the
    last one (another scene, light table, accelerator or sweep tables,
    triangle table, camera or sampler, a scene whose version was bumped,
    or changed integrator ``settings``) drops every graph first
    (``drop``). ``captures`` lists each capture's record
    (:func:`_capture`)."""

    def __init__(self):
        self.view = None
        self.captures = []

    def settings(self, integ) -> tuple:
        raise NotImplementedError

    def drop(self) -> None:
        raise NotImplementedError

    def _view(self, integ, scene) -> bool:
        """Whether the view is new (its graphs dropped)."""
        # A refit replaces the sweep's tables in place.
        objects = (scene, scene.lights, scene.accel,
                   getattr(scene.accel, "tables", None), scene.triangles,
                   integ.camera, getattr(integ, "sampler", None))
        settings = self.settings(integ) + (scene._version,)
        if self.view is None or settings != self.view[1] or any(
                a is not b for a, b in zip(objects, self.view[0])):
            self.drop()
            self.view = (objects, settings)
            return True
        return False


class BlockGraphs(_Views):
    """One SPPM integrator's captured blocks, for one scene view at a time
    (:class:`_Views`). A block is captured per block length, pair chunks
    and the instance walks' pair capacities. A capture's record holds its
    block length, pair chunks and warm-up host ms besides (the wrappers
    count launches while the graph is captured, and a replay repeats
    them)."""

    def __init__(self):
        super().__init__()
        self.graphs = {}

    def drop(self) -> None:
        self.graphs.clear()

    def settings(self, integ) -> tuple:
        return (integ.seed, integ.max_depth, integ.n_iterations,
                integ.photons_per_iteration, integ.pixel_chunk,
                integ.pair_chunk)

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


class _Frame:
    """One captured Whitted frame: its per-view inputs, graph and
    outputs."""

    def __init__(self, integ, scene):
        # The graph reads these at their capture addresses: keep them.
        self.scene, self.inputs = scene, integ.frame_inputs(scene.device)

        def body():
            with no_host_reads():
                return integ.frame_body(scene, self.inputs)

        self.graph, out, self.record, self.counted = _capture(
            scene.device, body)
        self.state, self.counts = out

    @spanned("whitted.replay")
    def replay(self):
        self.graph.replay()
        # The host counts the body made at capture, once a frame.
        for name, n in self.counted.items():
            count(name, n)
        return _clone(self.state), self.counts


class FrameGraphs(_Views):
    """One Whitted integrator's captured frame (``frame``), for one scene
    view at a time (:class:`_Views`; the settings: seed, samples per pixel,
    depth, pixel chunk, queue capacity, level caps, material sort).
    Counters: ``frame_graph_captures``, ``frame_graph_replays``."""

    def __init__(self):
        super().__init__()
        self.frame = None

    def drop(self) -> None:
        self.frame = None

    def settings(self, integ) -> tuple:
        caps = integ.level_caps
        return (integ.sampler.seed, integ.sampler.samples_per_pixel,
                integ.max_depth, integ.pixel_chunk, integ.queue_capacity,
                None if caps is None else tuple(caps), integ.sort_materials)

    def run(self, integ, scene):
        """One frame -> (film state, counts int64 [2]: queue drops, useful
        rays). A view's first frame runs the body eagerly; its second
        captures the body, and each from the second on replays it.
        ``counts`` is the graph's own buffer on a replay: read it before
        the next frame."""
        if self._view(integ, scene):
            with no_host_reads():
                return integ.frame_body(
                    scene, integ.frame_inputs(scene.device))
        if self.frame is None:
            self.frame = _Frame(integ, scene)
            self.captures.append(self.frame.record)
            count("frame_graph_captures", 1)
        count("frame_graph_replays", 1)
        return self.frame.replay()
