"""CUDA graphs of the render path on the card: SPPM's fused blocks and the
Whitted and path-traced frames, kept by one cache (:class:`Graphs`).

The card's counterpart of the JAX package's one-dispatch iteration block
(trace_tpu/integrators/sppm.py::_iterations_fused) is a CUDA graph of
``SPPMIntegrator._iterations_body``, one per block length, pair chunks
and instance walks' pair capacities; a Whitted or path-traced frame
(``SamplerIntegrator.frame_body``: the film zeroed, every chunk's sample
passes and splats) is one graph. Both are kept per scene view and follow
one policy, which pays only where a body runs again: a key's first call
in a view runs the body eagerly on the current stream under
``no_host_reads`` (the warm-up: modules load and the caches of the path
-- device constants, a view's area-light tables -- fill outside a
capture, and the caller gets its result), its second call captures the
body, and each call from the second on replays it. A render of a view
that runs each key once captures nothing. A capture runs under
``torch.cuda.set_sync_debug_mode("error")``, so any host read in the body
raises. Nothing falls back: a capture or a kernel build that fails
raises.

A replay copies the caller's inputs into the graph's input buffers (a
block's state and its first iteration, a device scalar; a frame has
none), replays, clones the outputs and adds again the host counters its
capture made. A state the caller holds is never written.

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
from dataclasses import fields, is_dataclass

import torch

from ..accel.bvh import BVHAccelerator
from ..accel.clusters import ClusterAccelerator
from ..accel.instances import InstancedGeometry, InstancedSpheres
from ..accel.mxu import MXUAccelerator
from ..accel.wbvh import WBVHAccelerator
from ..core.sync import no_host_reads
from ..ops.intersect import IntersectAccelerator
from ..ops.sweep import SweepAccelerator
from ..utils.stats import collect, count, span

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
    from ..ops.threefry import threefry_kernel

    return {"sweep": sweep_kernel.launches,
            "prologue": block_entry_kernel.launches,
            "bvh_walk": walk_kernel.launches,
            "intersect": intersect_kernel.launches,
            "splat": splat_kernel.launches,
            "threefry": threefry_kernel.launches}


def on_card(device) -> bool:
    """Whether bodies on ``device`` run through graphs: the card's."""
    return torch.device(device).type == "cuda"


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


def _map(fn, x, *ys):
    """``fn`` on each tensor of ``x`` (a tensor, or a tuple, NamedTuple or
    dataclass of them, such as SPPMState and FilmState) and the tensors
    in the same places of ``ys``, in ``x``'s structure."""
    if torch.is_tensor(x):
        return fn(x, *ys)
    if is_dataclass(x):
        return type(x)(*[_map(fn, *[getattr(z, f.name) for z in (x, *ys)])
                         for f in fields(x)])
    out = [_map(fn, *zs) for zs in zip(x, *ys)]
    return type(x)(*out) if hasattr(x, "_fields") else tuple(out)


def _capture(dev, body):
    """``body()`` captured into a CUDA graph under :func:`_sync_errors`
    and ``no_host_reads`` -> (the graph, the captured outputs, a record:
    capture host ms and kernel launches per replay by wrapper, the host
    counters the captured body added). The capture's counters go to a
    RenderStats of its own, not the ambient one: a capture runs nothing."""
    t0 = time.perf_counter()
    before = kernel_counts()
    graph = torch.cuda.CUDAGraph()
    with collect() as counted:
        with torch.cuda.graph(graph):
            with _sync_errors(), no_host_reads():
                out = body()
    torch.cuda.synchronize(dev)
    after = kernel_counts()
    record = dict(capture_ms=(time.perf_counter() - t0) * 1e3,
                  launches={k: after[k] - before[k] for k in after})
    return graph, out, record, counted.as_dict()


class _Graph:
    """One captured body: its input buffers, graph and outputs, and what
    else it reads (``made``). It holds no reference to the integrator:
    a cycle would leave a dropped graph to the garbage collector, which
    may free it during another capture and so invalidate that one."""

    def __init__(self, dev, body, made, inputs):
        # The graph reads these at their capture addresses: keep them.
        self.made = made
        self.inputs = _map(torch.clone, inputs)
        self.graph, self.out, self.record, self.counted = _capture(
            dev, lambda: body(made, *self.inputs))

    def replay(self, *inputs):
        """``inputs`` (the capture's structure) -> a copy of the outputs."""
        _map(torch.Tensor.copy_, self.inputs, inputs)
        self.graph.replay()
        # The host counts the body made at capture, once a replay.
        for name, n in self.counted.items():
            count(name, n)
        return _map(torch.clone, self.out)


class Graphs:
    """One integrator's captured bodies, for one scene view at a time: a
    view other than the last one (another scene, light table, accelerator
    or sweep tables, triangle table, camera or sampler, a scene whose
    version was bumped, or other ``integ.graph_settings()``) drops every
    graph first. Within a view a body is kept by key, under the module
    docstring's policy. ``captures`` lists each capture's record
    (:func:`_capture`, with the caller's fields). ``name``: the span of a
    replay. Counters: ``frame_graph_captures``, ``frame_graph_replays``."""

    def __init__(self, name: str):
        self.name = name
        self.view = None
        self.eager = set()   # the keys whose first call ran eagerly
        self.graphs = {}
        self.captures = []

    def _view(self, integ, scene) -> None:
        """Drop every graph when the view is not the last one."""
        # A refit replaces the sweep's tables in place.
        objects = (scene, scene.lights, scene.accel,
                   getattr(scene.accel, "tables", None), scene.triangles,
                   integ.camera, getattr(integ, "sampler", None))
        settings = integ.graph_settings() + (scene._version,)
        if self.view is None or settings != self.view[1] or any(
                a is not b for a, b in zip(objects, self.view[0])):
            self.eager.clear()
            self.graphs.clear()
            self.view = (objects, settings)

    def run(self, integ, scene, key, body, make, inputs=(), **record):
        """``body(make(), *inputs)`` -> the body's outputs, by the policy
        (module docstring): the key's first call in the view runs the
        body, each later one replays the graph its second captured.
        ``make()``: what the body reads besides its ``inputs`` (tensors),
        made outside any graph for the eager run and the capture, and
        kept with the graph. ``record``: fields for the capture's
        record."""
        check_capturable(scene)
        self._view(integ, scene)
        graph = self.graphs.get(key)
        if graph is None and key not in self.eager:
            self.eager.add(key)
            with no_host_reads():
                return body(make(), *inputs)
        if graph is None:
            graph = self.graphs[key] = _Graph(scene.device, body, make(),
                                              inputs)
            self.captures.append(dict(record, **graph.record))
            count("frame_graph_captures", 1)
        count("frame_graph_replays", 1)
        with span(self.name):
            return graph.replay(*inputs)
