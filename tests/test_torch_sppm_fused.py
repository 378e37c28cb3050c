"""SPPM's fused blocks in the port (SPPMIntegrator(fused_iterations=True)):
the sync-free body against the stepwise path, piece by piece and whole.

The fused body (``_iterations_body``) is a second route through the
stepwise phases with every shape static: the pair total stays on the
device and a fixed number of pair chunks run, the sweep launches every
chunk, the walks run every depth, the Halton digit loops their full trip
count. Each piece must give the stepwise bits, and so must whole renders
(bit-equal: a fused block is the same arithmetic on the same lanes). On
the CPU the body runs eagerly; on the card a block length's blocks after
its first are replays of a CUDA graph (integrators/fused.py; a stub
stands in for the capture on the CPU; the ``cuda`` test, and
chip_smoke.py phase 14).

Scenes: the shadows scene (spheres and brute-force triangles) at 16^2,
and a soup of 300 matte triangles under a point light (the sweep route,
``sweep_plain`` on the CPU) framed by mesh_heavy's camera. Small
``pair_chunk`` values make blocks with several pair chunks and
overflows; on the CPU the pair sums do not depend on the chunking (the
deterministic scatter adds pairs one after another, in pair order).
"""
import gc
import weakref
from dataclasses import fields

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from trace_tpu_torch.accel import clusters as TC
from trace_tpu_torch.accel import wbvh as TW
from trace_tpu_torch.core import transform as T
from trace_tpu_torch.core.sync import no_host_reads, sync_free
from trace_tpu_torch.integrators import fused as F
from trace_tpu_torch.integrators.sppm import (SPPMIntegrator, SPPMState,
                                              initial_state)
from trace_tpu_torch.lights import lights as TL
from trace_tpu_torch.materials.materials import MatteMaterial
from trace_tpu_torch.models import mesh_heavy as TMH
from trace_tpu_torch.models import spheres as TSph
from trace_tpu_torch.sampler import halton as H
from trace_tpu_torch.sampler import uniform as U
from trace_tpu_torch.scene import SceneBuilder

# pair_chunk 4096: a fused block runs whole pair chunks, and the default
# 2^22 pairs a chunk would cost seconds on the CPU.
SHADOWS_KW = dict(initial_search_radius=0.25, max_depth=4,
                  photons_per_iteration=1024, seed=1, pair_chunk=4096)
SOUP_KW = dict(initial_search_radius=0.6, max_depth=3,
               photons_per_iteration=256, seed=0, pair_chunk=4096)
LIGHT = ([4.0, 8.0, 4.0], (400.0, 400.0, 400.0))
MOTION = T.compose(T.translate([0.15, -0.1, 0.3]), T.rotate_y(20.0))


def _soup_scene(instanced=False):
    """300 triangles over mesh_heavy's terrain square (the soup of
    test_torch_animated.py); ``instanced`` adds four instanced
    tetrahedra."""
    n = 300
    rng = np.random.default_rng(3)
    c = rng.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    c[:, 1] *= 0.1
    e1 = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    verts = np.concatenate([c, c + e1, c + e2], 0)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n],
                   -1)
    b = SceneBuilder()
    mat = b.material(MatteMaterial())
    b.triangle_mesh(T.identity(), idx, verts, mat)
    if instanced:
        tv = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                      np.float32)
        ti = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]],
                      np.uint32)
        b.instanced_mesh(ti, tv, [T.compose(T.translate([x, 0.5, z]),
                                             T.scale(2.0, 2.0, 2.0))
                                  for x, z in ((-3, -3), (3, -3), (-3, 3),
                                               (3, 3))], mat)
    b.light(TL.point_light(T.translate(LIGHT[0]), LIGHT[1]))
    return b.build(device="cpu")


@pytest.fixture(scope="module")
def scenes():
    return {"shadows": TSph.build_scene(device="cpu"),
            "soup": _soup_scene(),
            "instanced": _soup_scene(instanced=True),
            "clusters": TC.attach(_soup_scene(), stage_clusters=4)}


def _integ(name, res=16, filename="unused.png", **kw):
    """An integrator for scene ``name``: shadows, or a soup (soup,
    instanced, clusters)."""
    mod = TSph if name == "shadows" else TMH
    base = SHADOWS_KW if name == "shadows" else SOUP_KW
    return SPPMIntegrator(mod.build_camera(res, filename), device="cpu",
                          **dict(base, **kw))


def _equal(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in fields(SPPMState))


def _iteration_inputs(integ, scene):
    """One stepwise iteration's inputs to the pair pass."""
    dev = scene.device
    pixels = integ._pixel_grid(dev)
    key = U.key(integ.seed, dev)
    cdf, pmf = integ.light_distribution(scene)
    state = initial_state(integ.n_pixels, integ.initial_search_radius, dev)
    _, vp = integ._camera_pass_all(scene, pixels, U.fold_in(key, 1))
    grid = integ._build_grid(vp, state.radius)
    splat = integ._photon_walk_all(scene, 0, cdf, pmf, grid)
    counts = splat["count"]
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    return state, vp, grid, splat, offsets, int(counts.sum())


@pytest.mark.parametrize("spare", [1, 0, -1])
def test_device_total_pair_loop_equals_host_loop(scenes, spare):
    """``spare`` chunks more than the total needs: 1 and 0 give the host
    loop's (phi, M); -1 leaves out the pairs past the chunks, and the
    block's overflow check sees it."""
    scene = scenes["shadows"]
    integ = _integ("shadows", pair_chunk=100)
    state, vp, grid, splat, offsets, total = _iteration_inputs(integ, scene)
    kinds = integ.vp_kinds(scene)
    chunks = -(-total // 100) + spare
    assert total > 300
    args = (offsets, splat, vp, state.radius, grid["sorted_vp"], kinds)
    phi_h, m_h = integ._pair_loop(state.phi, state.m, total, *args)
    phi_d, m_d = integ._pair_loop(state.phi, state.m,
                                  torch.tensor(total), *args, chunks=chunks)
    # The host loop over the pairs the chunks hold: all of them unless
    # the chunks are one short.
    cut = min(total, chunks * 100)
    phi_c, m_c = integ._pair_loop(state.phi, state.m, cut, *args)
    assert torch.equal(phi_d, phi_c) and torch.equal(m_d, m_c)
    assert (cut == total) == (spare >= 0)
    if spare >= 0:
        assert torch.equal(phi_d, phi_h) and torch.equal(m_d, m_h)
    assert phi_d.shape == state.phi.shape and m_d.shape == state.m.shape
    assert int(m_h.sum()) > 0


def test_overflowed_block_reruns_stepwise(scenes):
    """A block whose pairs overflow its chunks runs again stepwise from
    its start state; later blocks take enough chunks."""
    scene = scenes["shadows"]
    ref = _integ("shadows", n_iterations=3).render(scene)
    integ = _integ("shadows", n_iterations=3, pair_chunk=100,
                   fused_iterations=True, fused_block=2)
    calls = []
    step = integ.step
    integ.step = lambda *a, **k: calls.append(a[2]) or step(*a, **k)
    out = integ.render(scene)
    assert _equal(out, ref)
    assert calls == [1, 2]   # the first block, again; the second fitted
    assert integ.fused_pair_chunks * 100 >= int(integ.last_pair_totals.max())
    assert integ.fused_pair_chunks > 1


@pytest.mark.parametrize("live", ["all", "part", "none"])
def test_sync_free_sweep_equals_live_chunks(scenes, live):
    """The sweep accelerator in the sync-free mode launches every chunk:
    the same (hit, t, tri) as launching only the live ones."""
    acc = scenes["soup"].accel
    chunk, acc.ray_chunk = acc.ray_chunk, 64
    try:
        g = torch.Generator().manual_seed(5)
        n = 300
        o = torch.cat([torch.rand(n, 2, generator=g) * 16 - 8,
                       torch.full((n, 1), 5.0)], 1)[:, [0, 2, 1]]
        d = torch.nn.functional.normalize(
            torch.randn(n, 3, generator=g) * 0.2
            + torch.tensor([0.0, -1.0, 0.0]), dim=1)
        t_max = torch.full((n,), float("inf"))
        if live == "part":
            t_max[torch.rand(n, generator=g) < 0.6] = -1.0
        elif live == "none":
            t_max[:] = -1.0
        for any_hit in (False, True):
            acc.skipped_chunks = 0
            ref = acc.intersect(o, d, t_max, any_hit)
            skipped = acc.skipped_chunks
            with no_host_reads():
                assert sync_free()
                out = acc.intersect(o, d, t_max, any_hit)
            assert acc.skipped_chunks == skipped
            assert (skipped > 0) == (live != "all")
            for a, b in zip(ref, out):
                assert torch.equal(a, b)
            assert bool(ref[0].any()) == (live != "none")
    finally:
        acc.ray_chunk = chunk
    assert not sync_free()


@pytest.mark.parametrize("first", [0, 1000, 2 ** 31 - 100, 2 ** 32 - 300])
def test_full_halton_trips_equal_bounded_trips(first):
    """Later digit trips change no lane: the full trip count (the fused
    body's) equals the loop bounded by the largest index."""
    a = torch.arange(first, first + 300, dtype=torch.int64) & 0xFFFFFFFF
    dims = range(27)
    bounded = H.radical_inverses(dims, a, int(a.max()))
    assert torch.equal(H.radical_inverses(dims, a, None), bounded)
    assert H._digits(3, int(a.max())) < H._MAX_DIGITS


def test_block_boundaries_write_frequency_and_resume(scenes, tmp_path):
    """Blocks stop at each write_frequency multiple and at fused_block
    iterations; snapshots at those boundaries; resume is bit-exact."""
    scene = scenes["shadows"]
    ref = _integ("shadows", n_iterations=5).render(scene)
    integ = _integ("shadows", n_iterations=5, fused_iterations=True,
                   fused_block=2, write_frequency=3,
                   filename=str(tmp_path / "f.png"))
    blocks, snaps = [], []
    run, image = integ._fused_block, integ.to_image
    integ._fused_block = lambda sc, st, it, n, *a: (
        blocks.append((it, n)) or run(sc, st, it, n, *a))
    integ.to_image = lambda st, it: snaps.append(it) or image(st, it)
    out = integ.render(scene)
    assert blocks == [(1, 2), (3, 1), (4, 2)] and snaps == [3, 5]
    assert _equal(out, ref) and (tmp_path / "f.png").exists()
    part = integ.render(scene, n_iterations=2)
    assert blocks[3:] == [(1, 2)]
    resumed = integ.render(scene, state=part, start_iteration=3)
    assert blocks[4:] == [(3, 1), (4, 2)]
    assert _equal(resumed, ref)


@pytest.mark.parametrize("cond", ["fused", "stats", "progress",
                                  "checkpoint"])
def test_jax_conditions_send_render_stepwise(scenes, tmp_path, cond):
    """As in the JAX package, stats, progress and a checkpoint path send
    render down the stepwise path (a mesh does too)."""
    from trace_tpu_torch.utils.stats import RenderStats

    integ = _integ("shadows", n_iterations=1, fused_iterations=True,
                   stats=RenderStats() if cond == "stats" else None)
    blocks = []
    run = integ._fused_block
    integ._fused_block = lambda *a: blocks.append(a[2]) or run(*a)
    kw = {"progress": dict(progress=True), "checkpoint": dict(
        checkpoint_path=str(tmp_path / "s.npz"))}.get(cond, {})
    out = integ.render(scenes["shadows"], **kw)
    assert blocks == ([1] if cond == "fused" else [])
    assert _equal(out, _integ("shadows", n_iterations=1).render(
        scenes["shadows"]))


@pytest.mark.parametrize("how", ["geometry", "frames"])
def test_animated_frames_fused_equal_stepwise(scenes, how):
    """render(geometry=, geometry_transform=) and render_frames in fused
    blocks give the stepwise frames."""
    base = scenes["soup"]
    runs = []
    for fused in (False, True):
        integ = _integ("soup", n_iterations=2, fused_iterations=fused,
                       fused_block=1)
        if how == "geometry":
            runs.append(integ.render(base, geometry=base.triangles,
                                     geometry_transform=MOTION))
        else:
            entries = [[TL.point_light(T.translate(
                [0.5 * k, 8.0 + 0.5 * k, 4.0 - k]), (400.0 + 60 * k,) * 3)]
                for k in range(2)]
            runs.append(integ.render_frames(
                base, entries, geometry=base.triangles,
                frame_transforms=[T.translate([0.1 * k, 0.0, 0.2 * k])
                                  for k in range(2)]))
    assert _equal(*runs)
    assert float(runs[0].tau.sum()) > 0


GUARDED = ("__bool__", "item", "tolist", "__int__", "__float__",
           "__index__", "numpy", "cpu")


@pytest.mark.parametrize("name", ["shadows", "soup", "instanced",
                                  "clusters"])
def test_fused_body_reads_no_host(scenes, monkeypatch, name):
    """One fused block with every host read of a tensor (and every
    tensor made from host data) made to raise: the block runs, and gives
    the stepwise state."""
    scene = scenes[name]
    integ = _integ(name, n_iterations=2, fused_iterations=True,
                   fused_block=2)
    dev = scene.device
    pixels, key = integ._pixel_grid(dev), U.key(integ.seed, dev)
    cdf, pmf = integ.light_distribution(scene)
    state = _integ(name, n_iterations=1).render(scene)
    it = torch.full((), 2, dtype=torch.int64)
    args = (scene, state, 1, it, pixels, key, cdf, pmf, 1)
    integ._iterations_body(*args)   # fills the device-constant caches

    def refuse(what):
        def raiser(*a, **k):
            raise AssertionError(f"host read in the fused body: {what}")
        return raiser

    for attr in GUARDED:
        monkeypatch.setattr(torch.Tensor, attr, refuse(attr))
    for fn in ("tensor", "from_numpy"):
        monkeypatch.setattr(torch, fn, refuse(f"torch.{fn}"))
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor", lambda x, *a, **k: (
        as_tensor(x, *a, **k) if isinstance(x, torch.Tensor)
        else refuse("torch.as_tensor of host data")()))
    out, totals, over = integ._iterations_body(*args)
    monkeypatch.undo()
    assert _equal(out, _integ(name, n_iterations=2).render(scene))
    assert totals.shape == (1,) and int(totals[0]) > 0
    # Per instanced geometry, the most candidate pairs of a group.
    assert over.shape == (len(scene.instanced),) and (over > 0).all()


class _ForeignAccelerator:
    """An accelerator the fused module does not know (it wraps the
    soup's sweep)."""

    def __init__(self, inner):
        self.inner = inner

    def intersect(self, o, d, t_max, any_hit):
        return self.inner.intersect(o, d, t_max, any_hit)


def test_card_refuses_scenes_that_read_the_host(scenes):
    """Every accelerator of the package, instanced geometry and the
    clusters traversal included, has a route with no host read, so the
    card captures them; an accelerator of another kind may read the host
    and is refused by its name. A fused block on the instanced and the
    clusters scene gives the stepwise bits."""
    for name in ("soup", "instanced", "clusters"):
        F.check_capturable(scenes[name])
        runs = [_integ(name, n_iterations=1, fused_iterations=f).render(
            scenes[name]) for f in (False, True)]
        assert _equal(*runs)
    assert scenes["instanced"].instanced
    assert isinstance(scenes["clusters"].accel, TC.ClusterAccelerator)
    foreign = scenes["soup"].with_geometry(
        scenes["soup"].triangles, _ForeignAccelerator(scenes["soup"].accel))
    with pytest.raises(NotImplementedError, match="_ForeignAccelerator"):
        F.check_capturable(foreign)


def test_clusters_fused_block_runs_every_stage(scenes):
    """The clusters scene sweeps its clusters in several stages (4
    clusters a stage). Stepwise, a call stops once every lane is done,
    so some calls skip stages; a fused block runs every stage of every
    call, the done lanes against a limit of -inf, and gives the stepwise
    bits."""
    scene = scenes["clusters"]
    stats = scene.accel.stats
    runs = []
    for fused in (False, True):
        stats.clear()
        runs.append(_integ("clusters", n_iterations=1,
                           fused_iterations=fused).render(scene))
        runs.append(dict(stats))
    step, fused = runs[1], runs[3]
    print(f"clusters stages: stepwise {step}, fused {fused}")
    assert step["most_stages"] == fused["most_stages"] > 1
    assert step["stages"] < step["calls"] * step["most_stages"]
    assert fused["stages"] == fused["calls"] * fused["most_stages"]
    assert _equal(runs[0], runs[2])


@pytest.mark.parametrize("first_capacity", [None, 1])
def test_instance_pair_overflow_reruns_stepwise(scenes, first_capacity):
    """The instance walk's pair buffer belongs to the integrator. With no
    capacity the first block takes the walk's bound (no count exceeds
    it), and the buffer is then sized from the block's counts; a
    capacity the candidate pairs overflow (1) sends the block back to
    the stepwise path. Either way the bits are stepwise's, the buffer
    ends at a power of two, the later blocks fit, and the geometry holds
    no setting."""
    scene = scenes["instanced"]
    ref = _integ("instanced", n_iterations=3).render(scene)
    geom = scene.instanced[0]
    integ = _integ("instanced", n_iterations=3, fused_iterations=True,
                   fused_block=1)
    if first_capacity is not None:
        integ.fused_pair_capacity[geom] = first_capacity
    calls = []
    step = integ.step
    integ.step = lambda *a, **k: calls.append(a[2]) or step(*a, **k)
    out = integ.render(scene)
    cap = integ.fused_pair_capacity[geom]
    assert _equal(out, ref)
    reruns = 0 if first_capacity is None else 1
    assert calls == [1] * reruns and integ.fused_reruns == reruns
    assert cap > 1 and cap & (cap - 1) == 0
    assert not hasattr(geom, "pair_capacity")


def test_graph_route_replays_with_a_stub(scenes, monkeypatch):
    """The card's route for fused blocks on the CPU, a stub in place of
    the capture (test_torch_frame_graph.py's): one-iteration blocks of one
    view, the first runs the body eagerly, the second captures it and
    each from the second on replays it. Every block equals the stepwise
    state of its iteration, a held state is not overwritten by the next
    replay, and each replay adds the eager block's counters."""
    from test_torch_frame_graph import _stub_capture, scribble
    from trace_tpu_torch.utils.stats import collect

    scene = scenes["soup"]
    monkeypatch.setattr(F, "_capture", _stub_capture)
    monkeypatch.setattr(F, "on_card", lambda device: True)
    stepwise = _integ("soup")
    integ = _integ("soup", fused_iterations=True, fused_block=1)
    ref, held, counted = [], [], []
    a = b = None
    for it in range(1, 5):
        a = stepwise.render(scene, n_iterations=it, state=a,
                            start_iteration=it)
        with collect() as c:
            b = integ.render(scene, n_iterations=it, state=b,
                             start_iteration=it)
        ref.append(a)
        held.append(b)
        counted.append(c.as_dict())
        assert bool(integ.fused_graphs.graphs) == (it > 1)
    graphs = integ.fused_graphs
    scribble(graphs)
    assert all(_equal(x, y) for x, y in zip(held, ref))
    assert [(r["n_iters"], r["pair_chunks"]) for r in graphs.captures] == [
        (1, 1)]
    eager, *replays = counted
    assert "frame_graph_replays" not in eager and eager["sweep_launches"] > 0
    for i, c in enumerate(replays):
        assert c.pop("frame_graph_captures", 0) == (i == 0)
        assert c.pop("frame_graph_replays") == 1
        assert c == eager


def test_wbvh_scene_fused_blocks_equal_stepwise(scenes):
    """The soup behind the BVH walk (wbvh.attach on a view of the
    scene): its walk reads nothing on the host, so the card may capture
    it, and a fused block gives the stepwise bits."""
    scene = TW.attach(scenes["soup"].with_geometry(scenes["soup"].triangles,
                                                   None))
    assert isinstance(scene.accel, TW.WBVHAccelerator)
    F.check_capturable(scene)
    runs = [_integ("soup", n_iterations=1, photons_per_iteration=2048,
                   fused_iterations=f).render(scene) for f in (False, True)]
    assert _equal(*runs) and float(runs[0].tau.sum()) > 0


def test_fused_settings_and_cost_analysis(scenes):
    integ = _integ("shadows", fused_iterations=True, fused_block=0,
                   fused_unroll=True)
    assert integ.fused_iterations and integ.fused_unroll
    assert integ.fused_block == 1 and integ.fused_pair_chunks == 1
    ca = integ.fused_cost_analysis(scenes["shadows"])
    assert {"flops", "bytes accessed"} <= set(ca)
    assert ca["flops"] > 0 and ca["bytes accessed"] > 0


@pytest.mark.cuda
def test_cuda_fused_blocks_match_stepwise():
    """On the card: fused blocks (eager first blocks and CUDA graph
    replays) against the stepwise path, bit for bit, through the sweep
    kernels; a capture at each block length's second block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    scene = TMH.build_scene(5000, device=dev)
    kw = dict(initial_search_radius=1.0, max_depth=8, n_iterations=3,
              photons_per_iteration=16384, seed=0, device=dev)
    ref = SPPMIntegrator(TMH.build_camera(32, "unused.png"), **kw).render(
        scene)
    for block in (1, 2):
        integ = SPPMIntegrator(TMH.build_camera(32, "unused.png"),
                               fused_iterations=True, fused_block=block, **kw)
        # A block length's first block runs eagerly and its second
        # captures: with fused_block=2 the second render captures.
        for _ in range(2):
            assert _equal(integ.render(scene), ref)
        rec = integ.fused_graphs.captures
        assert [r["n_iters"] for r in rec] == {1: [1], 2: [2, 1]}[block]
        assert all(r["launches"]["sweep"] > 0 for r in rec)
    # No reference cycle runs through the integrator's graphs: they go
    # with its last reference, not at a later collection, which could
    # fall inside another capture and invalidate it.
    ref = weakref.ref(integ)
    gc.disable()
    try:
        del integ
        assert ref() is None
    finally:
        gc.enable()


class _Counter(TorchDispatchMode):
    """Every tensor op's operands and results, in bytes, and its float
    results' elements (an operation or more each)."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        tensors = lambda t: [x for x in tree_leaves(t)
                             if isinstance(x, torch.Tensor)]
        outs = tensors(out)
        self.bytes += sum(x.numel() * x.element_size()
                          for x in tensors((args, kwargs)) + outs)
        self.flops += sum(x.numel() for x in outs if x.is_floating_point())
        return out


PHASES = {"camera": "_camera_pass_all", "grid": "_build_grid",
          "photons": "_photon_walk_all", "pairs": "_pair_loop",
          "update": "_update_pixels"}


@pytest.mark.parametrize("name", ["shadows", "soup"])
def test_cost_analysis_is_below_an_instrumented_block(scenes, name):
    """Each phase's flops and bytes in fused_cost_analysis are at most
    what a fused block's ops on the CPU take and give (every float result
    element, every operand and result byte): the model is a lower bound
    of the replayed work."""
    scene = scenes[name]
    integ = _integ(name, n_iterations=1, fused_iterations=True)
    counts = {}
    for phase, meth in PHASES.items():
        fn = getattr(integ, meth)

        def counted(*a, _fn=fn, _phase=phase, **k):
            with _Counter() as c:
                out = _fn(*a, **k)
            tot = counts.setdefault(_phase, [0, 0])
            tot[0] += c.flops
            tot[1] += c.bytes
            return out

        setattr(integ, meth, counted)
    integ.render(scene)
    cost = integ.fused_cost_analysis(scene, 1)
    assert set(cost["phases"]) == set(PHASES)
    for phase, (flops, nbytes) in counts.items():
        model = cost["phases"][phase]
        print(f"{name} {phase}: model {model}, instrumented flops {flops}, "
              f"bytes {nbytes}")
        assert 0 < model["flops"] <= flops and 0 < model["bytes"] <= nbytes
    if name == "soup":
        # The prologue's box tests of the camera's first depth: every
        # pixel lane against every super box, 24 FP32 operations each.
        boxes = 24 * integ.n_pixels * scene.accel.tables.n_supers
        assert cost["phases"]["camera"]["flops"] > boxes > 0
    assert cost["flops"] == sum(p["flops"] for p in cost["phases"].values())
    assert cost["bytes accessed"] == sum(p["bytes"] for p in
                                         cost["phases"].values())


def test_cost_analysis_scales_with_iterations_and_photons(scenes):
    """JAX's keys; every count linear in the block's iterations, and the
    photon walk's in the photons (multiples of the 32-ray sweep block)."""
    scene = scenes["soup"]
    one = _integ("soup", photons_per_iteration=256).fused_cost_analysis(
        scene)
    three = _integ("soup", photons_per_iteration=256).fused_cost_analysis(
        scene, n_iters=3)
    assert {"flops", "bytes accessed"} <= set(one)
    for k in ("flops", "bytes accessed"):
        assert three[k] == 3 * one[k]
    two = _integ("soup", photons_per_iteration=512).fused_cost_analysis(
        scene)
    for m in ("flops", "bytes"):
        assert two["phases"]["photons"][m] == \
            2 * one["phases"]["photons"][m]
        for p in ("camera", "grid", "update"):
            assert two["phases"][p][m] == one["phases"][p][m]
