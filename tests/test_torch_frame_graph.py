"""The Whitted and the path-traced frame as one CUDA graph
(integrators/fused.py::Graphs, SamplerIntegrator.frame_inputs /
frame_body / replays).

On the card a Whitted or path-traced frame is a replay of the view's
graph of ``frame_body``, captured under ``no_host_reads``. The body's
sync-free route must give the eager frame's bits (film and counts) and
read nothing on the host; the view key must drop the graph when the view
or a setting changes (for SPPM's fused blocks too); every other call (the
CPU, animated geometry, ``stats``, instanced scenes, ``frame_graph``
False, an accelerator that may read the host) takes the eager route. A
view's first frame runs the body eagerly and its second captures. On the
CPU the graph's plumbing (captures, replays, counters, clones) runs with
a stub in place of the capture; the ``cuda`` tests replay real graphs on
the card, and check that no reference cycle keeps an integrator's graphs
alive.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import chip_smoke as CS
from trace_tpu_torch.core import transform as T
from trace_tpu_torch.core.sync import no_host_reads
from trace_tpu_torch.integrators import fused as F
from trace_tpu_torch.integrators.path import PathIntegrator
from trace_tpu_torch.integrators.sppm import SPPMIntegrator
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.lights import lights as TL
from trace_tpu_torch.materials.materials import MatteMaterial
from trace_tpu_torch.models import cornell as TCor
from trace_tpu_torch.models import env_studio as TEnv
from trace_tpu_torch.models import mesh_heavy as TMH
from trace_tpu_torch.models import spheres as TSph
from trace_tpu_torch.ops import sweep
from trace_tpu_torch.sampler.stratified import StratifiedSampler
from trace_tpu_torch.sampler.uniform import UniformSampler
from trace_tpu_torch.scene import SceneBuilder
from trace_tpu_torch.utils.stats import RenderStats, collect

GUARDED = ("__bool__", "item", "tolist", "__int__", "__float__",
           "__index__", "numpy", "cpu")


def _instanced_scene():
    """Two triangles under a point light, and four instanced
    tetrahedra."""
    b = SceneBuilder()
    mat = b.material(MatteMaterial())
    verts = np.array([[-8, 0, -8], [8, 0, -8], [8, 0, 8], [-8, 0, 8]],
                     np.float32)
    b.triangle_mesh(T.identity(), np.array([[0, 2, 1], [0, 3, 2]]), verts,
                    mat)
    tv = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    ti = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.uint32)
    b.instanced_mesh(ti, tv, [T.translate([x, 0.5, z])
                              for x, z in ((-3, -3), (3, -3), (-3, 3),
                                           (3, 3))], mat)
    b.light(TL.point_light(T.translate([4.0, 8.0, 4.0]),
                           (400.0, 400.0, 400.0)))
    return b.build(device="cpu")


@pytest.fixture(scope="module")
def scenes():
    # The mesh in ray chunks of 64: a 128-lane call launches two, and the
    # eager route skips those with no live lane.
    mesh = sweep.attach(TMH.build_scene(5000, device="cpu"), block_rays=32,
                        ray_chunk=64)
    dryrun = CS.dryrun_builder(CS.port_modules(), textured=True)
    return {"mesh": mesh, "shadows": TSph.build_scene(device="cpu"),
            "instanced": _instanced_scene(),
            "env": TEnv.build_scene(device="cpu"),
            "cornell": TCor.build_scene(device="cpu"),
            "textured": dryrun.build(device="cpu")}


def _dryrun_camera(res, filename):
    return CS.dryrun_camera(CS.port_modules(), res, filename)


# name: (scene, camera maker, integrator keywords). "mesh": the sweep,
# three chunks of 128 lanes (a padded tail) through the scatter; "sorted":
# the same with each level in material order; "shadows": the brute-force
# grid, one chunk through the stencil, four strata; "drops": level caps
# too small for the children, in chunks; "env": an environment light;
# "textured": six lights of four kinds and an image texture; "path": the
# path tracer on the Cornell box (an area light, so the MIS leg), 2 spp,
# Russian roulette from the fourth bounce.
CASES = {
    "mesh": ("mesh", TMH.build_camera, dict(max_depth=2, pixel_chunk=128)),
    "sorted": ("mesh", TMH.build_camera, dict(max_depth=2, pixel_chunk=128,
                                             sort_materials=True)),
    "shadows": ("shadows", TSph.build_camera, dict(max_depth=5,
                                                   strata=True)),
    "drops": ("shadows", TSph.build_camera, dict(max_depth=5,
                                                 pixel_chunk=100,
                                                 level_caps=(8,))),
    "env": ("env", TEnv.build_camera, dict(max_depth=3, pixel_chunk=128)),
    "textured": ("textured", _dryrun_camera, dict(max_depth=2)),
    "path": ("cornell", TCor.build_camera, dict(max_depth=5, rr_depth=3,
                                                spp=2, path=True)),
}


def _integ(case, res=16, **over):
    _, camera, kw = CASES[case]
    kw = dict(kw, **over)
    spp = kw.pop("spp", 1)
    sampler = (StratifiedSampler(2, 2, seed=3) if kw.pop("strata", False)
               else UniformSampler(spp, seed=1))
    cls = PathIntegrator if kw.pop("path", False) else WhittedIntegrator
    eager = not kw.pop("frame_graph", True)
    integ = cls(camera(res, "unused.png"), sampler, **kw)
    if eager:
        integ.frame_graph = False
    return integ


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _sync_free(integ, scene):
    with no_host_reads():
        return integ.frame_body(scene, integ.frame_inputs(scene.device))


@pytest.mark.parametrize("case", list(CASES))
def test_sync_free_body_equals_eager_frame(scenes, case):
    scene = scenes[CASES[case][0]]
    integ = _integ(case)
    ref = integ.render(scene)
    drops, useful = integ.last_queue_drops, integ.last_useful_rays
    state, counts = _sync_free(integ, scene)
    assert _equal(state, ref)
    assert counts.dtype == torch.int64
    assert counts.tolist() == [drops, useful]
    assert useful > 0 and float(ref.weight_sum.sum()) > 0
    assert (drops > 0) == (case == "drops")


@pytest.mark.parametrize("case", list(CASES))
def test_frame_body_reads_no_host(scenes, monkeypatch, case):
    """The body under no_host_reads with every host read of a tensor (and
    every tensor made from host data) made to raise: it runs, and gives
    the eager frame."""
    scene = scenes[CASES[case][0]]
    integ = _integ(case)
    ref = integ.render(scene)
    inputs = integ.frame_inputs(scene.device)

    def refuse(what):
        def raiser(*a, **k):
            raise AssertionError(f"host read in the frame body: {what}")
        return raiser

    for attr in GUARDED:
        monkeypatch.setattr(torch.Tensor, attr, refuse(attr))
    for fn in ("tensor", "from_numpy"):
        monkeypatch.setattr(torch, fn, refuse(f"torch.{fn}"))
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor", lambda x, *a, **k: (
        as_tensor(x, *a, **k) if isinstance(x, torch.Tensor)
        else refuse("torch.as_tensor of host data")()))
    with no_host_reads():
        state, counts = integ.frame_body(scene, inputs)
    monkeypatch.undo()
    assert _equal(state, ref)
    assert counts.tolist() == [integ.last_queue_drops,
                               integ.last_useful_rays]


class _ForeignAccelerator:
    """An accelerator the fused module does not know."""

    def __init__(self, inner):
        self.inner = inner

    def intersect(self, o, d, t_max, any_hit):
        return self.inner.intersect(o, d, t_max, any_hit)


class _OnCard:
    """A scene that says it is on the card: only ``replays`` reads it."""

    def __init__(self, scene):
        self.scene = scene
        self.device = torch.device("cuda")

    def __getattr__(self, name):
        return getattr(self.scene, name)


def test_eager_reasons(scenes):
    """Each rule keeps a frame eager on its own: on the card (a stand-in
    that says so) with none of them, the frame takes the graph; each
    rule alone, and the CPU, keeps it eager."""
    mesh, inst = scenes["mesh"], scenes["instanced"]
    card = _OnCard(mesh)
    integ = _integ("mesh")
    assert integ.frame_graph
    assert integ.replays(card)
    assert not integ.replays(mesh)
    assert not integ.replays(card, geometry=mesh.triangles)
    assert not integ.replays(card, geometry_accel=mesh.accel)
    assert not integ.replays(card, geometry_transform=T.identity())
    assert not _integ("mesh", stats=RenderStats()).replays(card)
    assert not integ.replays(_OnCard(inst))
    foreign = mesh.with_geometry(mesh.triangles,
                                 _ForeignAccelerator(mesh.accel))
    assert not integ.replays(_OnCard(foreign))
    assert not _integ("mesh", frame_graph=False).replays(card)
    path = PathIntegrator(TMH.build_camera(16, "unused.png"),
                          UniformSampler(1), max_depth=2)
    assert path.frame_graph
    assert path.replays(card)
    assert not _integ("path", stats=RenderStats()).replays(card)
    assert not _integ("path", frame_graph=False).replays(card)


def test_cpu_and_path_renders_stay_eager(scenes):
    """On the CPU the default Whitted frame is the eager frame of
    ``frame_graph=False``, and neither the Whitted nor the path integrator
    (which opts in on the card) makes a frame graph."""
    scene = scenes["shadows"]
    a, b = _integ("drops"), _integ("drops", frame_graph=False)
    assert _equal(a.render(scene), b.render(scene))
    assert a.last_queue_drops == b.last_queue_drops > 0
    path = PathIntegrator(TSph.build_camera(8, "unused.png"),
                          UniformSampler(1), max_depth=2)
    path.render(scene)
    assert a.frame_graphs is None and path.frame_graphs is None


# Per integrator, the settings its graphs are kept under, each with
# another value.
VIEW_SETTINGS = {
    "whitted": (("max_depth", 3), ("pixel_chunk", 64),
                ("queue_capacity", 500), ("level_caps", (9,)),
                ("sort_materials", True)),
    "sppm": (("seed", 2), ("max_depth", 3), ("n_iterations", 5),
             ("photons_per_iteration", 512), ("pixel_chunk", 64),
             ("pair_chunk", 2048)),
    "path": (("max_depth", 4), ("pixel_chunk", 64), ("rr_depth", 1)),
}


@pytest.mark.parametrize("kind", ["whitted", "sppm", "path"])
def test_view_key_drops_the_graph(scenes, kind):
    """Graphs keys a view on its objects and the integrator's
    ``graph_settings``, for the Whitted and path frames and SPPM's blocks
    alike: the same view keeps its graphs; a bumped version
    (Scene.bump_version), a new camera or sampler, each changed setting
    and another scene drop them, and the keys that ran eagerly with
    them."""
    scene = scenes["shadows"].with_geometry(scenes["shadows"].triangles,
                                            scenes["shadows"].accel)
    integ = (SPPMIntegrator(TSph.build_camera(16, "unused.png"),
                            device="cpu") if kind == "sppm"
             else _integ("drops" if kind == "whitted" else kind))
    graphs = F.Graphs("test.replay")

    def kept():
        graphs._view(integ, scene)
        out = bool(graphs.graphs)
        assert out == bool(graphs.eager)
        graphs.eager.add("key")
        graphs.graphs["key"] = "captured"
        return out

    assert not kept()
    assert kept()
    version = scene._version
    scene.bump_version()
    assert scene._version == version + 1
    assert not kept()
    integ.camera = TSph.build_camera(16, "unused.png")
    assert not kept()
    if kind != "sppm":
        integ.sampler = UniformSampler(1, seed=1)
        assert not kept()
    assert kept()
    for name, value in VIEW_SETTINGS[kind]:
        setattr(integ, name, value)
        assert not kept(), name
        assert kept(), name
    if kind != "sppm":
        integ.sampler.seed = 2
        assert not kept()
        integ.sampler.samples_per_pixel = 2
        assert not kept()
        assert kept()
    graphs._view(integ, scenes["mesh"])
    assert not graphs.graphs and not graphs.eager


class _StubGraph:
    """A CUDA graph's stand-in on the CPU: a replay runs the body again
    and writes its outputs into the captured ones."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        # A replay runs no Python: its counts are apart.
        with collect(), no_host_reads():
            new = self.body()
        F._map(torch.Tensor.copy_, self.out, new)


def _stub_capture(dev, body):
    with collect() as counted, no_host_reads():
        out = body()
    rec = dict(capture_ms=0.0, launches={})
    return _StubGraph(body, out), out, rec, counted.as_dict()


def scribble(graphs):
    """Overwrite every graph's own output buffers, as the next replay
    would: the states handed out must not change."""
    for graph in graphs.graphs.values():
        F._map(lambda x: x.fill_(-1), graph.out)


def test_graph_route_replays_with_a_stub(scenes, monkeypatch):
    """The graph route's plumbing on the CPU, a stub in place of the
    capture: the first frame runs the body eagerly, the second captures
    and each from the second on is a replay; every frame equals the eager
    one, a held state is not
    overwritten by the next replay, the counts and per-frame counters are
    the eager frame's, and a new view captures again."""
    scene = scenes["mesh"]
    monkeypatch.setattr(F, "_capture", _stub_capture)
    eager = _integ("mesh", frame_graph=False)
    with collect() as want:
        ref = eager.render(scene)
    integ = _integ("mesh")
    monkeypatch.setattr(integ, "replays", lambda *a, **k: True)
    held = []
    with collect() as got:
        for _ in range(3):
            held.append(integ.render(scene))
            assert (integ.last_queue_drops, integ.last_useful_rays) == (
                eager.last_queue_drops, eager.last_useful_rays)
    scribble(integ.frame_graphs)
    assert all(_equal(s, ref) for s in held)
    c, w = got.as_dict(), want.as_dict()
    assert c["frame_graph_captures"] == 1 and c["frame_graph_replays"] == 2
    for name in ("chunk_lanes_issued", "chunk_lanes_valid"):
        assert c[name] == 3 * w[name], name
    # Sync-free, the sweep launches every chunk, on every frame alike.
    assert c["sweep_launches"] % 3 == 0
    assert c["sweep_launches"] // 3 > w["sweep_launches"]
    assert c["sweep_lanes_launched"] % 3 == 0
    assert "sweep_lanes_live" not in c
    graphs = integ.frame_graphs
    assert len(graphs.captures) == 1
    integ.camera = TMH.build_camera(16, "unused.png")
    with collect() as again:
        integ.render(scene)
        assert not graphs.graphs   # a new view: its first frame eager
        integ.render(scene)
    c = again.as_dict()
    assert c["frame_graph_captures"] == 1 and c["frame_graph_replays"] == 1
    assert len(graphs.captures) == 2


def test_path_graph_route_replays_with_a_stub(scenes, monkeypatch):
    """The path tracer's frames on the graph route, a stub in place of
    the capture (as above): the first frame eager, the second captures,
    two replays, each frame and its counts equal to an eager instance's
    (``frame_graph`` False), a held state not overwritten, and the
    replays spanned ``path.replay``."""
    scene = scenes["cornell"]
    monkeypatch.setattr(F, "_capture", _stub_capture)
    eager = _integ("path", frame_graph=False)
    with collect() as want:
        ref = eager.render(scene)
    assert eager.frame_graphs is None
    integ = _integ("path")
    monkeypatch.setattr(integ, "replays", lambda *a, **k: True)
    held = []
    with collect() as got:
        for _ in range(3):
            held.append(integ.render(scene))
            assert (integ.last_queue_drops, integ.last_useful_rays) == (
                eager.last_queue_drops, eager.last_useful_rays)
    scribble(integ.frame_graphs)
    assert all(_equal(s, ref) for s in held)
    assert integ.frame_graphs.name == "path.replay"
    c, w = got.as_dict(), want.as_dict()
    assert c["frame_graph_captures"] == 1 and c["frame_graph_replays"] == 2
    for name in ("path_bounce_lanes", "path_mis_lanes", "chunk_lanes_issued"):
        assert c[name] == 3 * w[name], name


@pytest.mark.cuda
def test_cuda_frame_graph_replays_equal_eager_frames():
    """On the card, ``mesh_heavy`` (1M triangles) at 256^2: three replays
    of the frame graph, each bit-equal to the eager frame, a held state
    not overwritten by the next replay, the counts equal, and
    ``frame_graph_replays`` every frame but the view's first (which runs
    the body eagerly and captures nothing)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    scene = TMH.build_scene(device=dev)

    def integ(graph):
        return WhittedIntegrator(TMH.build_camera(256, "unused.png"),
                                 UniformSampler(1, seed=0), max_depth=2,
                                 frame_graph=graph)

    eager = integ(False)
    ref = eager.render(scene)
    graphed = integ(True)
    assert graphed.replays(scene)
    held = []
    with collect() as stats:
        for i in range(4):
            held.append(graphed.render(scene))
            assert ("frame" in graphed.frame_graphs.graphs) == (i > 0)
            assert (graphed.last_queue_drops, graphed.last_useful_rays) == (
                eager.last_queue_drops, eager.last_useful_rays)
    scribble(graphed.frame_graphs)
    torch.cuda.synchronize()
    assert all(_equal(s, ref) for s in held)
    c = stats.as_dict()
    assert c["frame_graph_captures"] == 1 and c["frame_graph_replays"] == 3
    rec = graphed.frame_graphs.captures
    print(f"frame graph capture: {rec}")
    assert len(rec) == 1 and rec[0]["launches"]["sweep"] > 0
    # No reference cycle runs through the integrator's graphs: they go
    # with its last reference, not at a later collection, which could
    # fall inside another capture and invalidate it.
    ref = weakref.ref(graphed)
    gc.disable()
    try:
        del graphed
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.cuda
def test_cuda_path_frame_graph_replays_equal_eager_frames():
    """On the card, the Cornell box at 128^2, 4 spp, depth 5 (roulette
    from the fourth bounce): three replays of the path tracer's frame
    graph, each bit-equal to the eager frame of an instance whose
    ``frame_graph`` is False, a held state not overwritten by the next
    replay, the counts equal, one capture and three replays (the view's
    first frame runs the body eagerly), and no reference cycle keeping
    the graphs alive."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = TCor.build_scene(device="cuda")

    def integ():
        return PathIntegrator(TCor.build_camera(128, "unused.png"),
                              UniformSampler(4, seed=5), max_depth=5,
                              rr_depth=3)

    eager = integ()
    eager.frame_graph = False
    ref = eager.render(scene)
    assert eager.frame_graphs is None
    graphed = integ()
    assert graphed.replays(scene)
    held = []
    with collect() as stats:
        for i in range(4):
            held.append(graphed.render(scene))
            assert ("frame" in graphed.frame_graphs.graphs) == (i > 0)
            assert (graphed.last_queue_drops, graphed.last_useful_rays) == (
                eager.last_queue_drops, eager.last_useful_rays)
    scribble(graphed.frame_graphs)
    torch.cuda.synchronize()
    assert all(_equal(s, ref) for s in held)
    assert float(ref.weight_sum.sum()) > 0 and eager.last_useful_rays > 0
    c = stats.as_dict()
    assert c["frame_graph_captures"] == 1 and c["frame_graph_replays"] == 3
    rec = graphed.frame_graphs.captures
    print(f"path frame graph capture: {rec}")
    assert len(rec) == 1 and rec[0]["launches"]["threefry"] > 0
    ref = weakref.ref(graphed)
    gc.disable()
    try:
        del graphed
        assert ref() is None
    finally:
        gc.enable()
