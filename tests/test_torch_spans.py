"""The port's spans and counters (utils/stats.py): where the render path
marks its passes, how they nest, what the counters add, and that nothing
is recorded outside ``collect()``."""
import contextlib
import importlib.util
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from trace_tpu_torch.core.sync import no_host_reads
from trace_tpu_torch.integrators.sppm import SPPMIntegrator
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.models import sphere, spheres
from trace_tpu_torch.ops import sweep
from trace_tpu_torch.sampler.uniform import UniformSampler
from trace_tpu_torch.utils.stats import (RenderStats, collect, count, span,
                                         trace_profile)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAY_CHUNK = 128
PIXEL_CHUNK = 100
PASSES = {"closest_hit", "shade", "direct_light", "accumulate", "spawn",
          "camera", "film.splat"}


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_frame_spans", os.path.join(REPO, "scripts",
                                          "torch_frame_spans.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FS = _script()


def _spans(prof):
    # The profiler's raw events: prof.events() would build every aten op's
    # FunctionEvent, seconds for a frame.
    return [(e.name()[3:], e.start_ns() * 1e-3, e.end_ns() * 1e-3)
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("tt.")]


def _sweep_scene():
    scene = spheres.build_scene(device="cpu")
    return sweep.attach(scene, block_rays=32, ray_chunk=RAY_CHUNK)


@pytest.fixture(scope="module")
def frame():
    """A 16^2 Whitted frame of the shadows scene on the sweep, depth 2,
    in chunks of 100 lanes (a padded tail), under the profiler."""
    scene = _sweep_scene()
    cam = spheres.build_camera(resolution=16, filename="unused.png")
    integ = WhittedIntegrator(cam, UniformSampler(1), max_depth=2,
                              pixel_chunk=PIXEL_CHUNK)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with collect() as stats:
            integ.render(scene)
    (x0, y0), (x1, y1) = cam.film.sample_bounds()
    return dict(spans=_spans(prof), counters=stats.as_dict(),
                lanes=(x1 - x0 + 1) * (y1 - y0 + 1), integ=integ,
                lights=int(scene.lights.kind.shape[0]))


def test_every_span_appears_nested(frame):
    spans = frame["spans"]
    parent, _, _ = FS.nesting(spans)
    up = {}
    for i, p in enumerate(parent):
        up.setdefault(spans[i][0], set()).add(
            None if p is None else spans[p][0])
    assert set(up) == PASSES | {"render", "chunk", "intersect",
                                "host_read"}
    assert up["render"] == {None}
    assert up["chunk"] == {"render"}
    for name in PASSES:
        assert up[name] == {"chunk"}, name
    # Closest hits and shadow rays go through the sweep; it reads once a
    # call, and the render reads its two totals at the end, in one read.
    assert up["intersect"] == {"closest_hit", "direct_light"}
    assert up["host_read"] == {"intersect", "render"}
    assert sum(1 for i, p in enumerate(parent) if spans[i][0] == "host_read"
               and spans[p][0] == "render") == 1


def test_host_reads_match_the_frame(frame):
    chunks = -(-frame["lanes"] // PIXEL_CHUNK)
    calls = chunks * 2 * (1 + frame["lights"])   # depth 2, spp 1
    names = [s[0] for s in frame["spans"]]
    assert names.count("intersect") == calls
    assert names.count("host_read") == calls + 1
    assert names.count("chunk") == chunks


def test_counters_match_the_chunking_and_the_sweep(frame):
    c = frame["counters"]
    chunks = -(-frame["lanes"] // PIXEL_CHUNK)
    assert c["chunk_lanes_issued"] == chunks * PIXEL_CHUNK
    assert c["chunk_lanes_valid"] == frame["lanes"]
    assert 0 < c["sweep_lanes_live"] <= c["sweep_lanes_launched"]
    assert c["sweep_lanes_launched"] <= c["sweep_launches"] * RAY_CHUNK
    # The integrator's own counters stay on its own stats object.
    assert "useful_rays" not in c and frame["integ"].stats is None


def test_sweep_reads_once_a_call_and_never_sync_free():
    accel = _sweep_scene().accel
    g = torch.Generator().manual_seed(0)
    n = 3 * RAY_CHUNK + 5
    o = torch.rand((n, 3), generator=g) * 2 - 1
    d = torch.nn.functional.normalize(torch.rand((n, 3), generator=g) - 0.5,
                                      dim=1)
    t_max = torch.where(torch.arange(n) < RAY_CHUNK + 7, 10.0, -1.0)
    runs = {}
    for free in (False, True):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with collect() as stats, \
                    (no_host_reads() if free else contextlib.nullcontext()):
                out = accel.intersect(o, d, t_max, False)
        names = [s[0] for s in _spans(prof)]
        runs[free] = out
        assert names.count("intersect") == 1
        assert names.count("host_read") == (0 if free else 1)
        c = stats.as_dict()
        if free:
            assert "sweep_lanes_live" not in c
            assert c["sweep_launches"] == 4
            assert c["sweep_lanes_launched"] == n
        else:   # two chunks hold live lanes: RAY_CHUNK + 7 of them
            assert c["sweep_launches"] == 2
            assert c["sweep_lanes_launched"] == 2 * RAY_CHUNK
            assert c["sweep_lanes_live"] == RAY_CHUNK + 7
    for a, b in zip(runs[False], runs[True]):
        assert torch.equal(a, b)


def _tiny_frame(**kw):
    scene = spheres.build_scene(device="cpu")
    cam = spheres.build_camera(resolution=4, filename="unused.png")
    return WhittedIntegrator(cam, UniformSampler(1), max_depth=1,
                             **kw), scene


def test_span_outside_collect_makes_no_record_function(monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r})")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    integ, scene = _tiny_frame()
    integ.render(scene)
    assert span("render") is span("chunk")
    with pytest.raises(AssertionError, match="tt.render"):
        with collect():
            integ.render(scene)


def test_count_refuses_a_tensor():
    with pytest.raises(TypeError, match="host number"):
        count("x", torch.tensor(1))
    with collect() as stats:
        with pytest.raises(TypeError, match="host number"):
            count("x", torch.tensor(1))
        count("x", 2)
        count("x", 3)
    count("x", 5)   # outside collect: nothing
    assert stats.as_dict() == {"x": 5.0}


def test_integrator_stats_keep_their_keys():
    own = RenderStats()
    integ, scene = _tiny_frame(stats=own)
    with collect() as ambient:
        integ.render(scene)
    assert set(own.as_dict()) == {"camera_samples", "rays_dispatched",
                                  "render_seconds", "specular_queue_drops",
                                  "useful_rays"}
    assert set(ambient.as_dict()) == {"chunk_lanes_issued",
                                      "chunk_lanes_valid"}


def test_sppm_stepwise_iteration_shows_its_phases():
    scene = sphere.build_scene(device="cpu")
    integ = SPPMIntegrator(sphere.build_camera(6, "unused.png"),
                           initial_search_radius=0.05, max_depth=3,
                           n_iterations=1, photons_per_iteration=200,
                           device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with collect():
            integ.render(scene)
    spans = _spans(prof)
    parent, _, _ = FS.nesting(spans)
    names = [s[0] for s in spans]
    for phase in ("sppm.camera_pass", "sppm.photon_walk", "sppm.update"):
        assert names.count(phase) == 1, phase
    # The pair total is read on the host between the photon walk and the
    # update, outside both.
    top = {spans[i][0] for i, p in enumerate(parent) if p is None}
    assert {"sppm.camera_pass", "sppm.photon_walk", "sppm.update",
            "host_read"} <= top


def test_trace_profile_shows_the_spans_and_counts(tmp_path):
    integ, scene = _tiny_frame()
    with trace_profile(str(tmp_path)) as tp:
        integ.render(scene)
    assert tp.stats.as_dict()["chunk_lanes_issued"] > 0
    with open(tp.path) as f:
        text = f.read()
    assert '"tt.render"' in text and '"tt.film.splat"' in text


def test_span_table_attributes_launches_and_gaps():
    # Two steps of 100 us; in each, render > chunk > intersect > host_read.
    spans, device, launches = [], [], {}
    for s in (0.0, 100.0):
        spans += [("render", s, s + 100), ("chunk", s + 10, s + 90),
                  ("intersect", s + 20, s + 60),
                  ("host_read", s + 50, s + 60)]
        # A kernel launched in intersect, one in chunk after it; the card
        # idles 0-30 (middle 15: chunk), 40-70 (55: host_read), 80-100
        # (90: chunk in step 1, which closes there; render in step 2).
        device += [("sweep", s + 30, s + 40, s + 1),
                   ("mul", s + 70, s + 80, s + 2)]
        launches[s + 1] = s + 25
        launches[s + 2] = s + 65
    device.append(("orphan", 95.0, 96.0, -1))
    # A copy issued by the read, run while the sweep runs: device time,
    # not a kernel.
    device.append(("Memcpy DtoH (Device -> Pageable)", 32.0, 33.0, 3))
    launches[3] = 55.0
    rows, within = FS.span_table(spans, device, launches,
                                 [(0.0, 100.0), (100.0, 200.0)])
    r = rows["intersect"]
    assert r["calls"] == 1 and r["host_ms"] == pytest.approx(0.040)
    assert r["self_ms"] == pytest.approx(0.030)
    assert r["kernels"] == 1 and r["device_ms"] == pytest.approx(0.010)
    assert rows["chunk"]["device_ms"] == pytest.approx(0.010)
    assert rows["chunk"]["self_ms"] == pytest.approx(0.040)
    assert rows["(none)"]["kernels"] == 0.5
    assert rows["host_read"]["kernels"] == 0
    assert rows["host_read"]["device_ms"] == pytest.approx(0.0005)
    assert rows["host_read"]["idle_ms"] == pytest.approx(0.030)
    # The orphan (95-96) splits step 1's tail: 80-95 in chunk, 96-100
    # in render.
    assert rows["chunk"]["idle_ms"] == pytest.approx((30 + 15 + 30) / 2e3)
    assert rows["render"]["idle_ms"] == pytest.approx((4 + 20) / 2e3)
    # Within a span: every device event launched below it, copies too.
    assert within["intersect"] == pytest.approx(0.0105)
    assert within["render"] == pytest.approx(0.0205)
    read = FS.readings(rows, within, {"chunk_lanes_issued": 4.0,
                                      "chunk_lanes_valid": 3.0}, 2)
    assert read["chunk_lane_use_pct"] == 75.0
    assert read["host_reads_per_step"] == 1
    assert read["host_read_wait_ms_per_step"] == pytest.approx(0.010)
    assert read["sweep_lane_use_pct"] is None
    assert read["film_splat_gathers_per_step"] is None
    assert FS.readings(rows, within, {"film_splat_gathers": 4.0}, 2)[
        "film_splat_gathers_per_step"] == 2.0


@pytest.fixture(scope="module")
def path_frame():
    """An 8^2 path-traced frame of the Cornell box (2 spp, depth 4, one
    chunk), under the profiler inside collect(), and the same frame with
    spans off."""
    from trace_tpu_torch.integrators.path import PathIntegrator
    from trace_tpu_torch.models import cornell

    scene = cornell.build_scene(device="cpu")
    cam = cornell.build_camera(8, "unused.png")

    def integ():
        return PathIntegrator(cam, UniformSampler(2, seed=4), max_depth=4)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with collect() as stats:
            on = integ().render(scene)
    off = integ().render(scene)
    (x0, y0), (x1, y1) = cam.film.sample_bounds()
    return dict(spans=_spans(prof), counters=stats.as_dict(), on=on,
                off=off, lanes=(x1 - x0 + 1) * (y1 - y0 + 1), spp=2,
                depth=4)


def test_path_spans_nest_inside_collect(path_frame):
    spans = path_frame["spans"]
    parent, _, _ = FS.nesting(spans)
    up = {}
    for i, p in enumerate(parent):
        up.setdefault(spans[i][0], set()).add(
            None if p is None else spans[p][0])
    assert set(up) == {"render", "chunk", "camera", "closest_hit", "shade",
                       "direct_light", "mis_bsdf", "spawn", "film.splat",
                       "host_read"}
    for name in ("camera", "closest_hit", "shade", "direct_light", "spawn",
                 "film.splat"):
        assert up[name] == {"chunk"}, name
    # The BSDF-sampling leg runs inside next-event estimation.
    assert up["mis_bsdf"] == {"direct_light"}
    names = [s[0] for s in spans]
    bounces = path_frame["spp"] * path_frame["depth"]
    for name in ("closest_hit", "shade", "direct_light", "mis_bsdf",
                 "spawn"):
        assert names.count(name) == bounces, name


def test_path_counters_are_the_lanes(path_frame):
    c = path_frame["counters"]
    lanes = path_frame["lanes"] * path_frame["spp"] * path_frame["depth"]
    assert c["path_bounce_lanes"] == lanes
    assert c["path_mis_lanes"] == lanes
    assert c["chunk_lanes_issued"] == path_frame["lanes"]
    # The integrator's own self-hit count is not the ambient stats'.
    assert "path_self_hits" not in c


def test_path_film_is_bit_equal_with_spans_on_and_off(path_frame):
    on, off = path_frame["on"], path_frame["off"]
    assert torch.equal(on.xyz, off.xyz)
    assert torch.equal(on.weight_sum, off.weight_sum)


def test_path_self_hits_read_once_under_stats():
    from trace_tpu_torch.integrators.path import PathIntegrator
    from trace_tpu_torch.models import cornell

    scene = cornell.build_scene(device="cpu")
    own = RenderStats()
    integ = PathIntegrator(cornell.build_camera(6, "unused.png"),
                           UniformSampler(1, seed=2), max_depth=3,
                           stats=own)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with collect():
            integ.render(scene)
    assert own.as_dict()["path_self_hits"] == 0
    # The render's counts and the self hits: one read each.
    names = [s[0] for s in _spans(prof)]
    assert names.count("host_read") == 2
