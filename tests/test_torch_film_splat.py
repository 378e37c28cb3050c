"""The film's gather splat (ops/splat.py, csrc/splat.cu) and its route.

On the card the render loop's chunk splats (``Film.add_samples`` with
``lanes``, a chunk's range of the sample grid) take one launch of the
gather kernel: one thread a film pixel, adding the chunk's valid lanes
that cover it in ascending lane order, the order of the CPU's
deterministic scatter. Every other splat keeps the scatter. On the CPU the
kernel's plain twin (``splat_plain``) must equal the scatter bit for bit
at every case, and the render loop must hand each chunk its range; the
``cuda`` tests hold the kernel bit-equal to the lane-order serial
reference (the card's own footprint entries through the CPU's
deterministic ``index_put_``), within float32 rounding of the card's
scatter, and bit-equal across a CUDA graph's capture and replay.

Padded lanes reach the twin and the kernel with a NaN position and an
infinite radiance: neither may read them.
"""
import os

import numpy as np
import pytest
import torch

from trace_tpu_torch.core import spectrum as spec
from trace_tpu_torch.core.math import scatter_add
from trace_tpu_torch.film import film as FM
from trace_tpu_torch.film import filters as FL
from trace_tpu_torch.film.film import Film, FilmState
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.models import spheres as TSph
from trace_tpu_torch.ops import splat as S
from trace_tpu_torch.parallel.render import render_share
from trace_tpu_torch.sampler.uniform import UniformSampler
from trace_tpu_torch.utils.stats import collect

FULL = ((0.0, 0.0), (1.0, 1.0))
FILTERS = {"box": FL.BoxFilter, "triangle": FL.TriangleFilter,
           "gaussian": FL.GaussianFilter, "lanczos": FL.LanczosSincFilter}
# Radii whose footprint is 2, 4 and 6 pixels an axis (floor(2r) + 2).
RADII = {2: 0.4, 4: 1.0, 6: 2.0}

# name: (resolution, crop, filter, samples per pixel, lanes a chunk; None:
# the grid's lanes less one, a one-lane tail). "cell": the benchmark
# cell's 256^2 frame, 66,564 lanes in two chunks of 65,536.
CASES = {
    "cell": ((256, 256), FULL, FL.LanczosSincFilter((1.0, 1.0), 3.0), 1,
             1 << 16),
    "odd_crop": ((45, 37), ((0.1, 0.2), (0.8, 0.9)),
                 FL.LanczosSincFilter((1.0, 1.0), 3.0), 1, 300),
    "spp4": ((40, 30), FULL, FL.LanczosSincFilter((1.0, 1.0), 3.0), 4,
             500),
    "tail1": ((40, 30), FULL, FL.LanczosSincFilter((1.0, 1.0), 3.0), 1,
              None),
}
CASES.update({f"{name}_fp{fp}": ((32, 24), FULL, cls((r, r)), 1, 300)
              for name, cls in FILTERS.items() for fp, r in RADII.items()})


def _calls(case, device):
    """The case's film and its chunk splats in order, each a dict:
    ``frame``: (p_film, L, weight, valid) as the render loop hands them to
    the scatter (padded lanes at pixel (0, 0) + jitter, radiance and
    weight zeroed); ``gather``: (p_film, L, weight) with the padded lanes
    poisoned (NaN position, infinite radiance); ``lanes``: the GridLanes."""
    res, crop, filt, spp, chunk = CASES[case]
    film = Film(res, crop=crop, filter=filt)
    (x0, y0), (x1, y1) = film.sample_bounds()
    gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1),
                         indexing="xy")
    grid = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    n = grid.shape[0]
    chunk = n - 1 if chunk is None else min(chunk, n)
    rng = np.random.default_rng(sum(map(ord, case)))
    table = film.filter_table(device)
    out = []
    for start in range(0, n, chunk):
        part = grid[start:start + chunk]
        nv = part.shape[0]
        pad = chunk - nv if chunk < n else 0
        for _ in range(spp):
            jit = rng.random((nv + pad, 2), dtype=np.float32)
            p = np.concatenate([part, np.zeros((pad, 2), np.float32)]) + jit
            L = rng.random((nv + pad, 3), dtype=np.float32)
            w = rng.random(nv + pad, dtype=np.float32) + 0.5
            valid = np.arange(nv + pad) < nv
            t = lambda a: torch.from_numpy(a).to(device)
            p_bad = np.where(valid[:, None], p, np.float32(np.nan))
            L_bad = np.where(valid[:, None], L, np.float32(np.inf))
            v = t(valid)
            out.append(dict(
                frame=(t(p), torch.where(v[:, None], t(L), 0.0),
                       torch.where(v, t(w), 0.0), v),
                gather=(t(p_bad), t(L_bad), t(w)),
                lanes=S.GridLanes(start, nv, (x0, y0), x1 - x0 + 1, table)))
    return film, out


def _xyz(L, w):
    return spec.rgb_to_xyz(L) * w[:, None]


def _scatter_frame(film, calls, device):
    state = film.initial_state(device)
    for c in calls:
        p, L, w, valid = c["frame"]
        state = film.add_samples(state, p, L, w, valid=valid)
    return state


def _equal(a, b):
    return torch.equal(a.xyz, b.xyz) and torch.equal(a.weight_sum,
                                                     b.weight_sum)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_twin_equals_the_scatter(case):
    """On the CPU, chunk after chunk: splat_plain over the chunk's valid
    range (padding poisoned) gives the scatter's film bit for bit."""
    film, calls = _calls(case, "cpu")
    ref = _scatter_frame(film, calls, "cpu")
    state = film.initial_state("cpu")
    for c in calls:
        p, L, w = c["gather"]
        xyz, ws = S.splat_plain(film, state, p, _xyz(L, w), c["lanes"])
        state = FilmState(xyz, ws, state.splat_xyz)
    assert _equal(state, ref)
    assert torch.isfinite(state.xyz).all()
    assert float(ref.weight_sum.sum()) > 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_lanes_stand_in_for_valid(case):
    """On the CPU, chunk after chunk: ``add_samples`` with ``lanes`` alone
    (the padded lanes' radiance left unzeroed, here infinite) gives the
    film of the scatter with the chunk's ``valid`` mask and its padding
    zeroed, bit for bit."""
    film, calls = _calls(case, "cpu")
    ref = _scatter_frame(film, calls, "cpu")
    state = film.initial_state("cpu")
    for c in calls:
        p, _, _, _ = c["frame"]
        _, L, w = c["gather"]
        state = film.add_samples(state, p, L, w, lanes=c["lanes"])
    assert _equal(state, ref)
    assert torch.isfinite(state.xyz).all()


def test_filter_table_holds_the_entries_weights():
    """The table is the filter at its 16 x 16 quantized points, the
    values the scatter's entries take: each entry's weight is the table's
    at its offsets."""
    film = Film((24, 20), filter=FL.GaussianFilter((1.3, 0.7)))
    table = film.filter_table("cpu")
    (_, _), (sx, sy) = film._table_points()
    o = (torch.arange(16, dtype=torch.float32) + 0.5)
    assert table.shape == (16, 16) and table.is_contiguous()
    assert torch.equal(table, film.filter.weight(
        (o * sx)[None, :].expand(16, 16), (o * sy)[:, None].expand(16, 16)))
    p = torch.rand((500, 2), generator=torch.Generator().manual_seed(0)) \
        * torch.tensor([24.0, 20.0]) + 1.0
    _, wf = film.footprint(p)
    got = {float(v) for v in wf.unique()} - {0.0}
    assert got <= {float(v) for v in table.unique()}


@pytest.fixture(scope="module")
def shadows():
    return TSph.build_scene(device="cpu")


def test_frame_body_hands_each_chunk_its_range(shadows, monkeypatch):
    """The render loop gives every chunk splat its GridLanes: start at the
    chunk's first grid lane, the valid lane count, the sample grid's lo
    corner and width, the film's filter table; each valid lane's sample
    lies in its grid pixel. On the CPU the frame is the scatter's, as
    before: the same bits where the chunk's padding is given as a
    ``valid`` mask, its radiance and weight zeroed, in place of
    ``lanes``."""
    film_calls = []
    add = Film.add_samples

    def record(self, state, p_film, L, w, valid=None, lanes=None):
        assert valid is None
        film_calls.append((p_film, lanes))
        return add(self, state, p_film, L, w, valid=valid, lanes=lanes)

    def drop(self, state, p_film, L, w, valid=None, lanes=None):
        v = torch.arange(p_film.shape[0]) < lanes.n_valid
        return add(self, state, p_film, torch.where(v[:, None], L, 0.0),
                   torch.where(v, w, 0.0), valid=v)

    def integ():
        return WhittedIntegrator(TSph.build_camera(16, "unused.png"),
                                 UniformSampler(2, seed=5), max_depth=2,
                                 pixel_chunk=100)

    monkeypatch.setattr(Film, "add_samples", record)
    a = integ()
    got = a.render(shadows)
    film = a.camera.film
    (x0, y0), (x1, y1) = film.sample_bounds()
    n = (x1 - x0 + 1) * (y1 - y0 + 1)
    starts = list(range(0, n, 100))
    assert [lanes.start for _, lanes in film_calls] == \
        [s for s in starts for _ in range(2)]
    table = film.filter_table("cpu")
    for p_film, lanes in film_calls:
        assert lanes.n_valid == min(100, n - lanes.start)
        assert lanes.origin == (x0, y0) and lanes.grid_w == x1 - x0 + 1
        assert torch.equal(lanes.table, table)
        k = torch.arange(lanes.n_valid) + lanes.start
        cell = torch.floor(p_film[:lanes.n_valid])
        assert torch.equal(cell[:, 0], (k % lanes.grid_w + x0).float())
        assert torch.equal(cell[:, 1], (k // lanes.grid_w + y0).float())
    monkeypatch.setattr(Film, "add_samples", drop)
    assert all(torch.equal(x, y) for x, y in zip(got, integ().render(
        shadows)))


def test_other_splats_keep_the_scatter(shadows, monkeypatch):
    """render_share, add_splats and, on the CPU, a chunk with ``lanes``
    reach core.math.scatter_add; the kernel refuses CPU tensors and
    launches nothing."""
    reached = []

    def counted(dst, idx, val):
        reached.append(idx.numel())
        return scatter_add(dst, idx, val)

    monkeypatch.setattr(FM, "scatter_add", counted)
    integ = WhittedIntegrator(TSph.build_camera(8, "unused.png"),
                              UniformSampler(1, seed=1), max_depth=2)
    pixels = integ.pixel_grid("cpu")
    render_share(integ, shadows, pixels, torch.ones(pixels.shape[0],
                                                    dtype=torch.bool))
    assert len(reached) == 2
    film = integ.camera.film
    film.add_splats(film.initial_state("cpu"), pixels.float() + 0.5,
                    torch.ones((pixels.shape[0], 3)))
    assert len(reached) == 3
    launches = S.splat_kernel.launches
    film2, calls = _calls("tail1", "cpu")
    c = calls[0]
    with collect() as stats:
        film2.add_samples(film2.initial_state("cpu"), *c["frame"][:3],
                          lanes=c["lanes"])
    assert len(reached) == 5
    assert "film_splat_gathers" not in stats.as_dict()
    with pytest.raises(ValueError, match="not both"):
        film2.add_samples(film2.initial_state("cpu"), *c["frame"],
                          lanes=c["lanes"])
    p, L, w = c["gather"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        S.splat_kernel(film2, film2.initial_state("cpu"), p, _xyz(L, w),
                       c["lanes"])
    assert S.splat_kernel.launches == launches


def test_plain_twin_refuses_bad_inputs():
    film, calls = _calls("tail1", "cpu")
    c = calls[0]
    p, L, w = c["gather"]
    state = film.initial_state("cpu")
    with pytest.raises(ValueError, match="n_valid"):
        S.splat_plain(film, state, p, _xyz(L, w),
                      c["lanes"]._replace(n_valid=p.shape[0] + 1))
    with pytest.raises(ValueError, match="contiguous"):
        S.splat_plain(film, state, p, _xyz(L, w),
                      c["lanes"]._replace(table=c["lanes"].table.T))


# -- on the card ---------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(nvcc):
        pytest.skip("needs nvcc to build csrc/splat.cu")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_equals_the_serial_reference(case):
    """Each chunk splat of the kernel (through Film.add_samples with
    ``lanes``) from the kernel's running film: bit-equal to the card's own
    footprint entries added to that film in lane order by the CPU's
    deterministic scatter, and to splat_plain on the card; one launch and
    one ``film_splat_gathers`` a chunk."""
    dev = _card()
    film, calls = _calls(case, dev)
    state = film.initial_state(dev)
    launches = S.splat_kernel.launches
    k = film.fp_x * film.fp_y
    with collect() as stats:
        for c in calls:
            p, L, w = c["gather"]
            new = film.add_samples(state, p, L, w, lanes=c["lanes"])
            fp, fL, fw, valid = c["frame"]
            flat, wf = film.footprint(fp, valid)
            contrib = wf[:, None] * _xyz(fL, fw).repeat_interleave(k, dim=0)
            ref_xyz = scatter_add(state.xyz.cpu().reshape(-1, 3), flat.cpu(),
                                  contrib.cpu()).reshape(state.xyz.shape)
            ref_ws = scatter_add(state.weight_sum.cpu().reshape(-1),
                                 flat.cpu(), wf.cpu()).reshape(
                                     state.weight_sum.shape)
            assert torch.equal(new.xyz.cpu(), ref_xyz)
            assert torch.equal(new.weight_sum.cpu(), ref_ws)
            twin = S.splat_plain(film, state, p, _xyz(L, w), c["lanes"])
            assert torch.equal(twin[0], new.xyz)
            assert torch.equal(twin[1], new.weight_sum)
            state = new
    assert S.splat_kernel.launches - launches == len(calls)
    assert stats.as_dict()["film_splat_gathers"] == len(calls)
    assert float(state.weight_sum.sum()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cuda_kernel_within_rounding_of_the_card_scatter(case):
    """The kernel's whole film against the card's scatter (which sums a
    pixel's entries in its own order): within 1e-5 relative, at pixels
    whose weight sum is over 1e-3."""
    dev = _card()
    film, calls = _calls(case, dev)
    ref = _scatter_frame(film, calls, dev)
    state = film.initial_state(dev)
    for c in calls:
        state = film.add_samples(state, *c["gather"], lanes=c["lanes"])
    live = ref.weight_sum > 1e-3
    assert int(live.sum()) > 0
    for a, b in ((state.xyz, ref.xyz), (state.weight_sum, ref.weight_sum)):
        gap = (a - b).abs() / b.abs().clamp_min(1e-3)
        worst = float(gap[live].max())
        assert worst <= 1e-5, worst


@pytest.mark.cuda
def test_cuda_splats_capture_and_replay():
    """The cell's two chunk splats captured into a CUDA graph: every
    replay gives the eager splats' bits."""
    dev = _card()
    film, calls = _calls("cell", dev)

    def body():
        state = film.initial_state(dev)
        for c in calls:
            state = film.add_samples(state, *c["gather"], lanes=c["lanes"])
        return state

    eager = body()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    launches = S.splat_kernel.launches
    with torch.cuda.graph(graph):
        out = body()
    assert S.splat_kernel.launches - launches == len(calls) == 2
    for _ in range(2):
        for t in out:
            t.fill_(-1.0)
        graph.replay()
        torch.cuda.synchronize()
        assert _equal(out, eager)


@pytest.mark.cuda
def test_cuda_frame_takes_the_gather():
    """A 256^2 Whitted frame of the shadows scene on the card (two chunks
    of 65,536 lanes): two gather launches and two ``film_splat_gathers``,
    and no launch of PyTorch's index_put_ scatter; the graph route
    captures the same two."""
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    scene = TSph.build_scene(device=dev)

    def integ(graph):
        return WhittedIntegrator(TSph.build_camera(256, "unused.png"),
                                 UniformSampler(1, seed=0), max_depth=2,
                                 frame_graph=graph)

    eager = integ(False)
    eager.render(scene)
    launches = S.splat_kernel.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with collect() as stats:
            ref = eager.render(scene)
        torch.cuda.synchronize()
    assert S.splat_kernel.launches - launches == 2
    assert stats.as_dict()["film_splat_gathers"] == 2
    names = {e.key for e in prof.key_averages()}
    assert any("splat_gather_kernel" in k for k in names), names
    assert not any("indexing_backward" in k for k in names), names
    graphed = integ(True)
    for _ in range(3):
        state = graphed.render(scene)
    torch.cuda.synchronize()
    assert graphed.frame_graphs.captures[-1]["launches"]["splat"] == 2
    assert _equal(state, ref)
