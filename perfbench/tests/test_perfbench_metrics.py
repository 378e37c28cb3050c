"""The per-layer readers on a synthetic profile."""
import importlib

import pytest

from perfbench.profiling import Trace


def synthetic():
    # Two steps of 1000 us; kernels (sweep, prologue, an elementwise op),
    # a copy; host ops covering the gaps.
    device = [
        ("void sweep_kernel<false, 0, false, false>(float const*)", 100, 300),
        ("prologue_kernel(float const*)", 300, 350),
        ("void at::native::vectorized_elementwise_kernel<4>()", 500, 600),
        ("Memcpy HtoD (Pageable -> Device)", 600, 650),
        ("void sweep_tiled_kernel<true, 1>(float const*)", 1100, 1500),
        ("void at::native::vectorized_elementwise_kernel<4>()", 1400, 1600),
        ("outside_kernel", 2500, 2600),
    ]
    host = [("aten::add", 0, 100), ("cudaLaunchKernel", 350, 500),
            ("aten::nonzero", 1600, 2000)]
    return Trace(device=device, host=host, steps=[(0, 1000), (1000, 2000)],
                 n_steps=2, phase_ms={"camera": [3.0, 5.0],
                                      "photon": [1.0, 2.0]})


def device_only():
    """The metrics' pass: the card's activity alone (every event inside
    the profiled steps), the window from the host clock."""
    tr = synthetic()
    return Trace(device=tr.device[:-1], host=[], steps=[], n_steps=2,
                 window=2000.0, phase_ms=tr.phase_ms)


READERS = [
    ("kernels_per_step", 2.5),              # 5 kernels in 2 steps
    ("intersect_ms_per_step", 0.325),       # (200 + 50 + 400) us / 2
    ("intersect_launches_per_step", 1.5),
    ("device_idle_pct", 100 * (1 - 900 / 2000)),
    ("sppm_camera_ms_per_step", 4.0),
    ("sppm_photon_ms_per_step", 1.5),
]


@pytest.mark.parametrize("make", [synthetic, device_only])
@pytest.mark.parametrize("name,want", READERS)
def test_reader(name, want, make):
    got = importlib.import_module("perfbench.metrics." + name).read(make())
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", [n for n, _ in READERS])
def test_reader_finds_nothing(name):
    empty = Trace(device=[], host=[], steps=[(0, 1000)], n_steps=1)
    assert importlib.import_module("perfbench.metrics." + name).read(
        empty) is None


def test_busy_gaps_and_breakdown():
    tr = synthetic()
    assert tr.busy_us() == pytest.approx(900.0)
    assert tr.window_us() == 2000.0
    gaps = tr.idle_gaps()
    assert gaps[0] == (0, 100) and (1600, 2000) in gaps
    ops = tr.top_ops()
    assert ops[0][0].startswith("void sweep_tiled_kernel")
    assert ops[0][1] == pytest.approx(400e-6)
    names = dict(tr.gap_causes())
    assert names["aten::nonzero"] == pytest.approx(400e-6)
    assert names["aten::add"] == pytest.approx(100e-6)
    assert len(ops) <= 10 and len(names) <= 10
    only = device_only()
    assert only.busy_us() == pytest.approx(900.0)
    assert only.window_us() == 2000.0
