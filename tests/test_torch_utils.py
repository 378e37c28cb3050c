"""The port's utilities against the JAX package's: RenderStats and
trace_profile (test_stats.py's cases, on the port's Whitted and SPPM),
the render loop's and SPPM's counters, image comparison and its CLI, the
OBJ loader, and blackbody emission.

Gates: counters as the JAX twin computes them (exact integers); metrics
and the OBJ tables equal to JAX's; blackbody within rtol 1e-5 of JAX's
(torch's and XLA's f32 exp and pow differ in the last bits, measured
1.7e-6), the normalized peak 1 within 1e-4 (test_lights_scene.py).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.io import obj as JObj
from trace_tpu.lights import lights as JL
from trace_tpu.utils import compare as JCmp
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.integrators.path import PathIntegrator
from trace_tpu_torch.integrators.sppm import SPPMIntegrator
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.io import obj as TObj
from trace_tpu_torch.io.png import write_png
from trace_tpu_torch.lights import lights as TL
from trace_tpu_torch.models import cornell, spheres
from trace_tpu_torch.sampler.stratified import StratifiedSampler
from trace_tpu_torch.sampler.uniform import UniformSampler
from trace_tpu_torch.utils import compare as TCmp
from trace_tpu_torch.utils.stats import RenderStats, trace_profile


def test_counters_and_timers():
    st = RenderStats()
    st.add("x", 2)
    st.add("x", 3)
    st.start("render")
    st.stop("render")
    st.stop("never_started")   # no timer: nothing recorded
    d = st.as_dict()
    assert d["x"] == 5 and "never_started_seconds" not in d
    assert d["render_seconds"] >= 0
    st.counters["rays_dispatched"] = 2e6
    st.counters["render_seconds"] = 1.0
    assert st.mrays_per_sec() == 2.0
    assert RenderStats().mrays_per_sec() == 0.0
    assert "x=5" in repr(st)


@pytest.mark.parametrize("sampler", [UniformSampler(1),
                                     StratifiedSampler(2, 1)],
                         ids=["uniform", "stratified"])
def test_whitted_render_populates_stats(sampler):
    stats = RenderStats()
    scene = spheres.build_scene(device="cpu")
    cam = spheres.build_camera(resolution=16, filename="unused.png")
    integ = WhittedIntegrator(cam, sampler, max_depth=2, stats=stats)
    integ.render(scene)
    d = stats.as_dict()
    (x0, y0), (x1, y1) = cam.film.sample_bounds()
    n = (x1 - x0 + 1) * (y1 - y0 + 1) * sampler.samples_per_pixel
    assert d["camera_samples"] == n
    # The JAX twin's numerator: one closest hit and one shadow ray a light
    # per level for every lane.
    assert d["rays_dispatched"] == n * 2 * (1 + int(
        scene.lights.kind.shape[0]))
    assert d["render_seconds"] > 0
    assert d["specular_queue_drops"] == 0 == integ.last_queue_drops
    assert d["useful_rays"] == integ.last_useful_rays > 0


def test_path_render_takes_stats():
    stats = RenderStats()
    scene = cornell.build_scene(device="cpu")
    cam = cornell.build_camera(resolution=8, filename="unused.png")
    PathIntegrator(cam, UniformSampler(1), max_depth=2,
                   stats=stats).render(scene)
    assert stats.as_dict()["camera_samples"] == 10 * 10
    assert stats.as_dict()["useful_rays"] > 0


def test_sppm_render_populates_stats():
    stats = RenderStats()
    scene = spheres.build_scene(device="cpu")
    cam = spheres.build_camera(resolution=16, filename="unused.png")
    integ = SPPMIntegrator(cam, initial_search_radius=0.3, max_depth=2,
                           n_iterations=2, photons_per_iteration=128,
                           pixel_chunk=128, stats=stats, device="cpu")
    integ.render(scene)
    d = stats.as_dict()
    n_pix = 16 * 16
    assert d["photons_traced"] == 2 * 128
    assert d["camera_rays"] == 2 * n_pix
    assert d["rays_dispatched"] == 2 * (n_pix * 2 * 2 + 128 * 2)
    assert d["photon_vp_pairs"] >= 0
    assert 0 < d["visible_points"] <= 2 * n_pix
    assert 0 < d["grid_cells_occupied"] <= min(2 * n_pix,
                                               8 * d["visible_points"])


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "prof"
    with trace_profile(str(out)) as prof:
        x = torch.sqrt(torch.arange(128.0))
    assert float(x[4]) == 2.0
    assert prof.path == str(out / "trace.json") and os.path.isfile(prof.path)
    trace = json.load(open(prof.path))
    assert any("sqrt" in e.get("name", "") for e in trace["traceEvents"])


def test_compare_metrics_match_jax():
    a = np.zeros((4, 4, 3), np.float32)
    b = np.full((4, 4, 3), 0.1, np.float32)
    assert TCmp.mse(a, a) == 0.0 and TCmp.psnr(a, a) == float("inf")
    assert TCmp.mse(a, b) == pytest.approx(0.01, rel=1e-5)
    assert TCmp.rel_mse(b, b) == 0.0
    assert set(TCmp.compare(a, b)) == {"mse", "rel_mse", "psnr"}
    assert TCmp.mse(np.zeros((2, 2, 3), np.uint8),
                    np.full((2, 2, 3), 255, np.uint8)) == pytest.approx(1.0)
    rng = np.random.default_rng(0)
    x, y = rng.random((2, 9, 7, 3)).astype(np.float32)
    assert TCmp.compare(x, y) == JCmp.compare(x, y)
    with pytest.raises(ValueError):
        TCmp.mse(x, y[:5])


def test_compare_cli(tmp_path, capsys):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (10, 12, 3)).astype(np.uint8)
    b = a.copy()
    b[6:, :, 0] = 0
    write_png(str(tmp_path / "a.png"), a)
    write_png(str(tmp_path / "b.png"), b)
    capsys.readouterr()
    assert TCmp.main([str(tmp_path / "a.png"), str(tmp_path / "b.png")]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == pytest.approx(JCmp.compare(a, b))
    assert TCmp.main([str(tmp_path / "a.png"), str(tmp_path / "b.png"),
                      "--crop", "0", "0", "12", "6"]) == 0
    assert json.loads(capsys.readouterr().out)["mse"] == 0.0


QUAD = ("# comment\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vn 0 0 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1/1 2/2/1 3/3/1 4/4/1\n")
MIXED = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 1\n"
         "vt 0 0\nvt 1 0\nvt 0 1\n"
         "f -4 -3 -2\nf 2//1 4 3\nf 1/1 2/2 3/3 4/3\n")


@pytest.mark.parametrize("text", [QUAD, MIXED, "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
                                  "f -3 -2 -1\n"], ids=["quad", "mixed",
                                                        "negative"])
def test_obj_loader_matches_jax(tmp_path, text):
    path = str(tmp_path / "m.obj")
    open(path, "w").write(text)
    j, t = JObj.load_obj(path), TObj.load_obj(path)
    assert set(t) == set(j)
    for k in j:
        if j[k] is None:
            assert t[k] is None, k
        else:
            np.testing.assert_array_equal(t[k], j[k])
            assert t[k].dtype == j[k].dtype, k


def test_obj_roundtrip_and_triangle_mesh(tmp_path):
    path = tmp_path / "quad.obj"
    path.write_text(QUAD)
    m = TObj.load_obj(str(path))
    assert m["vertices"].shape == (4, 3)
    np.testing.assert_array_equal(m["indices"], [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_allclose(m["normals"], [[0, 0, 1]] * 4)
    assert m["uv"].shape == (4, 2)
    tris = TObj.load_triangle_mesh(str(path), TT.translate([0.0, 0.0, 2.0]),
                                   material_id=3)
    np.testing.assert_allclose(np.asarray(tris.v0)[:, 2], 2.0)
    assert np.asarray(tris.material_id).tolist() == [3, 3]


def test_blackbody_matches_jax_and_peaks_at_one():
    wl = np.linspace(360.0, 830.0, 95).astype(np.float32)
    for temp in (2700.0, 5500.0, 6500.0):
        np.testing.assert_allclose(
            TL.blackbody(torch.from_numpy(wl), temp).numpy(),
            np.asarray(JL.blackbody(jnp.asarray(wl), temp)), rtol=1e-5)
        np.testing.assert_allclose(
            TL.blackbody_normalized(torch.from_numpy(wl), temp).numpy(),
            np.asarray(JL.blackbody_normalized(jnp.asarray(wl), temp)),
            rtol=1e-5)
    t = 5500.0
    lam_max = 2.8977721e-3 / t * 1e9
    le = TL.blackbody_normalized([lam_max], t)
    assert le.dtype == torch.float32
    assert float(le[0]) == pytest.approx(1.0, rel=1e-4)
