"""The port's film against the JAX package's: the Box, Triangle and
Gaussian filters, crop bounds, sample bounds and physical extent, the
scatter splat (``add_samples``), unfiltered splats (``add_splats``),
``to_image`` with splats and scale, and a cropped render.

Gates: filters at the 16 table points bit-equal (Box, Triangle) or within
rtol 5e-7 (Lanczos' sin, the Gaussian's exp: XLA's and torch's f32
transcendentals round alike on most inputs, not all; measured 2.8e-7, one
ulp of each factor); against JAX's jitted film, the scatter's weight sums
bit-equal under Box and Triangle filters (exact weights: the same order
of addition per pixel) and within rtol 5e-7 elsewhere (the filter's last
bits), xyz and splats within rtol 1e-6 (jitted XLA contracts the
rgb -> xyz matrix into FMAs; measured 1.9e-6 absolute on sums near 4),
the images within 1e-6 absolute; the scatter
against the stencil splat as test_film_grid.py holds JAX's (rtol 2e-6 on
weights, 2e-5 on xyz); splats bit-equal; a cropped frame's pixels equal
to the full frame's window (the samples hang off raster pixel ids) but
for the crop's outer ring of pixels: the reference's footprint reaches
one pixel past the filter radius (floor(d + r) + 1), further than the
cropped film's sample bounds, so the ring misses samples the full film
splats there (both packages share this; measured up to 0.10 with a box
filter at 32^2, the interior bit-equal).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.film import filters as JFl
from trace_tpu.film.film import Film as JFilm
from trace_tpu_torch import convert as C
from trace_tpu_torch.film import filters as TFl
from trace_tpu_torch.film.film import FILTER_TABLE_WIDTH, Film
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.io.png import write_png
from trace_tpu_torch.models import spheres as TSph
from trace_tpu_torch.sampler.uniform import UniformSampler
from trace_tpu_torch.utils.compare import main as compare_main

FILTERS = {
    "box": ("BoxFilter", (0.5, 0.5)),
    "triangle": ("TriangleFilter", (2.0, 1.5)),
    "gaussian": ("GaussianFilter", (2.0, 2.0)),
    "lanczos": ("LanczosSincFilter", (1.0, 1.0)),
}
EXACT = ("box", "triangle")


def _filters(name):
    cls, r = FILTERS[name]
    return getattr(JFl, cls)(r), getattr(TFl, cls)(r)


@pytest.mark.parametrize("name", list(FILTERS))
def test_filter_at_the_table_points(name):
    jf, tf = _filters(name)
    assert tf.radius == jf.radius
    i = np.arange(FILTER_TABLE_WIDTH, dtype=np.float32) + np.float32(0.5)
    r = np.asarray(tf.radius, np.float32)
    px, py = np.meshgrid(i * (r[0] / np.float32(FILTER_TABLE_WIDTH)),
                         i * (r[1] / np.float32(FILTER_TABLE_WIDTH)))
    want = np.asarray(jf(jnp.stack([jnp.asarray(px), jnp.asarray(py)], -1)))
    got = tf(torch.from_numpy(px), torch.from_numpy(py)).numpy()
    if name in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=5e-7, atol=1e-30)
    assert got.shape == (16, 16) and (got >= 0).all()


def test_gaussian_and_triangle_shapes():
    g = TFl.GaussianFilter(2.0, alpha=2.0)
    assert g.radius == (2.0, 2.0)
    z = torch.zeros(1)
    assert float(g(torch.tensor([2.5]), z)) == 0.0   # outside the radius
    assert float(g(z, z)) == pytest.approx((1 - np.exp(-8.0)) ** 2, rel=1e-6)
    t = TFl.TriangleFilter((2.0, 1.0))
    assert float(t(torch.tensor([1.0]), torch.tensor([0.5]))) == 0.5


@pytest.mark.parametrize("res, crop", [
    ((100, 100), ((0.25, 0.25), (0.75, 0.75))),
    ((64, 48), ((0.25, 0.25), (0.9, 0.8))),
    ((1024, 1024), ((0.0, 0.0), (1.0, 1.0))),
    ((37, 21), ((0.1, 0.3), (0.6, 1.0)))])
def test_crop_bounds_sample_bounds_and_extent(res, crop):
    for name in FILTERS:
        jfl, tfl = _filters(name)
        j = JFilm(res, crop=crop, filter=jfl, diagonal=42.0, scale=2.0)
        t = Film(res, crop=crop, filter=tfl, diagonal=42.0, scale=2.0)
        assert (t.crop_min, t.crop_max, t.width, t.height) == \
            (j.crop_min, j.crop_max, j.width, j.height)
        assert t.sample_bounds() == j.sample_bounds()
        assert t.physical_extent() == j.physical_extent()
        assert (t.fp_x, t.fp_y, t.stencil_x, t.stencil_y) == \
            (j.fp_x, j.fp_y, j.stencil_x, j.stencil_y)
        assert t.diagonal == j.diagonal and t.scale == j.scale
    t = Film((100, 100), crop=((0.25, 0.25), (0.75, 0.75)))
    assert t.crop_min == (26, 26) and t.crop_max == (75, 75)
    assert t.width == t.height == 50
    assert Film((1024, 1024)).sample_bounds() == ((0, 0), (1025, 1025))


def _films(name, res=(40, 32), crop=((0.0, 0.0), (1.0, 1.0))):
    jfl, tfl = _filters(name)
    return (JFilm(res, crop=crop, filter=jfl, scale=1.5),
            Film(res, crop=crop, filter=tfl, scale=1.5))


def _samples(n, span, seed):
    rng = np.random.default_rng(seed)
    p = (rng.random((n, 2)) * np.asarray(span) - 2.0).astype(np.float32)
    L = rng.random((n, 3)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    valid = rng.random(n) < 0.9
    return p, L, w, valid


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("cropped", [False, True], ids=["full", "crop"])
def test_scatter_and_splats_match_jax(name, cropped):
    crop = ((0.25, 0.25), (0.9, 0.8)) if cropped else ((0.0, 0.0), (1.0, 1.0))
    jf, tf = _films(name, crop=crop)
    p, L, w, valid = _samples(3000, (44, 36), 7)

    @jax.jit
    def jax_film(p, L, w, valid):
        st = jf.add_samples(jf.initial_state(), p, L, w, valid=valid)
        st = jf.add_splats(st, p[:500], L[:500])
        return st, jf.to_image(st, 1.0), jf.to_image(st, 0.25)

    js, *jimgs = jax_film(*(jnp.asarray(a) for a in (p, L, w, valid)))
    ts = tf.add_samples(tf.initial_state("cpu"), torch.from_numpy(p),
                        torch.from_numpy(L), torch.from_numpy(w),
                        valid=torch.from_numpy(valid))
    ts = tf.add_splats(ts, torch.from_numpy(p[:500]),
                       torch.from_numpy(L[:500]))
    # Box and triangle weights are exact, so equal sums mean the same
    # order of addition per pixel.
    ws = np.asarray(js.weight_sum)
    if name in EXACT:
        np.testing.assert_array_equal(ts.weight_sum.numpy(), ws)
    else:
        np.testing.assert_allclose(ts.weight_sum.numpy(), ws, rtol=5e-7,
                                   atol=1e-7)
    for a, b in ((np.asarray(js.xyz), ts.xyz.numpy()),
                 (np.asarray(js.splat_xyz), ts.splat_xyz.numpy())):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)
    for a, scale in zip(jimgs, (1.0, 0.25)):
        np.testing.assert_allclose(tf.to_image(ts, scale).numpy(),
                                   np.asarray(a), rtol=0, atol=1e-6)
    # The JAX state carried across reads back as the port's.
    back = C.film_state_from_numpy(js, "cpu")
    np.testing.assert_array_equal(back.splat_xyz.numpy(),
                                  np.asarray(js.splat_xyz))


def test_dead_lane_touches_neither_xyz_nor_weights():
    # test_film_camera_sampler.py: a padded lane at pixel (0, 0) under a
    # radius-4 Lanczos filter reaches crop pixels 1..4.
    film = Film((16, 16), filter=TFl.LanczosSincFilter((4.0, 4.0), 3.0))
    p = torch.zeros((1, 2))
    s = film.add_samples(film.initial_state("cpu"), p, torch.zeros((1, 3)),
                         torch.zeros(1), valid=torch.zeros(1, dtype=torch.bool))
    assert float(s.weight_sum.abs().max()) == 0.0
    assert float(s.xyz.abs().max()) == 0.0
    s2 = film.add_samples(s, p, torch.zeros((1, 3)), torch.ones(1),
                          valid=torch.ones(1, dtype=torch.bool))
    assert float(s2.weight_sum.abs().max()) > 0.0


def test_box_filter_roundtrip_and_average():
    film = Film((8, 8), filter=TFl.BoxFilter((0.5, 0.5)))
    p = torch.tensor([[3.5, 3.5], [3.5, 3.5]])
    L = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    s = film.add_samples(film.initial_state("cpu"), p, L, torch.ones(2))
    np.testing.assert_allclose(film.to_image(s).numpy()[2, 2], [0.5, 0, 0],
                               atol=3e-3)
    s = film.add_samples(film.initial_state("cpu"), p[:1],
                         torch.tensor([[0.25, 0.5, 0.75]]), torch.ones(1))
    np.testing.assert_allclose(film.to_image(s).numpy()[2, 2],
                               [0.25, 0.5, 0.75], atol=3e-3)


def test_out_of_crop_splats_are_dropped():
    film = Film((8, 8))
    p = torch.tensor([[-3.0, 4.0], [100.0, 4.0], [4.5, 4.5]])
    s = film.add_splats(film.initial_state("cpu"), p, torch.ones((3, 3)))
    sp = s.splat_xyz.numpy()
    assert sp[3, 3].sum() > 0
    assert sp[3, 0].sum() == 0.0 and sp[3, 7].sum() == 0.0
    assert float(sp.sum()) == pytest.approx(float(sp[3, 3].sum()))
    bad = film.add_splats(s, torch.tensor([[-3.0, 4.0]]),
                          torch.full((1, 3), float("inf")))
    assert np.isfinite(bad.splat_xyz.numpy()).all()
    # A cropped film drops what falls outside its window.
    cf = Film((8, 8), crop=((0.25, 0.25), (0.75, 0.75)))
    cs = cf.add_splats(cf.initial_state("cpu"), p, torch.ones((3, 3)))
    assert float(cs.splat_xyz.sum()) > 0 and cs.splat_xyz.shape == (4, 4, 3)
    assert float(cs.splat_xyz[1, 1].sum()) == pytest.approx(
        float(cs.splat_xyz.sum()))


def _grid_samples(film, seed):
    (x0, y0), (x1, y1) = film.sample_bounds()
    gw, gh = x1 - x0 + 1, y1 - y0 + 1
    gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
    pixels = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    rng = np.random.default_rng(seed)
    n = pixels.shape[0]
    p = pixels.astype(np.float32) + rng.random((n, 2), np.float32)
    L = rng.random((n, 3), np.float32)
    w = rng.random(n).astype(np.float32) * 0.5 + 0.5
    return (x0, y0), (gh, gw), *(torch.from_numpy(a) for a in (p, L, w))


@pytest.mark.parametrize("film", [
    Film((48, 40), filter=TFl.LanczosSincFilter((1.0, 1.0), 3.0)),
    Film((32, 32), filter=TFl.TriangleFilter((2.0, 1.5))),
    Film((64, 64), crop=((0.25, 0.25), (0.9, 0.8)),
         filter=TFl.LanczosSincFilter((1.0, 1.0), 3.0)),
    Film((40, 24), crop=((0.1, 0.2), (0.7, 0.9)),
         filter=TFl.GaussianFilter((2.0, 2.0)))],
    ids=["lanczos", "wide_triangle", "crop", "gaussian_crop"])
def test_scatter_matches_the_grid_splat(film):
    origin, hw, p, L, w = _grid_samples(film, 5)
    s0 = film.initial_state("cpu")
    a = film.add_samples(s0, p, L, w)
    b = film.add_samples_grid(s0, p, L, w, origin, hw)
    np.testing.assert_allclose(a.weight_sum.numpy(), b.weight_sum.numpy(),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(a.xyz.numpy(), b.xyz.numpy(), rtol=2e-5,
                               atol=2e-6)
    assert float(b.weight_sum.sum()) > 0


def test_scatter_repeats_bit_for_bit():
    film = Film((64, 64), filter=TFl.GaussianFilter((2.0, 2.0)))
    p, L, w, _ = _samples(20000, (68, 68), 11)
    args = [torch.from_numpy(a) for a in (p, L, w)]
    a = film.add_samples(film.initial_state("cpu"), *args)
    b = film.add_samples(film.initial_state("cpu"), *args)
    assert torch.equal(a.xyz, b.xyz) and torch.equal(a.weight_sum,
                                                     b.weight_sum)


@pytest.mark.parametrize("filt", [TFl.GaussianFilter((2.0, 2.0)),
                                  TFl.BoxFilter((0.5, 0.5))],
                         ids=["gaussian", "box"])
def test_cropped_render_equals_the_full_frames_window(filt, tmp_path,
                                                      capsys):
    """Sample keys hang off raster pixel ids, so a cropped film's pixels
    are the full film's window inside the crop's outer ring (module
    docstring); compare.py's CLI reads the two PNGs."""
    scene = TSph.build_scene(device="cpu")
    imgs = {}
    for label, crop in (("full", ((0.0, 0.0), (1.0, 1.0))),
                        ("crop", ((0.25, 0.25), (0.75, 0.75)))):
        cam = TSph.build_camera(resolution=32, filename="unused.png")
        cam.film = Film((32, 32), crop=crop, filter=filt,
                        filename=str(tmp_path / f"{label}.png"))
        integ = WhittedIntegrator(cam, UniformSampler(2, seed=4), max_depth=2)
        imgs[label] = (cam.film, cam.film.save_png(integ.render(scene)))
    film, crop_img = imgs["crop"]
    (cx0, cy0), (cx1, cy1) = film.crop_min, film.crop_max
    window = imgs["full"][1][cy0 - 1:cy1, cx0 - 1:cx1]
    assert crop_img.shape == window.shape == (16, 16, 3)
    inner = float(np.abs(crop_img - window)[1:-1, 1:-1].max())
    ring = float(np.abs(crop_img - window).max())
    print(f"cropped 32^2 shadows frame against the full frame's window: "
          f"interior max abs {inner:.3e}, outer ring {ring:.3e}")
    assert inner <= 1e-6 and crop_img.max() > 0.05
    # compare.py's CLI on the crop's PNG and the window's, inside the ring.
    write_png(str(tmp_path / "window.png"), window[::-1])
    capsys.readouterr()
    assert compare_main([str(tmp_path / "crop.png"),
                         str(tmp_path / "window.png"),
                         "--crop", "1", "1", "15", "15"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert set(got) == {"mse", "rel_mse", "psnr"} and got["mse"] == 0.0
