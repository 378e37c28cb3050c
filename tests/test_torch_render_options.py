"""The render loop's JAX options in the port, against the JAX package:
pixel chunking (``pixel_chunk``, ``spp_per_dispatch``), Whitted's
``queue_capacity``, ``sort_materials`` and ``li_impl``, and the film's
``add_samples_grid(valid=)``.

Tolerances: whole images by the repo's MSE gate (< 5e-4,
test_io_compare.py) against jitted JAX renders, with the max abs
difference printed; ``queue_drops`` equal; renders the port's own design
makes equal are held bit for bit. ``useful_rays``: jitted JAX contracts
f32 arithmetic into FMAs and flips one shadow lane of the shadows frame
(it counts 3535 at one chunk and 3583 in chunks of 100, the port 3536
and 3584; op-by-op JAX counts the port's 3584 in chunks), so the chunked
count is held to JAX's through the padded lanes' increment over the
one-chunk count, which must be equal.
"""
import numpy as np
import pytest
import torch

from torch_jax_arrays import mse
from trace_tpu.core import transform as JT
from trace_tpu.integrators.whitted import WhittedIntegrator as JWhitted
from trace_tpu.lights.lights import point_light as j_point_light
from trace_tpu.materials.materials import GlassMaterial as JGlass
from trace_tpu.materials.materials import MatteMaterial as JMatte
from trace_tpu.models import spheres as JSph
from trace_tpu.sampler import uniform as JU
from trace_tpu.scene import SceneBuilder as JBuilder
from trace_tpu_torch.film.film import Film
from trace_tpu_torch.integrators.path import PathIntegrator
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.models import cornell as TC
from trace_tpu_torch.models import spheres as TSph
from trace_tpu_torch.sampler.uniform import UniformSampler

MSE_GATE = 5e-4
# Shadows 24^2: a 26^2 = 676-lane sample grid in chunks of 100, the tail
# padded with 24 invalid lanes; 2 spp, depth 3.
RES, SPP, DEPTH, CHUNK = 24, 2, 3, 100


@pytest.fixture(scope="module")
def jax_shadows():
    return JSph.build_scene()


@pytest.fixture(scope="module")
def scene():
    return TSph.build_scene(device="cpu")


def _jax_render(scene, pixel_chunk=CHUNK, **kw):
    cam = JSph.build_camera(resolution=RES, filename="unused.png")
    integ = JWhitted(cam, JU.UniformSampler(SPP, seed=0), max_depth=DEPTH,
                     pixel_chunk=pixel_chunk, **kw)
    img = np.asarray(cam.film.to_image(integ.render(scene)))
    return img, int(integ.last_useful_rays), int(integ.last_queue_drops)


def _render(scene, res=RES, spp=SPP, **kw):
    cam = TSph.build_camera(res, "unused.png")
    integ = WhittedIntegrator(cam, UniformSampler(spp, seed=0),
                              max_depth=DEPTH, **kw)
    state = integ.render(scene)
    return state, cam.film.to_image(state).numpy(), integ


def _jax_queue_render():
    """The JAX package's planar li with a queue of 250 on the 12^2 glass
    scene: (image, queue_drops, useful_rays)."""
    jsc = _glass_scene(JBuilder, JGlass, JMatte, j_point_light, JT)
    cam = JSph.build_camera(resolution=12, filename="unused.png")
    ji = JWhitted(cam, JU.UniformSampler(1, seed=0), max_depth=DEPTH,
                  queue_capacity=250, li_impl="planar")
    img = np.asarray(cam.film.to_image(ji.render(jsc)))
    return img, int(ji.last_queue_drops), int(ji.last_useful_rays)


@pytest.fixture(scope="module")
def jax_renders(jax_shadows):
    """Every JAX render the module compares with, each its own XLA
    compile, run in threads: XLA compiles outside the GIL, so the four
    compiles overlap (the module took ~90 s with them one after another).
    """
    from concurrent.futures import ThreadPoolExecutor

    jobs = {"chunked": lambda: _jax_render(jax_shadows),
            "one_chunk": lambda: _jax_render(jax_shadows,
                                             pixel_chunk=1 << 16),
            "sorted": lambda: _jax_render(jax_shadows, sort_materials=True),
            "queue": _jax_queue_render}
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {k: ex.submit(f) for k, f in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


@pytest.fixture(scope="module")
def jax_chunked(jax_renders):
    return jax_renders["chunked"]


@pytest.fixture(scope="module")
def jax_one_chunk_useful(jax_renders):
    return jax_renders["one_chunk"][1]


@pytest.fixture(scope="module")
def one_chunk(scene):
    return _render(scene)


@pytest.fixture(scope="module")
def chunked(scene):
    return {spd: _render(scene, pixel_chunk=CHUNK, spp_per_dispatch=spd)
            for spd in (None, 1)}


@pytest.mark.parametrize("spd", [None, 1])
def test_chunked_render_matches_jax(jax_chunked, jax_one_chunk_useful,
                                    chunked, one_chunk, spd):
    """A chunked render (a padded tail chunk, the scatter splat) against
    the JAX package's chunked render: pixels within the MSE gate; the
    padded lanes count as JAX counts them (module docstring), and
    queue_drops are equal."""
    img_j, useful_j, drops_j = jax_chunked
    _, img, integ = chunked[spd]
    print(f"chunked shadows {RES}^2, spp_per_dispatch {spd}: MSE "
          f"{mse(img, img_j):.3e}, max abs {np.abs(img - img_j).max():.3e}; "
          f"useful_rays {integ.last_useful_rays} (jitted JAX {useful_j})")
    assert np.isfinite(img).all() and img.max() > 0.05
    assert mse(img, img_j) < MSE_GATE
    assert (integ.last_useful_rays - one_chunk[2].last_useful_rays
            == useful_j - jax_one_chunk_useful > 0)
    assert integ.last_queue_drops == drops_j == 0
    assert integ.pixel_chunk == CHUNK and integ.spp_per_dispatch == spd


def test_spp_per_dispatch_gives_the_same_bits(chunked):
    """spp_per_dispatch is accepted for the JAX signature and read nowhere
    (integrators/base.py): a render with it is a render without it."""
    a, b = chunked[None][0], chunked[1][0]
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_chunked_equals_one_chunk_but_for_the_splat_order(chunked,
                                                          one_chunk):
    """One chunk (the grid stencil) and chunks of 100 (the scatter) draw
    the same samples; the images differ by the splats' summation order
    only. The tail's padded lanes trace and count: useful_rays grows."""
    _, one, integ1 = one_chunk
    _, img, integ = chunked[None]
    assert integ1.pixel_chunk == 1 << 16
    print(f"chunked vs one chunk: max abs {np.abs(img - one).max():.3e}")
    np.testing.assert_allclose(img, one, rtol=0, atol=1e-6)
    assert integ.last_useful_rays > integ1.last_useful_rays


def test_path_integrator_takes_pixel_chunk():
    """PathIntegrator(pixel_chunk=): a chunked Cornell frame equals the
    one-chunk frame but for the splat's summation order."""
    box = TC.build_scene(device="cpu")
    imgs = []
    for chunk in (1 << 16, 64):
        cam = TC.build_camera(10, "unused.png")
        integ = PathIntegrator(cam, UniformSampler(1, seed=3), max_depth=3,
                               pixel_chunk=chunk)
        assert integ.pixel_chunk == chunk
        imgs.append(cam.film.to_image(integ.render(box)).numpy())
    np.testing.assert_allclose(imgs[0], imgs[1], rtol=0, atol=1e-6)
    assert imgs[0].max() > 0


def test_add_samples_grid_valid_lanes_add_nothing():
    """Lanes with valid=False add nothing to the stencil splat, as in the
    JAX package."""
    film = Film((6, 5))
    (x0, y0), (x1, y1) = film.sample_bounds()
    gh, gw = y1 - y0 + 1, x1 - x0 + 1
    g = torch.Generator().manual_seed(1)
    xs, ys = torch.meshgrid(torch.arange(x0, x1 + 1),
                            torch.arange(y0, y1 + 1), indexing="xy")
    p = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1).float() + \
        torch.rand(gh * gw, 2, generator=g)
    l = torch.rand(gh * gw, 3, generator=g)
    w = torch.ones(gh * gw)
    valid = torch.rand(gh * gw, generator=g) > 0.5
    st = film.initial_state("cpu")
    masked = film.add_samples_grid(st, p, l, w, (x0, y0), (gh, gw),
                                   valid=valid)
    zeroed = film.add_samples_grid(st, p, torch.where(valid[:, None], l, 0.0),
                                   torch.where(valid, w, 0.0), (x0, y0),
                                   (gh, gw), valid=valid)
    scat = film.add_samples(st, p, l, w, valid=valid)
    assert torch.equal(masked.weight_sum, zeroed.weight_sum)
    np.testing.assert_allclose(masked.weight_sum.numpy(),
                               scat.weight_sum.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(zeroed.xyz.numpy(), scat.xyz.numpy(), rtol=0,
                               atol=1e-6)
    full = film.add_samples_grid(st, p, l, w, (x0, y0), (gh, gw))
    assert float(full.weight_sum.sum()) > float(masked.weight_sum.sum()) > 0


# -- Whitted's queue options ------------------------------------------------

def _glass_scene(builder, glass, matte, light, t, **build_kw):
    """A glass sphere filling the view over a matte ground: most camera
    lanes spawn two live children, so a queue of about the lane count
    drops some."""
    b = builder()
    g = b.material(glass(Kr=(1.0, 1.0, 1.0), Kt=(1.0, 1.0, 1.0), index=1.5))
    w = b.material(matte(Kd=(0.8, 0.8, 0.8)))
    b.sphere(t.translate([0.0, 0.0, -2.0]), 3.0, g)
    b.sphere(t.translate([0.0, -1004.0, -2.0]), 1000.0, w)
    b.light(light(t.translate([5.0, 20.0, 10.0]), (400.0, 400.0, 400.0)))
    return b.build(**build_kw)


def test_queue_capacity_drops_match_jax_planar(jax_renders):
    """queue_capacity as in JAX's planar li, cap = max(capacity, lanes):
    at 250 for 196 lanes children overflow, and the drop count, the
    useful rays and the image match JAX's."""
    from trace_tpu_torch.core import transform as T
    from trace_tpu_torch.lights.lights import point_light
    from trace_tpu_torch.materials.materials import (GlassMaterial,
                                                     MatteMaterial)
    from trace_tpu_torch.scene import SceneBuilder

    img_j, drops_j, useful_j = jax_renders["queue"]
    tsc = _glass_scene(SceneBuilder, GlassMaterial, MatteMaterial,
                       point_light, T, device="cpu")
    out = {}
    for cap in (250, None, 1000):
        tcam = TSph.build_camera(12, "unused.png")
        ti = WhittedIntegrator(tcam, UniformSampler(1, seed=0),
                               max_depth=DEPTH, queue_capacity=cap)
        out[cap] = (tcam.film.to_image(ti.render(tsc)).numpy(),
                    ti.last_queue_drops, ti.last_useful_rays)
    img, drops, useful = out[250]
    print(f"queue_capacity 250: drops {drops} (JAX {drops_j}), MSE "
          f"{mse(img, img_j):.3e}")
    assert drops == drops_j > 0
    assert useful == useful_j
    assert mse(img, img_j) < MSE_GATE
    # A larger queue drops less; one that holds every child drops none.
    assert out[None][1] > drops > out[1000][1] == 0


@pytest.fixture(scope="module")
def sorted_render(scene):
    return _render(scene, pixel_chunk=CHUNK, sort_materials=True)


def test_sort_materials_matches_jax_packed_sort(jax_renders, sorted_render):
    """sort_materials=True on the planar queue against the JAX package's
    sort (on its packed li): the MSE gate."""
    img_j, _, drops_j = jax_renders["sorted"]
    _, img, integ = sorted_render
    print(f"sort_materials vs JAX's packed sort: MSE {mse(img, img_j):.3e}, "
          f"max abs {np.abs(img - img_j).max():.3e}")
    assert mse(img, img_j) < MSE_GATE
    assert integ.last_queue_drops == drops_j == 0


def test_sort_materials_equals_unsorted_without_drops(chunked,
                                                      sorted_render):
    """With no drops the sorted queue shades the same lanes: each level's
    radiance adds in rounds of distinct pixels, so the film is the same
    bits."""
    a, _, integ = sorted_render
    b, _, integ_u = chunked[None]
    assert integ.last_queue_drops == integ_u.last_queue_drops == 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert integ.last_useful_rays == integ_u.last_useful_rays


def test_li_impl_packed_is_refused():
    cam = TSph.build_camera(4, "unused.png")
    for impl in ("auto", "planar"):
        assert WhittedIntegrator(cam, li_impl=impl).li_impl == impl
    with pytest.raises(NotImplementedError, match="planar"):
        WhittedIntegrator(cam, li_impl="packed")
