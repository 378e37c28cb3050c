"""The port's samplers with strata against the JAX package's: the 1D
distribution, the stratified sampler and its standalone camera samples,
and the render loop's stratum remap.

Gates: Distribution1D and get_camera_samples bit-equal to JAX op by op on
the same inputs and key; the render loop's p_film bit-equal to the JAX
loop's ``_sample_body`` lane by lane (both op by op); every film sample
inside its stratum; a stratified shadows 16^2 Whitted frame within the
repo's MSE gate (< 5e-4) of tests/goldens/shadows16_strat2x2.npy, which
the JAX package rendered (jitted, on the CPU) with:

    scene = trace_tpu.models.spheres.build_scene()
    cam = build_camera(resolution=16, filename="unused.png")
    st = WhittedIntegrator(cam, StratifiedSampler(2, 2, seed=11),
                           max_depth=3).render(scene)
    np.save(path, np.asarray(cam.film.to_image(st)))
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_arrays import mse
from trace_tpu.integrators.whitted import WhittedIntegrator as JWhitted
from trace_tpu.models import spheres as JSph
from trace_tpu.sampler import stratified as JS
from trace_tpu.sampler.distribution import Distribution1D as JD
from trace_tpu.sampler.uniform import UniformSampler as JUniform
from trace_tpu_torch.integrators import base as TB
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.models import spheres as TSph
from trace_tpu_torch.sampler import stratified as TS
from trace_tpu_torch.sampler import uniform as U
from trace_tpu_torch.sampler.distribution import Distribution1D
from trace_tpu_torch.sampler.uniform import UniformSampler

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "shadows16_strat2x2.npy")
MSE_GATE = 5e-4
FUNCS = [[1.0, 3.0], [1.0, 3.0, 2.0], [0.0, 0.0, 0.0],
         [0.5, 0.0, 2.0, 7.0, 1e-3]]


def _us(n=4096, seed=1):
    u = np.random.default_rng(seed).random(n).astype(np.float32)
    u[:6] = [0.0, 1e-9, 0.25, 0.5, np.float32(0.99999994), 0.75]
    return u


@pytest.mark.parametrize("func", FUNCS, ids=["two", "three", "zero", "five"])
def test_distribution1d_matches_jax(func):
    jd, td = JD(func), Distribution1D(func)
    np.testing.assert_array_equal(td.cdf, jd.cdf)
    assert td.func_int == jd.func_int
    u = _us()
    for j, t in ((jd.sample_discrete(jnp.asarray(u)),
                  td.sample_discrete(torch.from_numpy(u))),
                 (jd.sample_continuous(jnp.asarray(u)),
                  td.sample_continuous(torch.from_numpy(u)))):
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_distribution1d_values():
    # test_film_camera_sampler.py's and test_sampler_parallel.py's cases.
    d = Distribution1D([1.0, 3.0])
    idx, pdf, rem = d.sample_discrete(torch.tensor([0.1, 0.5, 0.9]))
    assert idx.tolist() == [0, 1, 1] and idx.dtype == torch.int32
    np.testing.assert_allclose(pdf.numpy(), [0.25, 0.75, 0.75], atol=1e-6)
    assert float(rem[0]) == pytest.approx(0.4, abs=1e-6)
    x, pdf, idx = d.sample_continuous(torch.tensor([0.5, 0.1]))
    assert idx.tolist() == [1, 0]
    np.testing.assert_allclose(pdf.numpy(), [1.5, 0.5], rtol=1e-6)
    assert 0.5 <= float(x[0]) < 1.0 and 0.0 <= float(x[1]) < 0.5


def test_split_and_uniform_match_jax():
    for seed in (0, 7, 2**31 + 5):
        k = jax.random.key(seed)
        tk = U.key(seed, "cpu")
        for a, b in zip(jax.random.split(k, 3), U.split(tk, 3)):
            for shape in ((5,), (7, 2), (3, 4, 2)):
                np.testing.assert_array_equal(
                    U.uniform(b, shape).numpy(),
                    np.asarray(jax.random.uniform(a, shape, jnp.float32)))


@pytest.mark.parametrize("jitter", [True, False])
def test_get_camera_samples_matches_jax(jitter):
    pix = np.random.default_rng(0).integers(1, 60, (300, 2)).astype(np.int32)
    for seed in (0, 11):
        js = JS.StratifiedSampler(2, 3, jitter=jitter, seed=seed)
        ts = TS.StratifiedSampler(2, 3, jitter=jitter, seed=seed)
        assert ts.samples_per_pixel == js.samples_per_pixel == 6
        for idx in range(6):
            assert ts.stratum(idx) == js.stratum(idx)
            j = JS.get_camera_samples(js, jax.random.key(seed + idx),
                                      jnp.asarray(pix), idx)
            t = TS.get_camera_samples(ts, U.key(seed + idx, "cpu"),
                                      torch.from_numpy(pix), idx)
            for a, b in zip(j, t):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_stratified_samples_land_in_strata():
    # test_sampler_parallel.py's case on the port.
    s = TS.StratifiedSampler(2, 2, jitter=True, seed=0)
    pix = torch.tensor([[5, 9]] * 64, dtype=torch.int32)
    seen = []
    for idx in range(4):
        p, _, _ = TS.get_camera_samples(s, U.key(idx, "cpu"), pix, idx)
        off = p.numpy() - np.array([5, 9], np.float32)
        sx, sy = s.stratum(idx)
        assert (off[:, 0] >= sx / 2).all() and (off[:, 0] < (sx + 1) / 2).all()
        assert (off[:, 1] >= sy / 2).all() and (off[:, 1] < (sy + 1) / 2).all()
        seen.append((sx, sy))
    assert sorted(seen) == [(0, 0), (0, 1), (1, 0), (1, 1)]


class _Captured(Exception):
    pass


class _CaptureCamera:
    """A JAX camera stand-in: records p_film, then stops the sample body
    before any ray is traced."""

    def __init__(self, film):
        self.film = film

    def generate_ray_differentials(self, p_film, u_lens, u_time):
        raise _Captured(np.asarray(p_film))


def _jax_p_film(sampler, res=8):
    """p_film of each sample of the JAX loop's _sample_body, op by op."""
    cam = JSph.build_camera(resolution=res, filename="unused.png")
    integ = JWhitted(_CaptureCamera(cam.film), sampler, max_depth=1)
    pixels = jnp.asarray(integ._pixel_grid())
    valid = jnp.ones(pixels.shape[0], bool)
    out = []
    base = jax.random.key(sampler.seed)
    for s in range(sampler.samples_per_pixel):
        lo, scale = integ._stratum_arrays(jnp.int32(s))
        try:
            integ._sample_body(None, (None, None), pixels, valid,
                               jax.random.fold_in(base, s), lo, scale)
        except _Captured as c:
            out.append(c.args[0])
    return np.asarray(integ._pixel_grid()), out


def _port_p_film(sampler, res=8):
    """p_film of each sample of the port's render loop (li stubbed)."""
    scene = TSph.build_scene(device="cpu")
    cam = TSph.build_camera(resolution=res, filename="unused.png")
    integ = WhittedIntegrator(cam, sampler, max_depth=1)
    seen = []
    gen = cam.generate_ray_differentials

    def capture(p_film, u_lens, u_time):
        seen.append(p_film.numpy().copy())
        return gen(p_film, u_lens, u_time)

    def li(scene, rd, keys):
        z = torch.zeros((), dtype=torch.int64)
        return torch.zeros((rd.o.shape[0], 3)), {"queue_drops": z,
                                                 "useful_rays": z}

    cam.generate_ray_differentials = capture
    integ.li = li
    integ.render(scene)
    return integ.pixel_grid("cpu").numpy(), seen


@pytest.mark.parametrize("xy", [(2, 2), (3, 2)])
def test_render_loop_remap_matches_jax_lane_by_lane(xy):
    jpix, jp = _jax_p_film(JS.StratifiedSampler(*xy, seed=5))
    tpix, tp = _port_p_film(TS.StratifiedSampler(*xy, seed=5))
    np.testing.assert_array_equal(tpix, jpix)
    assert len(tp) == len(jp) == xy[0] * xy[1]
    for s, (a, b) in enumerate(zip(jp, tp)):
        np.testing.assert_array_equal(b, a)
        # Confined to the stratum (sx, sy) of sample s.
        off = b - tpix.astype(np.float32)
        sx, sy = s % xy[0], s // xy[0]
        assert (off[:, 0] >= sx / xy[0]).all()
        assert (off[:, 0] <= (sx + 1) / xy[0]).all()
        assert (off[:, 1] >= sy / xy[1]).all()
        assert (off[:, 1] <= (sy + 1) / xy[1]).all()


def test_uniform_sampler_keeps_the_identity_remap():
    lo, scale = TB.stratum_arrays(UniformSampler(4), 4, "cpu")
    assert lo.tolist() == [[0.0, 0.0]] * 4 and scale.tolist() == [[1.0,
                                                                   1.0]] * 4
    jpix, jp = _jax_p_film(JUniform(2, seed=3))
    _, tp = _port_p_film(UniformSampler(2, seed=3))
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b, a)
    # The identity leaves the raw jitter as it was, bit for bit.
    keys = U.lane_keys(U.fold_in(U.key(3, "cpu"), 1),
                       U.pixel_ids(torch.from_numpy(jpix)))
    raw, _, _ = U.get_camera_samples_lanes(U.fold_lanes(keys, 0),
                                           torch.from_numpy(jpix))
    np.testing.assert_array_equal(tp[1], raw.numpy())


def test_stratified_shadows_frame_matches_golden():
    scene = TSph.build_scene(device="cpu")
    cam = TSph.build_camera(resolution=16, filename="unused.png")
    integ = WhittedIntegrator(cam, TS.StratifiedSampler(2, 2, seed=11),
                              max_depth=3)
    img = cam.film.to_image(integ.render(scene)).numpy()
    golden = np.load(GOLDEN)
    m = mse(img, golden)
    print(f"stratified shadows 16^2: MSE {m:.3e} against the JAX golden")
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert m < MSE_GATE
    assert integ.last_queue_drops == 0
