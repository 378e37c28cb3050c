"""The port's camera (camera/perspective.py) against the JAX package's
``PerspectiveCamera``, for both conventions ("reference": the Julia
code's literal matrices; "pbrt": the standard chain), pinhole and thin
lens, on the same film points, lens and time samples; and the
transforms the "pbrt" chain needs (core/transform.py).

Tolerances: transforms equal as arrays; rays rtol 1e-5 with an absolute
floor of 1e-6 (the film, camera and Whitted slices' tolerance for camera
rays); the JAX package's own camera checks as it states them
(tests/test_film_camera_sampler.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trace_tpu.camera.perspective import PerspectiveCamera as JCamera
from trace_tpu.core import transform as JT
from trace_tpu.film.film import Film as JFilm
from trace_tpu_torch.camera.perspective import PerspectiveCamera as TCamera
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.film.film import Film as TFilm
from trace_tpu_torch.models import env_studio as TE

RTOL, ATOL = 1e-5, 1e-6
FIELDS = ("o", "d", "t_max", "time", "has_differentials", "rx_origin",
          "ry_origin", "rx_direction", "ry_direction")


def _t(mod):
    return {"rotate_x": mod.rotate_x(-90.0),
            "rotate_x_37": mod.rotate_x(37.0),
            "perspective_pbrt": mod.perspective_pbrt(35.0, 1e-2, 1000.0),
            "pbrt_screen": mod.compose(
                mod.perspective_pbrt(60.0, 1e-2, 1000.0),
                mod.scale(1.0, 1.0, -1.0))}


@pytest.mark.parametrize("name", sorted(_t(TT)))
def test_transforms_equal_jax(name):
    t, j = _t(TT)[name], _t(JT)[name]
    np.testing.assert_array_equal(t.m, np.asarray(j.m))
    np.testing.assert_array_equal(t.inv_m, np.asarray(j.inv_m))


def _cams(convention, lens_radius, res=(48, 40), fov=60.0,
          window=((-1.0, -1.0), (1.0, 1.0))):
    kw = dict(screen_window=window, shutter_open=0.25, shutter_close=0.75,
              lens_radius=lens_radius, focal_distance=4.5, fov=fov,
              convention=convention)
    xf = ([1.0, 2.0, 3.0], [0.5, -0.2, -4.0], [0.0, 1.0, 0.0])
    return (TCamera(TT.look_at(*xf), film=TFilm(res, filename="unused.png"),
                    **kw),
            JCamera(JT.look_at(*xf), film=JFilm(res, filename="unused.png"),
                    **kw))


def _samples(n, res, seed):
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(1.0, res[0] + 1.0, n),
                  rng.uniform(1.0, res[1] + 1.0, n)], -1).astype(np.float32)
    u_lens = rng.uniform(size=(n, 2)).astype(np.float32)
    u_time = rng.uniform(size=n).astype(np.float32)
    return p, u_lens, u_time


@pytest.mark.parametrize("lens_radius", [0.0, 0.15])
@pytest.mark.parametrize("convention", ["reference", "pbrt"])
def test_rays_match_jax(convention, lens_radius):
    tc, jc = _cams(convention, lens_radius)
    p, ul, ut = _samples(2048, (48, 40), 3)
    trd, tw = tc.generate_ray_differentials(*map(torch.from_numpy,
                                                 (p, ul, ut)))
    jrd, jw = jc.generate_ray_differentials(*map(jnp.asarray, (p, ul, ut)))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(trd, f).numpy(),
                                   np.asarray(getattr(jrd, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_env_studio_camera_rays_match_jax():
    from trace_tpu.models import env_studio as JE

    tc, jc = TE.build_camera(32, "unused.png"), JE.build_camera(
        32, "unused.png")
    p, ul, ut = _samples(1024, (32, 32), 4)
    trd, _ = tc.generate_ray_differentials(*map(torch.from_numpy,
                                                (p, ul, ut)))
    jrd, _ = jc.generate_ray_differentials(*map(jnp.asarray, (p, ul, ut)))
    for f in ("o", "d", "rx_direction", "ry_direction"):
        np.testing.assert_allclose(getattr(trd, f).numpy(),
                                   np.asarray(getattr(jrd, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)


def test_pbrt_camera_aims_at_target():
    eye, target = [1.0, 2.0, 3.0], [4.0, 0.0, -5.0]
    cam = TCamera(TT.look_at(eye, target, [0.0, 1.0, 0.0]), fov=90.0,
                  film=TFilm((64, 64), filename="unused.png"),
                  convention="pbrt")
    p = torch.tensor([[32.5, 32.5], [1.0, 1.0], [64.0, 64.0]])
    rd, _ = cam.generate_ray_differentials(p, torch.zeros(3, 2),
                                           torch.zeros(3))
    d = rd.d.numpy()
    want = np.array(target, np.float32) - np.array(eye, np.float32)
    want /= np.linalg.norm(want)
    assert np.allclose(d[0], want, atol=0.05), (d[0], want)
    assert float(np.dot(d[1], d[2])) < 0.5    # ~90 degrees of view
    assert np.allclose(rd.o.numpy(), np.array(eye), atol=1e-4)


@pytest.mark.parametrize("convention", ["reference", "pbrt"])
def test_lens_rays_converge_at_focal_plane(convention):
    # Camera-space rays head into the scene (d.z < 0) and meet at the
    # focal plane z = -focal_distance.
    fd = 5.0
    cam = TCamera(TT.identity(), film=TFilm((64, 64), filename="unused.png"),
                  fov=60.0, convention=convention, lens_radius=0.2,
                  focal_distance=fd)
    p = torch.tensor([[20.5, 40.5]]).repeat(8, 1)
    u = torch.from_numpy(np.random.default_rng(7).uniform(
        size=(8, 2)).astype(np.float32))
    o, d = (x.numpy() for x in cam._one_ray(p, u))
    assert np.all(d[:, 2] < 0)
    t = (-fd - o[:, 2]) / d[:, 2]
    assert np.all(t > 0)
    pts = o + t[:, None] * d
    assert np.max(np.ptp(pts, axis=0)) < 1e-4


def test_zero_radius_limit_is_the_pinhole():
    film = TFilm((32, 32), filename="unused.png")
    p = torch.tensor([[10.5, 22.5]])
    u = torch.tensor([[0.3, 0.8]])
    o0, d0 = TCamera(TT.identity(), film=film, fov=60.0)._one_ray(p, u)
    o1, d1 = TCamera(TT.identity(), film=film, fov=60.0, lens_radius=1e-5,
                     focal_distance=5.0)._one_ray(p, u)
    assert not o0.any() and o1.abs().max() <= 1e-5
    np.testing.assert_allclose(d0.numpy(), d1.numpy(), atol=1e-4)
