"""The port's path tracer (wavefront/path.py, integrators/path.py) against
the JAX package's planar twins, on the Cornell box (matte and plastic,
one ceiling area light).

Tolerances: direct lighting per lane rtol 1e-5 with an absolute floor of
1e-6; whole renders by the repo's MSE gate (< 5e-4), with the max abs
difference printed. Russian roulette (``u_rr < q``) turns a last-ulp
difference of the throughput into another path, so whole path-traced
images are not held to bit equality: the two JAX goldens of this scene
already differ on such lanes (tests/test_path.py:142-161). The golden
``tests/goldens/cornell48_planar.npy`` is the JAX planar path's own.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_jax_arrays import (both3, jax_rules, lane_keys, mse, np3,
                              port_scene)
from trace_tpu.models import cornell as JC
from trace_tpu.wavefront import geom as JG
from trace_tpu.wavefront import materials as JWM
from trace_tpu.wavefront import path as JP
from trace_tpu.wavefront import whitted as JWF
from trace_tpu_torch.accel.clusters import build_clusters
from trace_tpu_torch.integrators.path import PathIntegrator
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.models import cornell as TC
from trace_tpu_torch.models import spheres as TSph
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.sampler import uniform as TU
from trace_tpu_torch.scene import Scene
from trace_tpu_torch.wavefront import geom as TG
from trace_tpu_torch.wavefront import materials as TWM
from trace_tpu_torch.wavefront import path as TP
from trace_tpu_torch.wavefront import whitted as TWF

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "cornell48_planar.npy")
MSE_GATE = 5e-4


@pytest.fixture(scope="module")
def cornell():
    js = JC.build_scene()
    return js, port_scene(js)


def _hits(cornell, res=48):
    """First hits of the Cornell camera's rays (one per pixel centre), in
    both packages, with their lobe tables."""
    js, ts = cornell
    cam = TC.build_camera(res, "unused.png")
    (x0, y0), (x1, y1) = cam.film.sample_bounds()
    gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
    p_film = (np.stack([gx.ravel(), gy.ravel()], -1) + 0.5).astype(np.float32)
    n = p_film.shape[0]
    rd, _ = cam.generate_ray_differentials(
        torch.from_numpy(p_film), torch.zeros(n, 2), torch.zeros(n))
    o, d = rd.o.numpy(), rd.d.numpy()
    to, jo = both3(o)
    td, jd = both3(d)
    inf = np.full(n, np.inf, np.float32)
    with jax_rules():
        th = TWF.closest_hit(ts, to, td, torch.from_numpy(inf),
                             torch.zeros(n))
    jh = JWF.closest_hit(js, jo, jd, jnp.asarray(inf), jnp.zeros(n))
    np.testing.assert_array_equal(th.valid.numpy(), np.asarray(jh.valid))
    np.testing.assert_array_equal(th.prim_id.numpy(), np.asarray(jh.prim_id))
    tl = TWM.compute_scattering(ts.materials, th, allow_multiple_lobes=True)
    jl = JWM.compute_scattering(js.materials, jh, allow_multiple_lobes=True)
    return th, jh, tl, jl, n


def _close(t, j, msg):
    np.testing.assert_allclose(np3(t), np3(j), rtol=1e-5, atol=1e-6,
                               err_msg=msg)


def test_estimate_direct_matches_jax(cornell):
    js, ts = cornell
    th, jh, tl, jl, n = _hits(cornell)
    rng = np.random.default_rng(4)
    u = rng.uniform(0, 1, (4, n)).astype(np.float32)
    # The port's estimator takes a light per lane: light 0 on every lane.
    with jax_rules():
        t = TP.estimate_direct(ts, th, tl, torch.zeros(n, dtype=torch.int32),
                               *[torch.from_numpy(x) for x in u])
    j = JP._estimate_direct_static(js, 0, jh, jl, *[jnp.asarray(x) for x in u])
    _close(t, j, "estimate_direct")
    assert int((np3(t).max(-1) > 0).sum()) > n // 4


def test_uniform_sample_one_light_matches_jax(cornell):
    js, ts = cornell
    th, jh, tl, jl, n = _hits(cornell)
    tk, jk = lane_keys(9, n)
    with jax_rules():
        t = TP.uniform_sample_one_light(ts, th, tl, tk)
    j = JP.uniform_sample_one_light(js, jh, jl, jk)
    _close(t, j, "uniform_sample_one_light")
    assert int((np3(t).max(-1) > 0).sum()) > n // 4


def _render_path(scene, res, spp, seed, depth):
    cam = TC.build_camera(res, "unused.png")
    integ = PathIntegrator(cam, TU.UniformSampler(spp, seed=seed),
                           max_depth=depth)
    return cam.film.to_image(integ.render(scene)).numpy(), integ


def test_cornell48_matches_jax_planar_golden():
    img, integ = _render_path(TC.build_scene(device="cpu"), 48, 8, 3, 4)
    golden = np.load(GOLDEN)
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert integ.last_queue_drops == 0 and integ.last_useful_rays > 0
    print(f"Cornell 48^2 8 spp vs the JAX planar golden: MSE "
          f"{mse(img, golden):.3e}, max abs {np.abs(img - golden).max():.4f}")
    assert mse(img, golden) < MSE_GATE


def test_path_depth1_equals_whitted_with_a_delta_light():
    scene = TSph.build_scene(device="cpu")
    imgs = []
    for cls in (WhittedIntegrator, PathIntegrator):
        cam = TSph.build_camera(24, "unused.png")
        st = cls(cam, TU.UniformSampler(2, seed=7), max_depth=1).render(scene)
        imgs.append(cam.film.to_image(st).numpy())
    np.testing.assert_allclose(imgs[1], imgs[0], atol=2e-5)
    assert imgs[0].max() > 0.05


def test_path_through_the_sweep_matches_brute_force():
    """The same Cornell box with its 12 triangles behind the sweep (the
    route of every scene above 64 triangles) renders like the brute-force
    route."""
    brute = TC.build_scene(device="cpu")
    swept = Scene(brute.spheres, brute.triangles, brute.materials,
                  brute.lights, "cpu",
                  sweep_tables=TS.SweepTables(
                      build_clusters(brute.triangles, 64, 4), 8),
                  tri_light_id=brute.tri_light_id.numpy())
    assert brute.accel is None and swept.accel is not None
    a, _ = _render_path(brute, 24, 2, 5, 3)
    b, integ = _render_path(swept, 24, 2, 5, 3)
    print(f"Cornell 24^2 through the sweep vs brute force: MSE "
          f"{mse(b, a):.3e}, max abs {np.abs(b - a).max():.4f}")
    assert mse(b, a) < 1e-6 and integ.last_useful_rays > 0


def test_path_refuses_what_it_cannot_render():
    with pytest.raises(NotImplementedError):
        PathIntegrator(TC.build_camera(8, "unused.png"), li_impl="packed")
    from trace_tpu_torch.core import transform as TT
    from trace_tpu_torch.materials.materials import MatteMaterial
    from trace_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    m = b.material(MatteMaterial())
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    for y in (1.0, 2.0):
        b.triangle_mesh(TT.identity(), quad, np.array(
            [[0, y, 0], [1, y, 0], [1, y, 1], [0, y, 1]], np.float32), m,
            emission=(1.0, 1.0, 1.0))
    # Two area lights: the per-lane light pick takes them; an unported
    # material is refused.
    TP.supports(b.build(device="cpu"))
    b.material(object())
    with pytest.raises(NotImplementedError):
        TP.supports(b.build(device="cpu"))


def test_li_matches_op_by_op_jax_on_every_lane(cornell):
    """One sample per pixel of a 48^2 frame through both packages' li
    (depth 3, Russian roulette from bounce 2). JAX runs op by op: under
    jit, XLA's code for the same li parts from its own op-by-op run on
    ~7% of the lanes (the 48^2 golden's difference), the port does not."""
    import jax
    from trace_tpu.core.ray import RayDifferentials as JRD

    js, ts = cornell
    # 48^2 as the tests above: JAX's op-by-op executables for these
    # shapes are compiled already.
    cam = TC.build_camera(48, "unused.png")
    (x0, y0), (x1, y1) = cam.film.sample_bounds()
    gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
    rng = np.random.default_rng(0)
    p_film = (np.stack([gx.ravel(), gy.ravel()], -1)
              + rng.uniform(0, 1, (gx.size, 2))).astype(np.float32)
    n = p_film.shape[0]
    rd, _ = cam.generate_ray_differentials(
        torch.from_numpy(p_film), torch.zeros(n, 2), torch.zeros(n))
    jrd = JRD(*[jnp.asarray(getattr(rd, f).numpy()) for f in (
        "o", "d", "t_max", "time", "has_differentials", "rx_origin",
        "ry_origin", "rx_direction", "ry_direction")])
    tk, jk = lane_keys(5, n)
    with jax_rules():
        t, aux = TP.li(ts, rd, tk, 3, 2)
    with jax.disable_jit():
        j, jaux = JP.li(js, jrd, jk, 3, 2, return_aux=True)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-5)
    assert int(aux["useful_rays"]) == int(jaux["useful_rays"])
    assert float(t.max()) > 0.1
