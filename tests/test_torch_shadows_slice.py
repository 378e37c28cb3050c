"""The port's slice 3 under Whitted: the ``shadows`` scene (four spheres,
a mirror floor and a white wall of two triangles each, one point light)
against the JAX package, and the brute-force triangle route that scenes
of 1-64 triangles take.

Tolerances: brute-force hits and indices exact, t rtol 1e-6; hit records
and lobe tables rtol 1e-5 with an absolute floor of 1e-6; whole renders
by the repo's MSE gate (< 5e-4, tests/test_io_compare.py), with the max
abs difference printed. The golden ``tests/goldens/shadows16.npy`` is the
JAX package's own (test_io_compare.py::test_whitted_self_golden).
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_jax_arrays import both3, jax_rules, mse, np3, port_scene
from trace_tpu.integrators.whitted import WhittedIntegrator as JWhitted
from trace_tpu.models import spheres as JSph
from trace_tpu.sampler import uniform as JU
from trace_tpu.wavefront import geom as JG
from trace_tpu.wavefront import materials as JWM
from trace_tpu.wavefront import whitted as JWF
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.models import mesh_heavy as TMH
from trace_tpu_torch.models import spheres as TSph
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.sampler import uniform as TU
from trace_tpu_torch.wavefront import geom as TG
from trace_tpu_torch.wavefront import materials as TWM
from trace_tpu_torch.wavefront import whitted as TWF

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "shadows16.npy")
MSE_GATE = 5e-4
N = 4096


@pytest.fixture(scope="module")
def jax_scene():
    return JSph.build_scene()


@pytest.fixture(scope="module")
def scene():
    return TSph.build_scene(device="cpu")


def _render(scene, res, spp, seed, depth, **kw):
    cam = TSph.build_camera(res, "unused.png")
    integ = WhittedIntegrator(cam, TU.UniformSampler(spp, seed=seed),
                              max_depth=depth, **kw)
    return cam.film.to_image(integ.render(scene)).numpy(), integ


def test_scene_tables_match_jax(jax_scene, scene):
    assert scene.accel is None and scene.n_triangles == 4
    conv = port_scene(jax_scene)
    for f in ("sphere_rows", "triangle_rows", "tri_light_id"):
        assert torch.equal(getattr(scene, f), getattr(conv, f)), f
    assert [type(m) for m in scene.materials] == \
        [type(m) for m in conv.materials]


def _rays(seed, n=N):
    """Rays from points around the scene toward points on it."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1, -0.5, -4], [2, 2, 0], (n, 3)).astype(np.float32)
    to = rng.uniform([0, 0, -3], [1, 1, -2], (n, 3)).astype(np.float32)
    d = (to - o).astype(np.float32)
    tm = rng.uniform(0.5, 3.0, n).astype(np.float32)
    tm[: n // 2] = np.inf
    return o, d, tm


@pytest.mark.parametrize("exact", [False, True])
def test_brute_force_triangles_match_jax(jax_scene, scene, exact):
    o, d, tm = _rays(1)
    to, jo = both3(o)
    td, jd = both3(d)
    th, tt, ti = TG.triangles_closest(scene.triangle_cols, to, td,
                                      torch.from_numpy(tm), exact)
    jh, jt, ji = JG.triangles_closest(jax_scene.triangles_host, jo, jd,
                                      jnp.asarray(tm))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    hit = np.asarray(jh)
    assert 200 < hit.sum() < N
    np.testing.assert_array_equal(ti.numpy()[hit], np.asarray(ji)[hit])
    np.testing.assert_allclose(tt.numpy()[hit], np.asarray(jt)[hit],
                               rtol=1e-6)
    ta = TG.triangles_anyhit(scene.triangle_cols, to, td,
                             torch.from_numpy(tm), exact)
    np.testing.assert_array_equal(
        ta.numpy(), np.asarray(JG.triangles_anyhit(jax_scene.triangles_host,
                                                   jo, jd, jnp.asarray(tm))))


def _edge_grid(n=6, per_edge=32):
    """An n x n heightfield (2 (n-1)^2 = 50 triangles) as in
    tests/test_exact_edges.py, and rays aimed at f32 points on its shared
    quad diagonals from generic origins above it."""
    rng = np.random.default_rng(0)
    xs = np.linspace(-2.0, 2.0, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gz = (0.25 * np.sin(2.1 * gx) * np.cos(1.7 * gy)
          + 0.05 * rng.normal(size=gx.shape)).astype(np.float32)
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (ii * n + jj).reshape(-1)
    tris = np.concatenate(
        [np.stack([v00, v00 + n, v00 + 1], -1),
         np.stack([v00 + 1, v00 + n, v00 + n + 1], -1)]).astype(np.uint32)
    va, vb = verts[v00 + 1], verts[v00 + n]
    s = rng.uniform(0.05, 0.95, (va.shape[0], per_edge, 1)).astype(np.float32)
    p = (va[:, None] + s * (vb - va)[:, None]).reshape(-1, 3).astype(np.float32)
    m = p.shape[0]
    o = p + np.stack([rng.uniform(-0.8, 0.8, m), rng.uniform(-0.8, 0.8, m),
                      rng.uniform(2.0, 4.0, m)], -1).astype(np.float32)
    d = (p - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True).astype(np.float32)
    return verts, tris, o, d


def test_exact_edges_close_shared_edges_like_the_packed_jax_path():
    """With exact_shared_edges the brute-force route runs the packed JAX
    contract (shapes/triangle.py intersect_all and make_hit with the
    double-single edge fallback): no ray aimed at a shared edge misses,
    and the winners agree with the packed JAX scene's."""
    from trace_tpu.core import transform as JT
    from trace_tpu.materials.materials import MatteMaterial as JMatte
    from trace_tpu.scene import SceneBuilder as JSB
    from trace_tpu.shapes import triangle as JTri
    from trace_tpu_torch.core import transform as TT
    from trace_tpu_torch.lights.lights import point_light
    from trace_tpu_torch.materials.materials import MatteMaterial
    from trace_tpu_torch.scene import SceneBuilder

    verts, tris, o, d = _edge_grid()
    m = o.shape[0]
    inf = np.full(m, np.inf, np.float32)
    to, jo = both3(o)
    td, jd = both3(d)
    misses = {}
    for exact in (False, True):
        b = SceneBuilder()
        b.triangle_mesh(TT.identity(), tris, verts, b.material(MatteMaterial()))
        b.light(point_light(TT.translate([0.0, 0.0, 6.0]), (50.0,) * 3))
        sc = b.build(device="cpu", exact_shared_edges=exact)
        assert sc.accel is None and sc.n_triangles == 50
        jb = JSB()
        jb.triangle_mesh(JT.identity(), tris, verts, jb.material(JMatte()))
        js = jb.build(exact_shared_edges=exact)
        assert js.accel is None
        th = TWF.closest_hit(sc, to, td, torch.from_numpy(inf), torch.zeros(m))
        jh = js.intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(inf))
        occ = TWF.any_hit(sc, to, td, torch.from_numpy(inf))
        misses[exact] = (int((~th.valid).sum()), int((~occ).sum()),
                         int((~np.asarray(jh.valid)).sum()))
        np.testing.assert_array_equal(th.prim_id.numpy(),
                                      np.asarray(jh.prim_id))
        np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-6)
        bh, bt, bi = TG.triangles_closest(sc.triangle_cols, to, td,
                                          torch.from_numpy(inf), exact)
        jhit, jt = JTri.intersect_all(js.triangles, jnp.asarray(o),
                                      jnp.asarray(d), jnp.asarray(inf),
                                      exact_edges=exact)
        jt = np.where(np.asarray(jhit), np.asarray(jt), np.inf)
        np.testing.assert_array_equal(bi.numpy(), jt.argmin(-1))
        np.testing.assert_allclose(bt.numpy(), jt.min(-1), rtol=1e-6)
    print(f"shared-diagonal misses (port closest, port any-hit, JAX packed):"
          f" exact edges off {misses[False]}, on {misses[True]}")
    assert misses[True] == (0, 0, 0)


@pytest.mark.parametrize("multi", [False, True])
def test_compute_scattering_at_first_hits_matches_jax(jax_scene, scene,
                                                      multi):
    o, d, tm = _rays(2)
    to, jo = both3(o)
    td, jd = both3(d)
    inf = np.full(N, np.inf, np.float32)
    with jax_rules():
        th = TWF.closest_hit(scene, to, td, torch.from_numpy(inf),
                             torch.zeros(N))
    jh = JWF.closest_hit(jax_scene, jo, jd, jnp.asarray(inf), jnp.zeros(N))
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), valid)
    np.testing.assert_array_equal(th.prim_id.numpy()[valid],
                                  np.asarray(jh.prim_id)[valid])
    for f in ("p", "n", "ns", "wo", "s_dpdu"):
        np.testing.assert_allclose(np3(getattr(th, f))[valid],
                                   np3(getattr(jh, f))[valid], rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    tl = TWM.compute_scattering(scene.materials, th, allow_multiple_lobes=multi)
    jl = JWM.compute_scattering(jax_scene.materials, jh,
                                allow_multiple_lobes=multi)
    kinds = set()
    for ts_, js_ in zip(tl.slots, jl.slots):
        np.testing.assert_array_equal(ts_.kind.numpy(), np.asarray(js_.kind))
        np.testing.assert_array_equal(ts_.fr_kind.numpy(),
                                      np.asarray(js_.fr_kind))
        for f in ("c0", "c1", "eta_a", "eta_b", "a", "b"):
            t, j = getattr(ts_, f), getattr(js_, f)
            t, j = (np3(t), np3(j)) if isinstance(t, tuple) else (
                t.numpy(), np.asarray(j))
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6, err_msg=f)
        kinds |= set(ts_.kind.unique().tolist())
    assert len(kinds) >= 3


@pytest.fixture(scope="module")
def jax_img16(jax_scene):
    cam = JSph.build_camera(resolution=16, filename="unused.png")
    state = JWhitted(cam, JU.UniformSampler(1, seed=11),
                     max_depth=3).render(jax_scene)
    return np.asarray(cam.film.to_image(state))


def test_shadows16_matches_live_jax_and_golden(scene, jax_img16):
    img, integ = _render(scene, 16, 1, 11, 3)
    golden = np.load(GOLDEN)
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert integ.last_queue_drops == 0
    for name, ref in (("live JAX", jax_img16), ("golden", golden)):
        print(f"shadows 16^2 vs {name}: MSE {mse(img, ref):.3e}, max abs "
              f"{np.abs(img - ref).max():.4f}")
        assert mse(img, ref) < MSE_GATE


def test_scene_from_numpy_renders_like_scene_builder(jax_scene, scene):
    a, _ = _render(port_scene(jax_scene), 12, 1, 4, 3)
    b, _ = _render(scene, 12, 1, 4, 3)
    np.testing.assert_array_equal(a, b)


def test_level_caps_equal_uncapped_when_nothing_drops(scene):
    full, f_integ = _render(scene, 20, 2, 0, 5)
    caps = (0.5, 0.25, 0.1875, 0.125)
    capped, c_integ = _render(scene, 20, 2, 0, 5, level_caps=caps)
    assert f_integ.last_queue_drops == 0 and c_integ.last_queue_drops == 0
    assert c_integ._resolve_caps(484) == (242, 121, 90, 60)
    np.testing.assert_array_equal(capped, full)
    # A schedule too small for the live children drops them, counted.
    tight, t_integ = _render(scene, 20, 2, 0, 5, level_caps=(8,))
    assert t_integ._resolve_caps(484) == (8, 8, 8, 8)
    assert t_integ.last_queue_drops > 0
    assert mse(tight, full) > 0


def test_sweep_scenes_still_take_the_sweep():
    small = TMH.build_scene(target_tris=200, device="cpu")
    assert small.n_triangles > 64 and isinstance(small.accel,
                                                 TS.SweepAccelerator)
