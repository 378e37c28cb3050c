"""The port's Whitted slice on ``mesh_heavy`` against the JAX package.

Scene: mesh_heavy(target_tris=5000), 32^2, 1 spp, depth 2, seed 0. The
JAX side renders with its CPU default accelerator (the cluster sweep);
the port renders on CPU tensors through the plain sweep.

The golden ``tests/goldens/mesh_heavy5k_32.npy`` holds the JAX render,
made by::

    scene = trace_tpu.models.mesh_heavy.build_scene(target_tris=5000)
    cam = trace_tpu.models.mesh_heavy.build_camera(resolution=32)
    state = WhittedIntegrator(cam, UniformSampler(1, seed=0),
                              max_depth=2).render(scene)
    np.save(path, np.asarray(cam.film.to_image(state)))

Tolerances: whole images by the repo's MSE gate (< 5e-4,
test_io_compare.py). The live JAX render runs under jit, where XLA fuses
and contracts f32 arithmetic; op-by-op the two packages agree to ~1e-7,
but a borderline shadow ray can flip (observed: one lane, max-abs 0.2
on one pixel). Camera rays, film splat and first hits: rtol 1e-5 with
an absolute floor of 1e-6 for near-zero components.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trace_tpu.integrators.whitted import WhittedIntegrator as JWhitted
from trace_tpu.models import mesh_heavy as JM
from trace_tpu.sampler import uniform as JU
from trace_tpu.wavefront import geom as JG
from trace_tpu.wavefront import whitted as JWF
from trace_tpu_torch.convert import GLASS, MATTE, scene_from_numpy
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.models import mesh_heavy as TM
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.sampler import uniform as TU
from trace_tpu_torch.shapes.sphere import Spheres
from trace_tpu_torch.shapes.triangle import Triangles
from trace_tpu_torch.wavefront import geom as TG
from trace_tpu_torch.wavefront import whitted as TWF
from torch_jax_arrays import jax_rules

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "mesh_heavy5k_32.npy")
MSE_GATE = 5e-4
RES, TRIS, DEPTH = 32, 5000, 2


def _mse(a, b) -> float:
    return float(np.mean((np.asarray(a, np.float32) - b) ** 2))


@pytest.fixture(scope="module")
def jax_scene():
    return JM.build_scene(target_tris=TRIS)


@pytest.fixture(scope="module")
def jax_img(jax_scene):
    cam = JM.build_camera(resolution=RES, filename="unused.png")
    state = JWhitted(cam, JU.UniformSampler(1, seed=0),
                     max_depth=DEPTH).render(jax_scene)
    return np.asarray(cam.film.to_image(state))


def _port_render(scene):
    cam = TM.build_camera(RES, "unused.png")
    integ = WhittedIntegrator(cam, TU.UniformSampler(1, seed=0),
                              max_depth=DEPTH)
    img = cam.film.to_image(integ.render(scene)).numpy()
    return img, integ


@pytest.fixture(scope="module")
def port_scene():
    return TM.build_scene(target_tris=TRIS, device="cpu")


def test_render_matches_live_jax(jax_img, port_scene):
    launches = TS.sweep_kernel.launches
    img, integ = _port_render(port_scene)
    assert TS.sweep_kernel.launches == launches  # CPU: the plain version
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    assert integ.last_queue_drops == 0
    assert (img > 0).any(-1).mean() > 0.2
    mse = _mse(img, jax_img)
    diff = np.abs(img - jax_img)
    print(f"port vs live JAX: MSE {mse:.3e}, max abs {diff.max():.4f}, "
          f"pixels off by > 1e-3: {int((diff.max(-1) > 1e-3).sum())}")
    assert mse < MSE_GATE


def test_golden_equals_live_jax(jax_img):
    golden = np.load(GOLDEN)
    # Same call, same package; only XLA's code generation for another
    # host CPU could move the last bits.
    np.testing.assert_allclose(jax_img, golden, rtol=0, atol=1e-5)


def _arrays_from_jax(scene) -> dict:
    from trace_tpu.accel.clusters import build_clusters
    from trace_tpu.materials.materials import GlassMaterial, MatteMaterial
    from trace_tpu.ops.sweep_pallas import SweepTables

    a = {}
    for f in Spheres._fields:
        a["sphere_" + f] = np.asarray(getattr(scene.spheres_host, f))
    for f in Triangles._fields:
        a["tri_" + f] = np.asarray(getattr(scene.triangles_host, f))
    a["light_kind"] = np.asarray(scene.lights.kind)
    a["light_p"] = np.asarray(scene.lights.p)
    a["light_i"] = np.asarray(scene.lights.i)
    kinds, params = [], []
    for m in scene.materials:
        if isinstance(m, MatteMaterial):
            kinds.append(MATTE)
            params.append([*m.Kd.value, m.sigma.value, 0.0, 0.0, 0.0])
        elif isinstance(m, GlassMaterial):
            kinds.append(GLASS)
            params.append([*m.Kr.value, *m.Kt.value, m.index.value])
    a["material_kind"] = np.asarray(kinds, np.int32)
    a["material_params"] = np.asarray(params, np.float32)
    tb = SweepTables(build_clusters(scene.triangles_host, 64, 4), 8)
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        a[f] = np.asarray(getattr(tb, f))
    return a


def test_scene_from_numpy_equals_scene_builder(jax_scene, port_scene):
    conv = scene_from_numpy(_arrays_from_jax(jax_scene), "cpu")
    assert torch.equal(conv.triangle_rows, port_scene.triangle_rows)
    assert torch.equal(conv.sphere_rows, port_scene.sphere_rows)
    assert torch.equal(conv.accel.panel, port_scene.accel.panel)
    assert torch.equal(conv.accel.slot_to_tri, port_scene.accel.slot_to_tri)
    img_c, _ = _port_render(conv)
    img_b, _ = _port_render(port_scene)
    np.testing.assert_array_equal(img_c, img_b)


def test_scene_from_numpy_takes_half_panels_exact_edges_and_fused_b(
        jax_scene, port_scene):
    from trace_tpu.accel.clusters import build_clusters
    from trace_tpu.ops.intersect_pallas import pack_tris
    from trace_tpu.ops.sweep_pallas import SweepTables
    from trace_tpu_torch.ops import intersect as TI

    a = _arrays_from_jax(jax_scene)
    jtb = SweepTables(build_clusters(jax_scene.triangles_host, 64, 4), 8,
                      panel_hilo=True)
    a["panel"] = np.asarray(jtb.panel).view(np.uint16)
    a["exact_edges"] = True
    conv = scene_from_numpy(a, "cpu")
    assert conv.exact_edges and conv.accel.certified
    assert conv.accel.tables.panel_hilo
    assert conv.accel.panel.dtype == torch.bfloat16
    assert conv.accel.panel.shape[1] == 32
    th = jax_scene.triangles_host
    a["fused_b"] = pack_tris(th.v0, th.v1, th.v2)
    fused = scene_from_numpy(a, "cpu")
    assert isinstance(fused.accel, TI.IntersectAccelerator)
    tr = port_scene.triangles
    panel, ids = TI.pack_tris(tr.v0, tr.v1, tr.v2)
    np.testing.assert_array_equal(fused.accel.tris.numpy(), panel)
    np.testing.assert_array_equal(fused.accel.ids.numpy(), ids)


def _camera_inputs(n=257, seed=3):
    rng = np.random.default_rng(seed)
    p_film = rng.uniform(0.0, RES + 2.0, (n, 2)).astype(np.float32)
    u_lens = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    u_time = rng.uniform(0.0, 1.0, n).astype(np.float32)
    return p_film, u_lens, u_time


def test_camera_rays_match_jax():
    jc = JM.build_camera(resolution=RES, filename="unused.png")
    tc = TM.build_camera(RES, "unused.png")
    p_film, u_lens, u_time = _camera_inputs()
    jrd, jw = jc.generate_ray_differentials(
        jnp.asarray(p_film), jnp.asarray(u_lens), jnp.asarray(u_time))
    trd, tw = tc.generate_ray_differentials(
        torch.from_numpy(p_film), torch.from_numpy(u_lens),
        torch.from_numpy(u_time))
    for f in ("o", "d", "t_max", "time", "has_differentials", "rx_origin",
              "ry_origin", "rx_direction", "ry_direction"):
        np.testing.assert_allclose(getattr(trd, f).numpy(),
                                   np.asarray(getattr(jrd, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_film_splat_and_image_match_jax():
    jc = JM.build_camera(resolution=RES, filename="unused.png")
    tc = TM.build_camera(RES, "unused.png")
    (x0, y0), (x1, y1) = tc.film.sample_bounds()
    assert ((x0, y0), (x1, y1)) == jc.film.sample_bounds()
    gh, gw = y1 - y0 + 1, x1 - x0 + 1
    gx, gy = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1),
                         indexing="xy")
    rng = np.random.default_rng(9)
    p_film = (np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
              + rng.uniform(0, 1, (gh * gw, 2))).astype(np.float32)
    L = rng.exponential(0.5, (gh * gw, 3)).astype(np.float32)
    w = rng.uniform(0.5, 1.0, gh * gw).astype(np.float32)
    js = jc.film.add_samples_grid(jc.film.initial_state(), jnp.asarray(p_film),
                                  jnp.asarray(L), jnp.asarray(w), (x0, y0),
                                  (gh, gw))
    ts = tc.film.add_samples_grid(tc.film.initial_state("cpu"),
                                  torch.from_numpy(p_film),
                                  torch.from_numpy(L), torch.from_numpy(w),
                                  (x0, y0), (gh, gw))
    np.testing.assert_allclose(ts.xyz.numpy(), np.asarray(js.xyz),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.weight_sum.numpy(),
                               np.asarray(js.weight_sum), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tc.film.to_image(ts).numpy(),
                               np.asarray(jc.film.to_image(js)), rtol=1e-5,
                               atol=1e-6)


def test_first_hits_match_jax(jax_scene, port_scene):
    jc = JM.build_camera(resolution=RES, filename="unused.png")
    tc = TM.build_camera(RES, "unused.png")
    p_film, u_lens, u_time = _camera_inputs(n=512, seed=4)
    jrd, _ = jc.generate_ray_differentials(
        jnp.asarray(p_film), jnp.asarray(u_lens), jnp.asarray(u_time))
    trd, _ = tc.generate_ray_differentials(
        torch.from_numpy(p_film), torch.from_numpy(u_lens),
        torch.from_numpy(u_time))
    jp = JG.RayP.of(jrd)
    tp = TG.RayP.of(trd)
    jh = JWF.closest_hit(jax_scene, jp.o, jp.d, jrd.t_max, jrd.time)
    with jax_rules():
        th = TWF.closest_hit(port_scene, tp.o, tp.d, trd.t_max, trd.time)
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), valid)
    assert valid.sum() > 50
    np.testing.assert_array_equal(th.prim_id.numpy()[valid],
                                  np.asarray(jh.prim_id)[valid])
    np.testing.assert_array_equal(th.material_id.numpy()[valid],
                                  np.asarray(jh.material_id)[valid])
    for f in ("p", "n", "ns", "wo"):
        np.testing.assert_allclose(getattr(th, f).arr().numpy()[valid],
                                   np.asarray(getattr(jh, f).arr())[valid],
                                   rtol=1e-5, atol=1e-6, err_msg=f)
