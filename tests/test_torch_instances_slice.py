"""Instanced scenes through the port's three integrators, whole.

- A scene with both instanced kinds (tetrahedra with per-copy materials,
  one mirrored; clipped spheres), a flat floor and a point light, built by
  the JAX package and carried across by convert.py: Whitted (24^2, 1
  spp, depth 3), the path tracer (16^2, 4 spp, depth 3) and SPPM (16^2, 2
  iterations of 1024 photons, depth 3, radius 0.3) against the JAX
  package's renders, which take its packed li (its planar path refuses
  instanced scenes): MSE < 5e-4 and every pixel within 1e-4.
- Instanced against flattened inside the port (test_instances.py's
  pairs, Whitted 24^2): MSE < 1e-6.
- The path tracer's BSDF-sampling leg gives an instanced hit no area-light
  emission (the counterpart of test_instances.py's
  test_bsdf_mis_leg_ignores_instanced_hits): within 1e-5 of the scene
  with the instances baked flat.
- sphere_field at n = 6, 32^2, against tests/goldens/sphere_field6_32.npy,
  the JAX package's render made on the CPU by::

      scene = trace_tpu.models.sphere_field.build_scene(n=6)
      cam = build_camera(resolution=32, filename="unused.png")
      state = WhittedIntegrator(cam, UniformSampler(1, seed=0),
                                max_depth=2).render(scene)
      np.save("tests/goldens/sphere_field6_32.npy",
              np.asarray(cam.film.to_image(state)))

  MSE < 5e-4.
"""
import os

import numpy as np
import pytest
import torch

from test_torch_instances import (grid_mesh, sphere_entry,
                                  sphere_transforms, tetra)
from torch_jax_arrays import jax_rules, mse, port_scene
from trace_tpu.camera.perspective import PerspectiveCamera as JCamera
from trace_tpu.core import transform as JT
from trace_tpu.film.film import Film as JFilm
from trace_tpu.film.filters import LanczosSincFilter as JLanczos
from trace_tpu.integrators.path import PathIntegrator as JPath
from trace_tpu.integrators.sppm import SPPMIntegrator as JSPPM
from trace_tpu.integrators.whitted import WhittedIntegrator as JWhitted
from trace_tpu.lights import lights as JL
from trace_tpu.materials import materials as JM
from trace_tpu.sampler.uniform import UniformSampler as JSampler
from trace_tpu.scene import SceneBuilder as JSceneBuilder
from trace_tpu_torch.camera.perspective import PerspectiveCamera as TCamera
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.core.vec import V3
from trace_tpu_torch.film.film import Film as TFilm
from trace_tpu_torch.film.filters import LanczosSincFilter as TLanczos
from trace_tpu_torch.integrators.path import PathIntegrator
from trace_tpu_torch.integrators.sppm import SPPMIntegrator
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.lights import lights as TL
from trace_tpu_torch.materials import materials as TM
from trace_tpu_torch.models import sphere_field as TSF
from trace_tpu_torch.sampler.uniform import UniformSampler
from trace_tpu_torch.scene import SceneBuilder as TSceneBuilder
from trace_tpu_torch.wavefront import materials as WM
from trace_tpu_torch.wavefront import path as WP
from trace_tpu_torch.wavefront import shade as S
from trace_tpu_torch.wavefront import whitted as WW

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
MSE_GATE = 5e-4
PIXEL_ATOL = 1e-4
FLAT_GATE = 1e-6


def _combo():
    """The JAX scene: both instanced kinds over a flat floor."""
    b = JSceneBuilder()
    matte = b.material(JM.MatteMaterial(Kd=(0.7, 0.6, 0.5)))
    plastic = b.material(JM.PlasticMaterial(Kd=(0.6, 0.3, 0.2),
                                            Ks=(0.3, 0.3, 0.3),
                                            roughness=0.1))
    glass = b.material(JM.GlassMaterial(Kr=(1, 1, 1), Kt=(1, 1, 1),
                                        index=1.5))
    idx, verts = tetra()
    trs = [JT.translate([0.0, 0.0, -3.0]),
           JT.compose(JT.translate([2.0, 0.5, -4.0]), JT.rotate_y(40.0)),
           JT.compose(JT.translate([-2.0, -0.5, -5.0]), JT.rotate_x(25.0),
                      JT.scale(1.5, 0.8, 1.2)),
           JT.compose(JT.translate([0.2, 1.2, -3.2]),
                      JT.scale(-1.0, 1.0, 1.0))]
    b.instanced_mesh(idx, verts, trs, matte,
                     material_ids=[-1, plastic, -1, glass])
    b.instanced_spheres(
        [dict(sphere_entry(JT, True), radius=0.5, material_id=plastic)],
        [JT.translate([1.6 * k - 2.4, -0.9, -4.5]) for k in range(4)])
    fv = np.array([[-6, -1.5, 0], [6, -1.5, 0], [6, -1.5, -9],
                   [-6, -1.5, -9]], np.float32)
    b.triangle_mesh(JT.identity(), np.array([[0, 1, 2], [0, 2, 3]],
                                            np.uint32), fv, matte)
    b.light(JL.point_light(JT.translate([0.0, 5.0, 0.0]),
                           (60.0, 60.0, 60.0)))
    return b.build()


def _camera(mod, film_mod, lanczos, cam_mod, res):
    film = film_mod((res, res), filter=lanczos((1.0, 1.0), 3.0),
                    filename="unused.png")
    return cam_mod(mod.look_at([0.0, 0.8, 3.0], [0.0, 0.0, -4.5],
                               [0.0, 1.0, 0.0]),
                   fov=55.0, film=film, convention="pbrt")


def _jcam(res):
    return _camera(JT, JFilm, JLanczos, JCamera, res)


def _tcam(res):
    return _camera(TT, TFilm, TLanczos, TCamera, res)


SPPM_KW = dict(initial_search_radius=0.3, max_depth=3, n_iterations=2,
               photons_per_iteration=1024, seed=0)


@pytest.fixture(scope="module")
def combo():
    """The JAX scene, its port, and the JAX package's three renders."""
    js = _combo()
    out = dict(js=js, ts=port_scene(js))
    cam = _jcam(24)
    st = JWhitted(cam, JSampler(1, seed=2), max_depth=3).render(js)
    out["whitted"] = np.asarray(cam.film.to_image(st))
    cam = _jcam(16)
    st = JPath(cam, JSampler(4, seed=3), max_depth=3).render(js)
    out["path"] = np.asarray(cam.film.to_image(st))
    integ = JSPPM(_jcam(16), **SPPM_KW)
    out["sppm"] = np.asarray(integ.to_image(integ.render(js), 2))
    return out


def _gate(img, ref, label, gate=MSE_GATE, atol=PIXEL_ATOL):
    err = mse(img, ref)
    diff = float(np.abs(img - ref).max())
    print(f"{label}: MSE {err:.3e}, max abs {diff:.3e}, lit pixels "
          f"{float((ref.max(-1) > 1e-3).mean()):.2f}")
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert err < gate and diff <= atol
    assert (ref.max(-1) > 1e-3).mean() > 0.3


def test_combo_scene_carried_across(combo):
    js, ts = combo["js"], combo["ts"]
    assert [type(g).__name__ for g in ts.instanced] == [
        "InstancedGeometry", "InstancedSpheres"]
    assert ts.instanced_offsets == js._instanced_offsets == [2, 18]
    np.testing.assert_array_equal(ts.world_lo, js.world_lo)
    np.testing.assert_array_equal(ts.world_hi, js.world_hi)


def test_whitted_matches_jax(combo):
    cam = _tcam(24)
    integ = WhittedIntegrator(cam, UniformSampler(1, seed=2), max_depth=3)
    img = cam.film.to_image(integ.render(combo["ts"])).numpy()
    assert integ.last_queue_drops == 0
    _gate(img, combo["whitted"], "Whitted 24^2")


def test_path_matches_jax(combo):
    cam = _tcam(16)
    with jax_rules():
        img = cam.film.to_image(PathIntegrator(
            cam, UniformSampler(4, seed=3), max_depth=3).render(
                combo["ts"])).numpy()
    _gate(img, combo["path"], "path 16^2")


def test_sppm_matches_jax(combo):
    integ = SPPMIntegrator(_tcam(16), device="cpu", **SPPM_KW)
    img = integ.to_image(integ.render(combo["ts"]), 2).numpy()
    _gate(img, combo["sppm"], "SPPM 16^2")


def _pair_transforms():
    return [TT.translate([0.0, 0.0, -3.0]),
            TT.compose(TT.translate([2.0, 0.5, -4.0]), TT.rotate_y(40.0)),
            TT.compose(TT.translate([-2.0, -0.5, -5.0]),
                       TT.compose(TT.rotate_x(25.0),
                                  TT.scale(1.5, 0.8, 1.2))),
            TT.compose(TT.translate([0.5, 2.0, -6.0]), TT.rotate_z(70.0))]


def _light():
    return TL.point_light(TT.translate([0.0, 5.0, 0.0]), (50.0, 50.0, 50.0))


def _flat_pair(kind):
    """(instanced, flattened) port scenes of test_instances.py's pairs."""
    bi, bf = TSceneBuilder(), TSceneBuilder()
    mi = bi.material(TM.MatteMaterial(Kd=(0.7, 0.6, 0.5)))
    mf = bf.material(TM.MatteMaterial(Kd=(0.7, 0.6, 0.5)))
    if kind == "spheres":
        entry = sphere_entry(TT, True)
        trs = sphere_transforms(TT, 3)[:9]
        bi.instanced_spheres([dict(entry, material_id=mi)], trs)
        for t in trs:
            bf.sphere(TT.compose(t, entry["object_to_world"]),
                      entry["radius"], mf,
                      **{k: entry[k] for k in ("z_min", "z_max", "phi_max")})
    else:
        idx, verts = tetra() if kind == "tetra" else grid_mesh()
        bi.instanced_mesh(idx, verts, _pair_transforms(), mi)
        for t in _pair_transforms():
            bf.triangle_mesh(t, idx, verts, mf)
    for b in (bi, bf):
        b.light(_light())
    return bi.build(device="cpu"), bf.build(device="cpu")


@pytest.mark.parametrize("kind", ["tetra", "grid", "spheres"])
def test_instanced_matches_flattened(kind):
    inst, flat = _flat_pair(kind)
    assert inst.n_triangles == 0 and inst.n_spheres == 0
    if kind == "grid":
        assert inst.instanced[0].accel is not None and flat.accel is not None

    def render(scene):
        film = TFilm((24, 24), filter=TLanczos((1.0, 1.0), 3.0),
                     filename="unused.png")
        target = [0.0, 0.0, -6.0] if kind == "spheres" else [0.0, 0.0, -4.0]
        cam = TCamera(TT.look_at([0.0, 0.3, 4.0], target, [0.0, 1.0, 0.0]),
                      film=film, convention="pbrt")
        st = WhittedIntegrator(cam, UniformSampler(1, seed=2),
                               max_depth=2).render(scene)
        return film.to_image(st).numpy()

    img_i, img_f = render(inst), render(flat)
    err = mse(img_i, img_f)
    print(f"{kind}: instanced vs flattened MSE {err:.3e}")
    assert np.isfinite(img_i).all() and img_i.max() > 0.01
    assert err < FLAT_GATE


def test_bsdf_mis_leg_ignores_instanced_hits():
    """An instanced plate between the floor and an area light: the BSDF
    leg's hits on it carry no emission, as with the plate baked flat."""
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    floor_v = np.array([[-10, 0, -10], [10, 0, -10], [10, 0, 10],
                        [-10, 0, 10]], np.float32)
    plate_v = np.array([[0.2, 1.0, -3.0], [3.0, 1.0, -3.0], [3.0, 1.0, 3.0],
                        [0.2, 1.0, 3.0]], np.float32)
    light_v = np.array([[-2, 6, -2], [2, 6, -2], [2, 6, 2], [-2, 6, 2]],
                       np.float32)

    def build(baked):
        b = TSceneBuilder()
        matte = b.material(TM.MatteMaterial())
        b.triangle_mesh(TT.identity(), quad, floor_v, matte)
        if baked:
            b.triangle_mesh(TT.identity(), quad, plate_v, matte)
        # The light panel last among the flat triangles.
        b.triangle_mesh(TT.identity(), quad, light_v, matte,
                        emission=(8.0, 8.0, 8.0))
        if not baked:
            b.instanced_mesh(quad, plate_v, [TT.identity(),
                                             TT.translate([7.0, 0.0, 0.0])],
                             matte)
        return b.build(device="cpu")

    s_inst, s_flat = build(False), build(True)
    assert s_inst.instanced and not s_flat.instanced
    n = 256
    px = torch.linspace(-0.5, 0.5, n)
    o = V3(px, torch.full((n,), 3.0), torch.zeros(n))
    d = V3(torch.zeros(n), torch.full((n,), -1.0), torch.zeros(n))
    hit = WW.closest_hit(s_inst, o, d, torch.full((n,), float("inf")),
                         torch.zeros(n))
    assert bool(hit.valid.all())
    lobes = WM.compute_scattering(s_inst.materials, hit,
                                  allow_multiple_lobes=True, mode=S.RADIANCE)
    u = torch.from_numpy(np.random.default_rng(5).uniform(
        size=(4, n)).astype(np.float32))
    light0 = torch.zeros(n, dtype=torch.int32)
    ld_i = WP.estimate_direct(s_inst, hit, lobes, light0, *u).arr()
    ld_f = WP.estimate_direct(s_flat, hit, lobes, light0, *u).arr()
    assert torch.isfinite(ld_i).all()
    # Some BSDF rays reach the plate (instanced in one, flat in the other).
    o2 = hit.p + V3(torch.zeros(n), torch.full((n,), 1e-3), torch.zeros(n))
    up = V3(torch.zeros(n), torch.ones(n), torch.zeros(n))
    assert bool(WW.closest_hit(s_inst, o2, up, torch.full((n,), 9.0),
                               torch.zeros(n)).valid.any())
    np.testing.assert_allclose(ld_i.numpy(), ld_f.numpy(), atol=1e-5)


def test_sphere_field_golden():
    scene = TSF.build_scene(n=6, device="cpu")
    assert scene.instanced and scene.instanced[0].n_instances == 36
    cam = TSF.build_camera(32, "unused.png")
    integ = WhittedIntegrator(cam, UniformSampler(1, seed=0), max_depth=2)
    img = cam.film.to_image(integ.render(scene)).numpy()
    golden = np.load(os.path.join(GOLDENS, "sphere_field6_32.npy"))
    err = mse(img, golden)
    print(f"sphere_field 6x6 32^2: MSE {err:.3e}, max abs "
          f"{float(np.abs(img - golden).max()):.3e}")
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert err < MSE_GATE
    assert img.max() > 0.02 and img.std() > 1e-3
