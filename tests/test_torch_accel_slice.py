"""The slice at small size: SceneBuilder.build(accelerator="wbvh" |
"clusters") and accel/bvh.py::attach on the CPU.

- The 5k-triangle mesh_heavy at 32^2 (Whitted, 1 spp, seed 0, depth 2)
  through each accelerator matches tests/goldens/mesh_heavy5k_32.npy (the
  JAX package's render) at MSE < 5e-4; one render per accelerator serves
  every assertion.
- The 13x13 shared-edge heightfield of tests/test_exact_edges.py with
  exact_shared_edges=True: the winner's detail phase trusts the
  accelerator's hit mask (as in JAX; the walks are not certified). Of the
  1152 rays aimed exactly at shared edges, the wbvh walk's watertight test
  misses 0 (with exact edges off too), and the certified clusters
  traversal 0 (ROADMAP C).
"""
import os

import numpy as np
import pytest
import torch

import torch_jax_arrays  # noqa: F401  (one torch thread per worker)
from test_torch_certified import _edge_rays, _grid
from trace_tpu_torch.accel import bvh as TB
from trace_tpu_torch.accel.clusters import ClusterAccelerator
from trace_tpu_torch.accel.wbvh import WBVHAccelerator
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.core.vec import V3
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.lights.lights import point_light
from trace_tpu_torch.materials.materials import MatteMaterial
from trace_tpu_torch.models import mesh_heavy
from trace_tpu_torch.sampler import uniform as TU
from trace_tpu_torch.scene import SceneBuilder
from trace_tpu_torch.wavefront import whitted as TWF

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                      "mesh_heavy5k_32.npy")
MSE_GATE = 5e-4
KINDS = {"wbvh": WBVHAccelerator, "clusters": ClusterAccelerator,
         "bvh": TB.BVHAccelerator}


def _scene(kind):
    if kind == "bvh":
        return TB.attach(mesh_heavy.build_scene(5000, device="cpu"))
    return mesh_heavy.build_scene(5000, device="cpu", accelerator=kind)


@pytest.fixture(scope="module")
def port_renders():
    out = {}
    for kind in KINDS:
        scene = _scene(kind)
        cam = mesh_heavy.build_camera(32, "unused.png")
        state = WhittedIntegrator(cam, TU.UniformSampler(1, seed=0),
                                  max_depth=2).render(scene)
        out[kind] = (scene, cam.film.to_image(state).numpy())
    return out


@pytest.mark.parametrize("kind", list(KINDS))
def test_frame_matches_golden(port_renders, kind):
    scene, img = port_renders[kind]
    assert isinstance(scene.accel, KINDS[kind])
    golden = np.load(GOLDEN)
    assert img.shape == golden.shape and np.isfinite(img).all()
    assert float(np.mean((img - golden) ** 2)) < MSE_GATE


def test_frames_agree_with_each_other(port_renders):
    imgs = [port_renders[k][1] for k in KINDS]
    for img in imgs[1:]:
        assert float(np.mean((img - imgs[0]) ** 2)) < 1e-6


def test_refit_each_frame_reaches_the_cluster_refit(port_renders):
    # models/caustic_moving.py's refit_each_frame calls
    # scene.accel.refit(v0, v1, v2) with the scene's own vertices; on a
    # "clusters" scene that is ClusterAccelerator.refit, which repacks the
    # same tables bit for bit.
    scene = port_renders["clusters"][0]
    acc = scene.accel
    before = acc.clusters
    cam = mesh_heavy.build_camera(32, "unused.png")
    rd, _ = cam.generate_ray_differentials(
        torch.rand(256, 2, generator=torch.Generator().manual_seed(0)) * 32,
        torch.zeros(256, 2), torch.zeros(256))
    tm = torch.full((256,), float("inf"))
    first = scene.intersect(rd.o, rd.d, tm)
    tri = scene.triangles
    scene.accel.refit(tri.v0, tri.v1, tri.v2)
    assert acc.clusters is not before
    for f in ("c_lo", "c_hi", "s_lo", "s_hi", "packed", "packed_mt",
              "tri_id"):
        np.testing.assert_array_equal(getattr(acc.clusters, f),
                                      getattr(before, f), err_msg=f)
    again = scene.intersect(rd.o, rd.d, tm)
    assert int(first.valid.sum()) > 50
    for f in ("valid", "t", "prim_id"):
        assert torch.equal(getattr(again, f), getattr(first, f))


@pytest.mark.parametrize("kind", ["wbvh", "clusters"])
def test_exact_edge_misses(kind):
    idx, verts, shared = _grid()
    o, d = _edge_rays(verts, shared)
    n = o.shape[0]
    assert n == 1152
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    inf = torch.full((n,), float("inf"))
    misses = {}
    for exact in (False, True):
        b = SceneBuilder()
        mat = b.material(MatteMaterial())
        b.triangle_mesh(TT.identity(), idx, verts, mat)
        b.light(point_light(TT.translate([0.0, 0.0, 6.0]), (50.0,) * 3))
        scene = b.build("cpu", exact_shared_edges=exact, accelerator=kind)
        assert isinstance(scene.accel, KINDS[kind])
        hit = TWF.closest_hit(scene, V3.of(ot), V3.of(dt), inf,
                              torch.zeros(n))
        misses[exact] = int((~hit.valid).sum())
    if kind == "wbvh":
        assert misses == {False: 0, True: 0}
    else:
        assert scene.accel.certified
        assert misses[True] == 0 and misses[False] > 100
