"""The traced-geometry route with pre-built tables (render(geometry=,
geometry_accel=), integrators/common.py), as bench config 6
(``mesh16m_whitted_256``) drives it, at small size, against the JAX
package.

Scene: mesh_heavy's 5k heightfield (4,802 triangles), Whitted 32^2, 1
spp, depth 2, seed 0; clusters of 64 in supers of 32 (bench.py:962). The
frame's accelerator comes three ways:

- a ClusterAccel with the scene's ``anim_stage_clusters`` /
  ``anim_ray_chunk`` set (stage 16, so a call sweeps several stages;
  chunks of 512 rays): against the JAX package's same call, MSE < 5e-4
  (the repo's image gate);
- the sweep at group 64 (GL 4096) with ``anim_block_rays`` 128: against
  the JAX package's same call (``from_tables``, Pallas in interpret
  mode), MSE < 5e-4;
- bench.py's flat leg, a ClusterAccel built positionally (super 1, chunk
  256): against the super-32 frame, MSE < 5e-4 (the JAX package's field
  order, so the same positional line builds the same accelerator).

Also: the knobs reach the accelerators; host tables go to the device once
(the accelerator built at the first frame serves the next, with the same
tensors); a caller's accelerator keeps its tensors; ``triangles_host``.
"""
import numpy as np
import pytest
import torch

from trace_tpu.accel import clusters as JC
from trace_tpu.integrators.whitted import WhittedIntegrator as JWhitted
from trace_tpu.models import mesh_heavy as JMH
from trace_tpu.ops import sweep_pallas as JS
from trace_tpu.sampler.uniform import UniformSampler as JSampler
from trace_tpu_torch import convert as C
from trace_tpu_torch.accel import clusters as TC
from trace_tpu_torch.integrators import common as TCm
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.models import mesh_heavy as TMH
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.sampler.uniform import UniformSampler
from trace_tpu_torch.shapes import triangle as TTri

RES = 32
MSE_GATE = 5e-4
KNOBS = {"clusters": dict(anim_stage_clusters=16, anim_ray_chunk=512,
                          anim_block_rays=None),
         "sweep": dict(anim_stage_clusters=None, anim_ray_chunk=512,
                       anim_block_rays=128),
         "flat": dict(anim_stage_clusters=16, anim_ray_chunk=256,
                      anim_block_rays=None)}


def _set_knobs(scene, leg):
    for k, v in KNOBS[leg].items():
        setattr(scene, k, v)
    scene.bump_version()


def _frame(integ_cls, sampler_cls, scene, tris, accel, models=TMH):
    integ = integ_cls(models.build_camera(RES, "unused.png"), sampler_cls(
        1, seed=0), max_depth=2)
    state = integ.render(scene, geometry=tris, geometry_accel=accel)
    return np.asarray(integ.camera.film.to_image(state))


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene, JAX clusters, port clusters) at 5k."""
    js = JMH.build_scene(5000)
    ts = TMH.build_scene(5000, device="cpu")
    ja = JC.build_clusters(js.triangles_host, leaf_tris=64, super_size=32)
    ta = TC.build_clusters(ts.triangles_host, leaf_tris=64, super_size=32)
    return js, ts, ja, ta


@pytest.fixture(scope="module")
def jax_frames(scenes):
    """The JAX package's clusters and sweep frames (jitted, once each)."""
    import copy
    from concurrent.futures import ThreadPoolExecutor

    js, _, ja, _ = scenes
    sweep = JS.PallasSweepAccelerator(ja, group=64, block_rays=128,
                                      ray_chunk=512, interpret=True)
    # One shallow scene copy a leg (the knobs are its attributes); the two
    # renders run in threads, their XLA compiles overlapping.
    jobs = {}
    for leg, acc in (("clusters", ja), ("sweep", sweep)):
        view = copy.copy(js)
        _set_knobs(view, leg)
        jobs[leg] = (view, acc)
    with ThreadPoolExecutor(2) as ex:
        futures = {leg: ex.submit(_frame, JWhitted, JSampler, v,
                                  js.triangles_host, acc, JMH)
                   for leg, (v, acc) in jobs.items()}
        return {leg: f.result() for leg, f in futures.items()}


def _mse(a, b):
    return float(np.mean((a - b) ** 2))


def test_triangles_host_and_field_order(scenes):
    js, ts, ja, ta = scenes
    for f in TTri.Triangles._fields:
        np.testing.assert_array_equal(getattr(ts.triangles_host, f),
                                      np.asarray(getattr(js.triangles_host,
                                                         f)), err_msg=f)
    view = ts.with_geometry(TTri.to_device(ts.triangles, "cpu"))
    assert isinstance(view.triangles.v0, torch.Tensor)
    assert isinstance(view.triangles_host.v0, np.ndarray)
    np.testing.assert_array_equal(view.triangles_host.v0, js.triangles_host.v0)
    assert TC.ClusterAccel._fields == tuple(
        JC.ClusterAccel.__dataclass_fields__)
    # bench.py:1014-1016's positional flat leg, in both packages.
    jflat = JC.ClusterAccel(ja.c_lo, ja.c_hi, ja.c_lo, ja.c_hi, ja.packed,
                            ja.packed_mt, ja.tri_id, ja.leaf_tris, 1)
    tflat = TC.ClusterAccel(ta.c_lo, ta.c_hi, ta.c_lo, ta.c_hi, ta.packed,
                            ta.packed_mt, ta.tri_id, ta.leaf_tris, 1)
    conv = C.cluster_accel(jflat)
    for f in TC.ClusterAccel._fields:
        np.testing.assert_array_equal(np.asarray(getattr(conv, f)),
                                      np.asarray(getattr(tflat, f)),
                                      err_msg=f)


@pytest.mark.parametrize("leg", ["clusters", "sweep"])
def test_frame_matches_jax(scenes, jax_frames, leg):
    _, ts, _, ta = scenes
    _set_knobs(ts, leg)
    accel = (ta if leg == "clusters" else
             TS.SweepAccelerator(ta, "cpu", group=64, block_rays=128))
    img = _frame(WhittedIntegrator, UniformSampler, ts, ts.triangles_host,
                 accel)
    assert img.shape == jax_frames[leg].shape and np.isfinite(img).all()
    assert (img > 0).any(-1).mean() > 0.3
    assert _mse(img, jax_frames[leg]) < MSE_GATE


def test_flat_leg_matches_super_leg(scenes):
    _, ts, _, ta = scenes
    flat = TC.ClusterAccel(ta.c_lo, ta.c_hi, ta.c_lo, ta.c_hi, ta.packed,
                           ta.packed_mt, ta.tri_id, ta.leaf_tris, 1)
    _set_knobs(ts, "clusters")
    sup = _frame(WhittedIntegrator, UniformSampler, ts, ts.triangles_host, ta)
    _set_knobs(ts, "flat")
    img = _frame(WhittedIntegrator, UniformSampler, ts, ts.triangles_host,
                 flat)
    assert _mse(img, sup) < MSE_GATE and (img > 0).any(-1).mean() > 0.3


def _accel_of(scene, tris, accel):
    return TCm.apply_geometry(scene, TCm.prepare_geometry(
        scene, tris, accel=accel)).accel


def test_knobs_reach_the_accelerators_and_tables_upload_once(scenes):
    _, ts, _, ta = scenes
    tris = ts.triangles_host
    _set_knobs(ts, "clusters")
    first = _accel_of(ts, tris, ta)
    assert isinstance(first, TC.ClusterAccelerator)
    assert (first.stage_clusters, first.ray_chunk, first.certified) == (
        16, 512, False)
    again = _accel_of(ts, tris, ta)
    assert again is first and ts.geometry_cache[2] is first
    ptr = first.dev_clusters.packed_mt.data_ptr()
    # Unset knobs: JAX's rule (stage 64 below 200,000 triangles, chunk
    # 16384) -- a new accelerator, the old one dropped.
    for k in KNOBS["clusters"]:
        setattr(ts, k, None)
    dflt = _accel_of(ts, tris, ta)
    assert dflt is not first and (dflt.stage_clusters, dflt.ray_chunk) == (
        64, 16384)
    assert first.dev_clusters.packed_mt.data_ptr() == ptr

    tables = TS.SweepTables(ta, 64)
    sw = _accel_of(ts, tris, tables)
    assert (sw.block_rays, sw.ray_chunk) == (32, 65536)   # the port's
    assert _accel_of(ts, tris, tables) is sw
    _set_knobs(ts, "sweep")
    sw128 = _accel_of(ts, tris, tables)
    assert (sw128.block_rays, sw128.ray_chunk) == (128, 512)
    given = TS.SweepAccelerator(ta, "cpu", group=64)
    view = _accel_of(ts, tris, given)
    assert view is not given and (view.block_rays, view.ray_chunk) == (
        128, 512)
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        assert getattr(view, f).data_ptr() == getattr(given, f).data_ptr()
    cl = TC.ClusterAccelerator(ta, "cpu", stage_clusters=8)
    cview = _accel_of(ts, tris, cl)
    assert (cview.stage_clusters, cview.ray_chunk) == (64, 512)
    assert cview.dev_clusters is cl.dev_clusters
    with pytest.raises(TypeError, match="geometry_accel"):
        _accel_of(ts, tris, tris)
