"""Several lights of any kind in one scene: the port's per-lane light pick
(wavefront/lights.py ``*_lanes``, wavefront/path.py ``estimate_direct``
and ``uniform_sample_one_light``, the photon walk's emission) against
the JAX package's packed functions, which is where the JAX package
renders such scenes (its planar path refuses them).

The scene is __graft_entry__.py's _dryrun_scene (flat spheres and
triangles, an instanced mesh, instanced spheres; an area, a point and an
environment light) with a spot, a distant and a second area light added,
built by chip_smoke.py's dryrun_builder from the JAX package's modules
and carried across by convert.py. JAX runs op by op
(``jax.disable_jit()``): jitted XLA contracts f32 into FMAs and parts
from its own op-by-op run on borderline lanes. Both estimators shade the
port's hit records. Tolerances: direct light per lane within rtol 2e-4 / atol 2e-5 (the planar-vs-packed
tolerance of tests/test_wavefront_equiv.py), lanes outside it counted
and at most 1 in 1000; emission as in tests/test_torch_sppm.py (at most
1.5% of the lanes of a field beyond 1e-6 relative, absolute floor 1e-7,
from last-bit sin/cos differences), every lane within rtol 1e-4 / atol
1e-5 but for environment texel-edge flips, at most 1 in 1000.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as GE
import chip_smoke as CS
from torch_jax_arrays import arrays_from_jax, lane_keys, port_scene
from trace_tpu.bxdf import lobes as JLB
from trace_tpu.integrators import common as JC
from trace_tpu.lights import lights as JL
from trace_tpu.materials.materials import compute_scattering as jscatter
from trace_tpu.sampler import uniform as JU
from trace_tpu_torch.core.vec import V3
from trace_tpu_torch.integrators import common as TC
from trace_tpu_torch.lights import lights as TL
from trace_tpu_torch.sampler import uniform as TU
from trace_tpu_torch.wavefront import lights as TWL
from trace_tpu_torch.wavefront import materials as TWM
from trace_tpu_torch.wavefront import path as TP
from trace_tpu_torch.wavefront import shade as TS
from trace_tpu_torch.wavefront import whitted as TWF

N = 1024
LI_RTOL, LI_ATOL = 2e-4, 2e-5
TOL = 1e-6
FLIPS = N // 1000


def jax_modules():
    """The JAX package's twins of chip_smoke.port_modules()."""
    from types import SimpleNamespace

    from trace_tpu.camera.perspective import PerspectiveCamera
    from trace_tpu.core import transform
    from trace_tpu.film.film import Film
    from trace_tpu.film.filters import LanczosSincFilter
    from trace_tpu.materials import materials, textures
    from trace_tpu.models.env_studio import sky_image
    from trace_tpu.scene import SceneBuilder

    return SimpleNamespace(
        T=transform, L=JL, M=materials, TX=textures,
        SceneBuilder=SceneBuilder, sky_image=sky_image, Film=Film,
        LanczosSincFilter=LanczosSincFilter,
        PerspectiveCamera=PerspectiveCamera)


def add_lights(b, ns):
    """Three more lights on a dryrun builder: a spot pointing down, a
    distant light from above and an emissive quad facing down (the
    dryrun's own panel faces up, lighting nothing below it)."""
    T, L = ns.T, ns.L
    b.light(L.spot_light(T.compose(T.translate([1.0, 2.0, -2.0]),
                                   T.rotate_x(90.0)), (5.0, 5.0, 5.0),
                         40.0, 30.0))
    b.light(L.distant_light(T.identity(), (0.5, 0.5, 0.5), (0.3, 1.0, 0.2)))
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    b.triangle_mesh(T.identity(), quad, np.array(
        [[-0.4, 1.6, -2.0], [-0.4, 1.6, -2.8], [0.4, 1.6, -2.8],
         [0.4, 1.6, -2.0]], np.float32), 0, emission=(3.0, 3.0, 3.0))
    return b


@pytest.fixture(scope="module")
def dryrun():
    """The dryrun scene with three more lights (six: two area lights, a
    point, a spot, a distant and the environment), built by the JAX
    package and carried across."""
    js = add_lights(CS.dryrun_builder(jax_modules()), jax_modules()).build()
    return js, port_scene(js)


def _rays(n=N, seed=1):
    """Rays from the dryrun camera's eye toward points over the floor,
    the spheres and the instances (a few miss into the sky)."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0.0, 0.8, 2.5]], np.float32), (n, 1))
    tgt = np.stack([rng.uniform(-2.2, 2.2, n), rng.uniform(-0.2, 0.9, n),
                    rng.uniform(-4.0, -1.2, n)], -1).astype(np.float32)
    d = tgt - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


@pytest.fixture(scope="module")
def hits(dryrun):
    """The port's closest hits of _rays() and the lobes there, and the same
    hit records handed to JAX as its packed SurfaceHit (both estimators
    shade bit-identical hits; the hits themselves are held to JAX's in
    tests/test_torch_instances.py and test_torch_env.py)."""
    from trace_tpu.core.vec import V3 as JV3
    from trace_tpu.wavefront import geom as JG

    js, ts = dryrun
    o, d = _rays()
    th = TWF.closest_hit(ts, V3.of(torch.from_numpy(o)),
                         V3.of(torch.from_numpy(d)),
                         torch.full((N,), float("inf")), torch.zeros(N))
    jh = JG.hitp_to_packed(JG.HitP(*[
        JV3(*[jnp.asarray(c.numpy()) for c in f]) if isinstance(f, V3)
        else jnp.asarray(f.numpy()) for f in th]))
    tl = TWM.compute_scattering(ts.materials, th, allow_multiple_lobes=True,
                                mode=TS.RADIANCE)
    with jax.disable_jit():
        jl = jscatter(js.materials, jh, allow_multiple_lobes=True,
                      mode=JLB.RADIANCE)
    assert int(th.valid.sum()) > N // 3
    return th, jh, tl, jl


def _per_lane(t, j, label):
    t, j = np.stack([np.asarray(c) for c in t], -1), np.asarray(j)
    assert np.isfinite(t).all()
    bad = ~np.all(np.abs(t - j) <= LI_ATOL + LI_RTOL * np.abs(j), axis=-1)
    lit = int((np.abs(j).max(-1) > 0).sum())
    print(f"{label}: lanes outside rtol {LI_RTOL} / atol {LI_ATOL}: "
          f"{int(bad.sum())} of {t.shape[0]} ({lit} lit)")
    assert bad.sum() <= FLIPS, np.flatnonzero(bad)[:8]
    return lit


def test_dryrun_builder_is_the_graft_entry_scene(dryrun):
    """chip_smoke.py's dryrun_builder, given the JAX package's modules,
    builds __graft_entry__.py's _dryrun_scene, array for array."""
    a = arrays_from_jax(GE._dryrun_scene().build())
    b = arrays_from_jax(CS.dryrun_builder(jax_modules()).build())
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)
    ts = dryrun[1]
    assert sorted(int(k) for k in ts.lights.kind) == sorted(
        [TL.AREA, TL.AREA, TL.POINT, TL.SPOT, TL.DISTANT, TL.INFINITE])
    assert len(ts.instanced) == 2 and ts.env is not None


def test_estimate_direct_matches_packed_jax(dryrun, hits):
    """Every lane's light index cycles through the six lights."""
    js, ts = dryrun
    th, jh, tl, jl = hits
    idx = (np.arange(N) % 6).astype(np.int32)
    u = np.random.default_rng(4).uniform(0, 1, (4, N)).astype(np.float32)
    t = TP.estimate_direct(ts, th, tl, torch.from_numpy(idx),
                           *[torch.from_numpy(x) for x in u])
    with jax.disable_jit():
        j = JC.estimate_direct(js, jh, jl, jnp.asarray(idx),
                               jnp.asarray(u[:2].T), jnp.asarray(u[2:].T))
    lit = _per_lane(t, j, "estimate_direct")
    up = int(np.flatnonzero(np.asarray(js.tri_light_id) >= 0)[0])
    up = int(np.asarray(js.tri_light_id)[up])   # the dryrun's own panel
    for k in set(range(6)) - {up}:   # each other light lights lanes
        assert (np.asarray(j)[idx == k].max(-1) > 0).sum() > 10, k
    assert lit > N // 5


def test_uniform_sample_one_light_matches_packed_jax(dryrun, hits):
    js, ts = dryrun
    th, jh, tl, jl = hits
    tk, jk = lane_keys(9, N)
    n_l = TWL.light_count(ts)
    pick_t = (TU.uniform_lanes(tk, 5)[:, 0] * n_l).to(torch.int32)
    pick_j = jnp.minimum((JU.uniform_lanes(jk, 5)[:, 0] * n_l).astype(
        jnp.int32), n_l - 1)
    np.testing.assert_array_equal(pick_t.clamp_max(n_l - 1).numpy(),
                                  np.asarray(pick_j))
    assert len(np.unique(np.asarray(pick_j))) == 6
    t = TP.uniform_sample_one_light(ts, th, tl, tk)
    with jax.disable_jit():
        j = JC.uniform_sample_one_light(js, jh, jl, jk)
    assert _per_lane(t, j, "uniform_sample_one_light") > N // 5


def test_photon_emission_matches_packed_sample_le(dryrun):
    """The light pick by power (cdf, pmf) and sample_le at JAX's
    light_num: origins on the area light, env disk origins, pdf_pos and
    pdf_dir per kind."""
    js, ts = dryrun
    cdf_t = TC.light_power_cdf(ts)
    cdf_j = np.asarray(JC.light_power_cdf(js))
    np.testing.assert_allclose(cdf_t, cdf_j, rtol=TOL, atol=TOL)
    rng = np.random.default_rng(12)
    u = rng.uniform(0, 1, (6, N)).astype(np.float32)
    num = np.minimum((cdf_j[None, :] < u[0][:, None]).sum(1),
                     len(cdf_j) - 1).astype(np.int32)
    assert len(np.unique(num)) == 6
    t = TWL.sample_le_lanes(ts, torch.from_numpy(num),
                            *[torch.from_numpy(x) for x in u[1:5]],
                            torch.from_numpy(u[5]))
    with jax.disable_jit():
        j = JL.sample_le(js.lights, jnp.asarray(num), jnp.asarray(u[1:3].T),
                         jnp.asarray(u[3:5].T), jnp.asarray(u[5]),
                         tris=js.triangles, max_area_tris=js.max_area_tris)
    env = int(np.flatnonzero(np.asarray(js.lights.kind) == JL.INFINITE)[0])
    flips = np.zeros(N, bool)
    fine = {}
    for name, a, b in zip(("le", "o", "d", "n_light", "pdf_pos", "pdf_dir"),
                          t, j):
        a = a.arr().numpy() if isinstance(a, V3) else a.numpy()
        b = np.asarray(b)
        # XLA's and torch's f32 sin/cos differ in the last bit on some
        # inputs; the cone, disk and hemisphere maps and the spot falloff
        # amplify it (tests/test_torch_sppm.py's sample_le tolerance).
        off = ~np.isclose(a, b, rtol=TOL, atol=TOL / 10)
        off = off.any(-1) if off.ndim > 1 else off
        fine[name] = int(off.sum())
        assert off.mean() <= 0.015, (name, off.mean())
        far = ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
        far = far.any(-1) if far.ndim > 1 else far
        flips |= far
    print(f"emission lanes beyond 1e-6 per field {fine}; beyond rtol 1e-4 "
          f"/ atol 1e-5: {int(flips.sum())} of {N} (env lanes "
          f"{int((num == env).sum())})")
    assert flips.sum() <= FLIPS and not flips[num != env].any()


def _count_traces(monkeypatch):
    calls = []
    traced = TWF._triangles

    def count(scene, o, d, t_max, live, any_hit):
        calls.append(any_hit)
        return traced(scene, o, d, t_max, live, any_hit)

    monkeypatch.setattr(TWF, "_triangles", count)
    return calls


def _port_dryrun(extra: bool):
    """The port's own dryrun scene (chip_smoke.py's builder), with
    add_lights' three more lights if ``extra``."""
    ns = CS.port_modules()
    b = CS.dryrun_builder(ns)
    if extra:
        add_lights(b, ns)
    return b.build(device="cpu"), CS.dryrun_camera(ns, 16)


@pytest.mark.parametrize("extra", [False, True])
def test_one_shadow_and_one_bsdf_call_a_bounce(monkeypatch, extra):
    """However many lights, the path tracer and SPPM's camera pass trace
    one closest-hit call, one shadow-ray call and one BSDF-leg call a
    bounce (before the per-lane pick, one shadow call a light and a BSDF
    call per area or environment light)."""
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    from trace_tpu_torch.wavefront import sppm_camera as TSC

    scene, cam = _port_dryrun(extra)
    assert TWL.light_count(scene) == (6 if extra else 3)
    n = 256
    px = np.stack(np.meshgrid(np.arange(16), np.arange(16)), -1).reshape(
        -1, 2).astype(np.float32) + 0.5
    rd, _ = cam.generate_ray_differentials(
        torch.from_numpy(px), torch.zeros(n, 2), torch.zeros(n))
    keys = TU.lane_keys(TU.key(3, "cpu"), torch.arange(n))
    calls = _count_traces(monkeypatch)
    img, _ = TP.li(scene, rd, keys, max_depth=3)
    assert calls == [False, True, False] * 3 and float(img.max()) > 0
    calls.clear()
    integ = SPPMIntegrator(cam, device="cpu", **CS.DRYRUN_SPPM)
    integ.max_depth = 3
    TSC.camera_pass_body(integ, scene, integ._pixel_grid("cpu"),
                         torch.ones(n, dtype=torch.bool), TU.key(0, "cpu"))
    assert len(calls) >= 6 and calls == [False, True, False] * (
        len(calls) // 3)
