"""The port's SPPM modules against the JAX package, on the same inputs.

Tolerances:
- bit-equal: the radical inverse (dims 0-29, indices 0..2^20 and near
  2^32), the cell hash, the grid tables (sorted cells, sorted visible
  points, lo, res, inv_extent), checkpoints across packages;
- 1e-6 relative (absolute floor 1e-7): the light power CDF and PMF, the
  pixel update and the image; photon emission of point, spot, distant
  and area lights on all but 1.5% of the values, those within 1e-4
  relative (absolute floor 1e-5): XLA's and torch's float32 sin/cos
  differ in the last bit on some inputs, amplified by the cone, disk and
  hemisphere maps;
- the camera pass and the photon walk against op-by-op JAX (jitted JAX
  parts from its own op-by-op run: one ulp of the camera directions on
  half the lanes, see ROADMAP C): rtol 1e-5 with an absolute floor of
  1e-6 on every lane but at most 2% of them (the shared spread of XLA's
  and torch's transcendentals); valid flags, lobe kinds and record counts
  exact on the same lanes;
- the pair pass: phi rtol 1e-5 (float association), M exact.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_jax_arrays import port_scene
from trace_tpu.bxdf import bsdf as JB
from trace_tpu.bxdf import lobes as Jlb
from trace_tpu.core import transform as JT
from trace_tpu.integrators import common as JCm
from trace_tpu.integrators import sppm as JS
from trace_tpu.io import ply as JPly
from trace_tpu.lights import lights as JL
from trace_tpu.materials import materials as JM
from trace_tpu.models import caustic_glass as JCG
from trace_tpu.models import mesh_heavy as JMH
from trace_tpu.models import spheres as JSph
from trace_tpu.sampler import halton as JH
from trace_tpu.scene import SceneBuilder as JSceneBuilder
from trace_tpu.utils import checkpoint as JCk
from trace_tpu.wavefront import lights as JWL
from trace_tpu.wavefront import sppm_camera as JSC
from trace_tpu.wavefront import sppm_photon as JSP
from trace_tpu_torch import convert as C
from trace_tpu_torch.integrators import common as TCm
from trace_tpu_torch.integrators import sppm as TSp
from trace_tpu_torch.io import ply as TPly
from trace_tpu_torch.lights import lights as TL
from trace_tpu_torch.models import _run
from trace_tpu_torch.models import caustic_glass as TCG
from trace_tpu_torch.models import mesh_heavy as TMH
from trace_tpu_torch.models import sphere as TSphere
from trace_tpu_torch.models import spheres as TSph
from trace_tpu_torch.sampler import halton as TH
from trace_tpu_torch.sampler import uniform as TU
from trace_tpu_torch.utils import checkpoint as TCk
from trace_tpu_torch.wavefront import lights as TWL
from trace_tpu_torch.wavefront import sppm_camera as TSC
from trace_tpu_torch.wavefront import sppm_photon as TSP

F32 = np.float32
M32 = 0xFFFFFFFF


def t(x):
    return torch.from_numpy(np.array(x))


def _n(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# -- Halton ------------------------------------------------------------------


def test_radical_inverse_bit_equal_low_indices():
    a = np.arange(1 << 20, dtype=np.uint32)
    ta = torch.from_numpy(a.astype(np.int64))
    ja = jnp.asarray(a)
    for dim in range(30):
        tj = np.asarray(JH.radical_inverse(dim, ja))
        tp = TH.radical_inverse(dim, ta, a_max=int(a[-1])).numpy()
        np.testing.assert_array_equal(tp, tj, err_msg=f"dim {dim}")


def test_radical_inverse_bit_equal_near_2_32():
    rng = np.random.default_rng(0)
    a = np.concatenate([
        np.arange(M32 - 4095, M32 + 1, dtype=np.uint64),
        rng.integers(0, M32 + 1, 4096, dtype=np.uint64),
        (1 << np.arange(32, dtype=np.uint64)),
        (1 << np.arange(1, 33, dtype=np.uint64)) - 1]).astype(np.uint32)
    ta = torch.from_numpy(a.astype(np.int64))
    batched = TH.radical_inverses(range(30), ta)
    for dim in range(30):
        tj = np.asarray(JH.radical_inverse(dim, jnp.asarray(a)))
        np.testing.assert_array_equal(batched[dim].numpy(), tj,
                                      err_msg=f"dim {dim}")
    assert (batched[1] > 0.99).any()   # base-3 reversal above 2^32 reached
    assert int(TH.PRIMES[1023]) == int(JH.PRIMES[1023])


# -- hash and grid -------------------------------------------------------------


@pytest.mark.parametrize("n_pixels", [1024, 12345, 1 << 20])
def test_hash_cells_bit_equal(n_pixels):
    rng = np.random.default_rng(n_pixels)
    g = rng.integers(0, 1 << 31, (3, 8192)).astype(np.int32)
    g[:, :8] = [0, 1, 2, (1 << 31) - 1, 4095, 4096, 65535, 1 << 24]
    got = TSp._hash_cells(*[t(x) for x in g], n_pixels).numpy()
    want = np.asarray(JS._hash_cells(*[jnp.asarray(x) for x in g], n_pixels))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _jax_integ(res=8, **kw):
    cam = JSph.build_camera(res, "unused.png")
    return JS.SPPMIntegrator(cam, **kw)


def _port_integ(res=8, **kw):
    cam = TSph.build_camera(res, "unused.png")
    return TSp.SPPMIntegrator(cam, device="cpu", **kw)


def _lobes_np(n, rng, n_slots=2):
    """A packed lobe table (lambert, Oren-Nayar and empty slots)."""
    kind = rng.choice([0, Jlb.LAMBERTIAN_REFLECTION, Jlb.OREN_NAYAR],
                      (n, n_slots)).astype(np.int32)
    kind[:, 0] = np.where(kind[:, 0] == 0, Jlb.LAMBERTIAN_REFLECTION,
                          kind[:, 0])
    ng = rng.normal(size=(n, 3)).astype(F32)
    ng /= np.linalg.norm(ng, axis=1, keepdims=True)
    ss = np.cross(ng, rng.normal(size=(n, 3))).astype(F32)
    ss /= np.linalg.norm(ss, axis=1, keepdims=True)
    z = np.zeros((n, n_slots), F32)
    return dict(
        kind=kind, c0=rng.uniform(0.1, 0.9, (n, n_slots, 3)).astype(F32),
        c1=np.zeros((n, n_slots, 3), F32), eta_a=z + 1, eta_b=z + 1,
        a=np.where(kind == Jlb.OREN_NAYAR, F32(0.8), 0).astype(F32),
        b=np.where(kind == Jlb.OREN_NAYAR, F32(0.2), 0).astype(F32),
        fr_kind=np.zeros((n, n_slots), np.int32),
        fr_eta=np.zeros((n, n_slots, 3), F32),
        fr_k=np.zeros((n, n_slots, 3), F32),
        ng=ng, ns=ng, ss=ss, ts=np.cross(ng, ss).astype(F32),
        eta=np.ones(n, F32))


def _vp_pair(p, wo, beta, valid, lobes):
    """(JAX VisiblePoints, port VisiblePoints) from numpy fields."""
    jvp = JS.VisiblePoints(
        p=jnp.asarray(p), wo=jnp.asarray(wo), beta=jnp.asarray(beta),
        valid=jnp.asarray(valid),
        lobes=JB.Lobes(**{k: jnp.asarray(v) for k, v in lobes.items()}))
    tvp = TSp.VisiblePoints(
        p=t(p), wo=t(wo), beta=t(beta), valid=t(valid),
        lobes=TSp.PackedLobes(**{k: t(v) for k, v in lobes.items()}))
    return jvp, tvp


def _random_vps(n, seed, lattice=False):
    rng = np.random.default_rng(seed)
    if lattice:   # points and radii on cell boundaries
        p = (rng.integers(-8, 8, (n, 3)) * 0.5).astype(F32)
        r = np.full(n, 0.25, F32)
    else:
        p = rng.uniform(-3, 3, (n, 3)).astype(F32)
        r = rng.uniform(0.05, 0.4, n).astype(F32)
    beta = rng.uniform(0, 1, (n, 3)).astype(F32)
    beta[rng.random(n) < 0.1] = 0.0
    valid = rng.random(n) < 0.85
    wo = rng.normal(size=(n, 3)).astype(F32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    return p, wo, beta, valid, _lobes_np(n, rng), r


@pytest.mark.parametrize("case", ["random", "lattice"])
def test_build_grid_tables_bit_equal(case):
    p, wo, beta, valid, lobes, r = _random_vps(3000, 1, case == "lattice")
    jvp, tvp = _vp_pair(p, wo, beta, valid, lobes)
    jg = _jax_integ()._build_grid(jvp, jnp.asarray(r))
    tg = _port_integ()._build_grid(tvp, t(r))
    for k in ("sorted_cells", "sorted_vp", "lo", "res", "inv_extent"):
        np.testing.assert_array_equal(tg[k].numpy(), np.asarray(jg[k]),
                                      err_msg=k)
    assert tg["sorted_cells"].dtype == torch.int32
    assert int((tg["sorted_cells"] < 64).sum()) > 3000


# -- lights ------------------------------------------------------------------


def _light_scene():
    """Every ported light kind: a one-sided and a two-sided area light,
    spot, distant and point lights."""
    b = JSceneBuilder()
    white = b.material(JM.MatteMaterial(Kd=(0.8, 0.8, 0.8)))
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    b.triangle_mesh(JT.identity(), quad,
                    np.array([[-3, 0, -3], [-3, 0, 3], [3, 0, 3], [3, 0, -3]],
                             np.float32), white)
    b.triangle_mesh(JT.translate([0.0, 3.0, 0.0]), quad,
                    np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                             np.float32), white, emission=(4.0, 3.0, 2.0))
    b.triangle_mesh(JT.translate([2.0, 2.0, 0.0]), quad,
                    np.array([[0, -1, -1], [0, -0.5, 1], [0, 1, 1],
                              [0, 1, -1]], np.float32), white,
                    emission=(1.0, 2.0, 3.0), two_sided=True)
    frm = np.array([1.0, 4.0, 1.0], np.float32)
    spot = JT.compose(JT.translate(frm), JT.inverse(JT.dir_to_z(-frm)))
    b.light(JL.spot_light(spot, (30.0, 20.0, 10.0), 30.0, 20.0))
    b.light(JL.distant_light(JT.rotate_x(30.0), (0.5, 0.6, 0.7),
                             (0.3, 1.0, 0.2)))
    b.light(JL.point_light(JT.translate([-2.0, 3.0, 1.0]), (9.0, 9.0, 9.0)))
    return b.build()


@pytest.fixture(scope="module")
def light_scenes():
    js = _light_scene()
    return js, port_scene(js)


def test_light_power_cdf_matches_jax(light_scenes):
    js, ts = light_scenes
    assert list(ts.lights.kind) == [TL.AREA, TL.AREA, TL.SPOT, TL.DISTANT,
                                    TL.POINT]
    np.testing.assert_allclose(TL.power(ts.lights),
                               np.asarray(JL.power(js.lights)), rtol=1e-6)
    cdf = TCm.light_power_cdf(ts)
    jcdf = np.asarray(JCm.light_power_cdf(js))
    np.testing.assert_allclose(cdf, jcdf, rtol=1e-6)
    jpmf = jcdf - np.concatenate([[0], jcdf[:-1]])
    np.testing.assert_allclose(TCm.light_power_pmf(cdf), jpmf, rtol=1e-6,
                               atol=1e-7)
    assert cdf.dtype == np.float32 and abs(float(cdf[-1]) - 1.0) < 1e-6


@pytest.mark.parametrize("j", range(5))
def test_sample_le_static_matches_jax(light_scenes, j):
    js, ts = light_scenes
    rng = np.random.default_rng(j)
    u = rng.uniform(0, 1, (5, 4096)).astype(F32)
    u[:, :4] = [0.0, 0.5, 0.9999999, 0.25]
    got = TWL.sample_le_static(ts, j, *[t(x) for x in u])
    want = JWL.sample_le_static(js, j, *[jnp.asarray(x) for x in u])
    names = ("le", "o", "d", "n_light", "pdf_pos", "pdf_dir")
    for name, a, b in zip(names, got, want):
        a = np.stack([_n(c) for c in a], -1) if isinstance(a, tuple) \
            else _n(a)
        b = np.stack([_n(c) for c in b], -1) if isinstance(b, tuple) \
            else _n(b)
        # XLA's and torch's float32 sin/cos differ in the last bit on some
        # inputs, and the cone, disk and hemisphere maps amplify it.
        off = ~np.isclose(a, b, rtol=1e-6, atol=1e-7)
        assert off.mean() <= 0.015, (j, name, off.mean())
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=f"light {j} {name}")


# -- camera pass and photon walk -----------------------------------------------


@pytest.fixture(scope="module", params=["shadows", "mesh5k"])
def walk_scene(request):
    if request.param == "shadows":
        js, res_mod, r0 = JSph.build_scene(), (JSph, TSph), 0.25
    else:
        js, res_mod, r0 = (JMH.build_scene(target_tris=5000), (JMH, TMH),
                           1.0)
    kw = dict(initial_search_radius=r0, max_depth=4, n_iterations=2,
              photons_per_iteration=256, seed=0)
    ji = JS.SPPMIntegrator(res_mod[0].build_camera(8, "unused.png"), **kw)
    ti = TSp.SPPMIntegrator(res_mod[1].build_camera(8, "unused.png"),
                            device="cpu", **kw)
    ts = port_scene(js)
    pix = ji._pixel_grid()
    key = jax.random.fold_in(jax.random.key(0), 1)
    with jax.disable_jit():
        jld, jvp = JSC.camera_pass_body(ji, js, jnp.asarray(pix),
                                        jnp.ones(len(pix), bool), key)
        grid = ji._build_grid(jvp, jnp.full((64,), r0, jnp.float32))
        cdf = JCm.light_power_cdf(js)
        pmf = cdf - jnp.concatenate([jnp.zeros(1), cdf[:-1]])
        idx = jnp.uint32(256) + jnp.arange(256, dtype=jnp.uint32)
        jsp = JSP.photon_walk_body(ji, js, idx, jnp.ones(256, bool), cdf,
                                   pmf, grid["lo"], grid["res"],
                                   grid["inv_extent"], grid["sorted_cells"])
    tld, tvp = TSC.camera_pass_body(
        ti, ts, t(pix), torch.ones(len(pix), dtype=torch.bool),
        TU.fold_in(TU.key(0, "cpu"), 1))
    tsp = TSP.photon_walk_body(
        ti, ts, torch.arange(256, 512), torch.ones(256, dtype=torch.bool),
        t(cdf), t(pmf), t(grid["lo"]), t(grid["res"]),
        t(grid["inv_extent"]), t(grid["sorted_cells"]), idx_max=511)
    return dict(name=request.param, jld=jld, jvp=jvp, tld=tld, tvp=tvp,
                jsp=jsp, tsp=tsp)


def _lanes_off(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bad = ~np.isclose(a, b, rtol=1e-5, atol=1e-6)
    return bad.reshape(bad.shape[0], -1).any(-1)


def test_camera_pass_body_matches_op_by_op_jax(walk_scene):
    w = walk_scene
    jvp, tvp = w["jvp"], w["tvp"]
    np.testing.assert_array_equal(tvp.valid.numpy(), np.asarray(jvp.valid))
    assert tvp.valid.sum() > 8
    off = _lanes_off(w["tld"].numpy(), w["jld"])
    for f in ("p", "wo", "beta"):
        off |= _lanes_off(getattr(tvp, f).numpy(), getattr(jvp, f))
    for f in TSp.SLOT_FIELDS + ("ng", "ns", "ss", "ts", "eta"):
        a, b = getattr(tvp.lobes, f).numpy(), np.asarray(getattr(jvp.lobes, f))
        assert a.shape == b.shape, f
        if f in ("kind", "fr_kind"):
            off |= (a != b).reshape(a.shape[0], -1).any(-1)
        else:
            off |= _lanes_off(a, b)
    print(f"{w['name']}: {int(off.sum())} of {off.size} lanes off")
    assert off.mean() <= 0.02


def test_photon_walk_body_matches_op_by_op_jax(walk_scene):
    w = walk_scene
    jsp, tsp = w["jsp"], w["tsp"]
    off = np.zeros(tsp["count"].shape[0], bool)
    for k in ("p", "d", "beta"):
        assert tsp[k].shape == jsp[k].shape, k
        off |= _lanes_off(tsp[k].numpy(), jsp[k])
    for k in ("start", "count"):
        assert tsp[k].dtype == torch.int32
        off |= tsp[k].numpy() != np.asarray(jsp[k])
    print(f"{w['name']}: {int(off.sum())} of {off.size} records off, "
          f"{int(tsp['count'].sum())} candidate pairs")
    assert off.mean() <= 0.02
    assert int((tsp["count"] > 0).sum()) > 0


# -- pair pass ---------------------------------------------------------------


def test_pair_gather_matches_oracle():
    """4 visible points on a line, one photon splat near vp0 and vp1 only
    (the JAX package's test_pair_gather_matches_oracle)."""
    integ = TSp.SPPMIntegrator(TSph.build_camera(2, "unused.png"),
                               initial_search_radius=0.5, max_depth=2,
                               n_iterations=1, photons_per_iteration=4,
                               pair_chunk=64, device="cpu")
    n = 4
    lobes = {k: t(v) for k, v in _lobes_np(n, np.random.default_rng(0)
                                           ).items()}
    lobes.update(kind=torch.tensor([[1, 0]] * n, dtype=torch.int32),
                 c0=torch.full((n, 2, 3), 0.6),
                 ng=torch.tensor([[0.0, 0.0, 1.0]] * n),
                 ns=torch.tensor([[0.0, 0.0, 1.0]] * n),
                 ss=torch.tensor([[1.0, 0.0, 0.0]] * n),
                 ts=torch.tensor([[0.0, 1.0, 0.0]] * n))
    vp = TSp.VisiblePoints(
        p=torch.tensor([[0.0, 0, 0], [0.6, 0, 0], [5.0, 0, 0], [9.0, 0, 0]]),
        wo=torch.tensor([[0.0, 0.0, 1.0]] * n), beta=torch.ones(n, 3),
        valid=torch.ones(n, dtype=torch.bool),
        lobes=TSp.PackedLobes(**lobes))
    radius = torch.full((n,), 0.7)
    grid = integ._build_grid(vp, radius)
    sp_p = torch.tensor([[0.3, 0.0, 0.0]])
    in_b, g = TSp._to_grid(sp_p, grid["lo"], grid["res"], grid["inv_extent"])
    cell = TSp._hash_cells(g[:, 0], g[:, 1], g[:, 2], integ.n_pixels)
    start = torch.searchsorted(grid["sorted_cells"], cell)
    end = torch.searchsorted(grid["sorted_cells"], cell, right=True)
    count = torch.where(in_b, end - start, 0).to(torch.int32)
    assert int(count[0]) > 0
    phi, m_cnt = integ._pair_body(
        torch.zeros(n, 3), torch.zeros(n, dtype=torch.int32), 0,
        int(count[0]), torch.zeros(1, dtype=torch.int32), sp_p,
        torch.tensor([[0.0, 0.0, -1.0]]), torch.ones(1, 3),
        start.to(torch.int32), vp, radius, grid["sorted_vp"], 64)
    assert m_cnt.tolist() == [1, 1, 0, 0]
    np.testing.assert_allclose(phi[0], 0.6 / np.pi, rtol=1e-5)
    np.testing.assert_allclose(phi[1], 0.6 / np.pi, rtol=1e-5)
    np.testing.assert_allclose(phi[2:], 0.0)


def test_pair_pass_random_matches_jax():
    """Random visible points and splats near them, through the JAX pair
    pass (one chunk) and the port's pair loop (chunks of 97 pairs)."""
    rng = np.random.default_rng(5)
    p, wo, beta, valid, lobes, r = _random_vps(400, 5)
    jvp, tvp = _vp_pair(p, wo, beta, valid, lobes)
    ji = _jax_integ(res=20, pair_chunk=1 << 16)
    ti = _port_integ(res=20, pair_chunk=97)
    grid = ji._build_grid(jvp, jnp.asarray(r))
    n_sp = 600
    sp_p = (p[rng.integers(0, 400, n_sp)]
            + rng.normal(0, 0.2, (n_sp, 3))).astype(F32)
    sp_d = rng.normal(size=(n_sp, 3)).astype(F32)
    sp_d /= np.linalg.norm(sp_d, axis=1, keepdims=True)
    sp_beta = rng.uniform(0, 2, (n_sp, 3)).astype(F32)
    in_b, g = JS._to_grid(jnp.asarray(sp_p), grid["lo"], grid["res"],
                          grid["inv_extent"])
    cell = JS._hash_cells(g[:, 0], g[:, 1], g[:, 2], ji.n_pixels)
    start = jnp.searchsorted(grid["sorted_cells"], cell, side="left")
    end = jnp.searchsorted(grid["sorted_cells"], cell, side="right")
    count = np.asarray(jnp.where(in_b, end - start, 0)).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(count)[:-1]]).astype(np.int32)
    total = int(count.sum())
    assert total > 1000
    phi0 = rng.uniform(0, 1, (400, 3)).astype(F32)
    m0 = rng.integers(0, 5, 400).astype(np.int32)
    jphi, jm = ji._pair_pass(
        jnp.asarray(phi0), jnp.asarray(m0), jnp.int32(0), jnp.int32(total),
        jnp.asarray(offsets), jnp.asarray(sp_p), jnp.asarray(sp_d),
        jnp.asarray(sp_beta), start.astype(jnp.int32), jvp, jnp.asarray(r),
        grid["sorted_vp"])
    splat = dict(p=t(sp_p), d=t(sp_d), beta=t(sp_beta),
                 start=t(np.asarray(start).astype(np.int32)))
    phi_in, m_in = t(phi0), t(m0)
    tphi, tm = ti._pair_loop(phi_in, m_in, total, t(offsets), splat, tvp,
                             t(r), t(grid["sorted_vp"]))
    assert torch.equal(phi_in, t(phi0)) and torch.equal(m_in, t(m0))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert (tm.numpy() > m0).sum() > 100
    np.testing.assert_allclose(tphi.numpy(), np.asarray(jphi), rtol=1e-5,
                               atol=1e-6)
    # The kinds table of the scene's lobes changes no value.
    kinds = tuple(TSp.S.SlotKinds(frozenset({0, 1, 6}), frozenset({0}))
                  for _ in range(2))
    kphi, km = ti._pair_loop(phi_in, m_in, total, t(offsets), splat, tvp,
                             t(r), t(grid["sorted_vp"]), kinds)
    assert torch.equal(kphi, tphi) and torch.equal(km, tm)


# -- update, image, checkpoint ---------------------------------------------------


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    return dict(ld=rng.uniform(0, 3, (n, 3)).astype(F32),
                tau=rng.uniform(0, 50, (n, 3)).astype(F32),
                radius=rng.uniform(0.01, 1, n).astype(F32),
                n=rng.uniform(0, 30, n).astype(F32),
                phi=rng.uniform(0, 5, (n, 3)).astype(F32),
                m=np.where(rng.random(n) < 0.3, 0,
                           rng.integers(1, 40, n)).astype(np.int32))


def test_update_pixels_and_to_image_match_jax():
    s = _random_state(64, 2)
    ld_add = np.random.default_rng(3).uniform(0, 1, (64, 3)).astype(F32)
    ji, ti = _jax_integ(photons_per_iteration=777), _port_integ(
        photons_per_iteration=777)
    jst = ji._update_pixels(JS.SPPMState(**{k: jnp.asarray(v)
                                            for k, v in s.items()}),
                            jnp.asarray(ld_add))
    tst = ti._update_pixels(C.sppm_state_from_numpy(s, "cpu"), t(ld_add))
    for k in ("ld", "tau", "radius", "n", "phi", "m"):
        np.testing.assert_allclose(getattr(tst, k).numpy(),
                                   np.asarray(getattr(jst, k)), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(ti.to_image(tst, 3).numpy(),
                               np.asarray(ji.to_image(jst, 3)), rtol=1e-6)


def test_checkpoints_cross_packages(tmp_path):
    s = _random_state(16, 4)
    jst = JS.SPPMState(**{k: jnp.asarray(v) for k, v in s.items()})
    tst = C.sppm_state_from_numpy(s, "cpu")
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    JCk.save_pytree(jpath, jst, metadata={"iteration": 3})
    TCk.save_pytree(tpath, tst, metadata={"iteration": 3})
    like = TSp.initial_state(16, 1.0, "cpu")
    for path in (jpath, tpath):
        back = TCk.load_pytree(path, like)
        via = C.sppm_state_from_numpy(path, "cpu")
        jback = JCk.load_pytree(path, jst)
        for k in s:
            np.testing.assert_array_equal(getattr(back, k).numpy(), s[k])
            np.testing.assert_array_equal(getattr(via, k).numpy(), s[k])
            np.testing.assert_array_equal(np.asarray(getattr(jback, k)), s[k])
        assert int(TCk.load_metadata(path)["iteration"]) == 3
    assert back.m.dtype == torch.int32
    with pytest.raises(ValueError, match="shape"):
        TCk.load_pytree(tpath, TSp.initial_state(8, 1.0, "cpu"))


# -- PLY, scene scripts, what is refused -------------------------------------


def _write_ply(path, binary: bool):
    rng = np.random.default_rng(7)
    v = rng.uniform(-1, 1, (9, 3)).astype(F32)
    nrm = rng.normal(size=(9, 3)).astype(F32)
    uv = rng.uniform(0, 1, (9, 2)).astype(F32)
    faces = [[0, 1, 2], [2, 3, 4, 5], [5, 6, 7], [1, 7, 8, 3]]
    head = ["ply", "format " + ("binary_little_endian 1.0" if binary
                                else "ascii 1.0"),
            "element vertex 9"] + [f"property float {c}" for c in
                                   ("x", "y", "z", "nx", "ny", "nz", "u",
                                    "v")] + [
        f"element face {len(faces)}",
        "property list uchar int vertex_indices", "end_header"]
    rows = np.concatenate([v, nrm, uv], 1)
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        if binary:
            f.write(rows.astype("<f4").tobytes())
            for fc in faces:
                f.write(np.uint8(len(fc)).tobytes()
                        + np.asarray(fc, "<i4").tobytes())
        else:
            for r in rows:
                f.write((" ".join(f"{x:.9g}" for x in r) + "\n").encode())
            for fc in faces:
                f.write((f"{len(fc)} " + " ".join(map(str, fc)) + "\n"
                         ).encode())


@pytest.mark.parametrize("binary", [False, True])
def test_load_ply_matches_jax(tmp_path, binary):
    path = str(tmp_path / "mesh.ply")
    _write_ply(path, binary)
    got, want = TPly.load_ply(path), JPly.load_ply(path)
    for k in ("vertices", "normals", "uv", "indices"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["indices"].shape == (6, 3)


def test_caustic_glass_scene_matches_jax_and_refuses_a_missing_mesh(
        tmp_path):
    path = str(tmp_path / "glass.ply")
    _write_ply(path, True)
    ts = TCG.build_scene(path, device="cpu")
    conv = port_scene(JCG.build_scene(path))
    for f in ("triangle_rows", "tri_light_id"):
        assert torch.equal(getattr(ts, f), getattr(conv, f)), f
    for f in ("kind", "p", "i", "l2w", "w2l", "cos_total_width",
              "cos_falloff_start"):
        np.testing.assert_array_equal(getattr(ts.lights, f),
                                      getattr(conv.lights, f), err_msg=f)
    missing = str(tmp_path / "absent.ply")
    with pytest.raises(FileNotFoundError, match="absent.ply"):
        TCG.build_scene(missing, device="cpu")


def test_sphere_model_and_sppm_main_render_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "sphere.png")
    state = TSphere.render(resolution=12, iterations=2, filename=out,
                           device="cpu")
    assert os.path.getsize(out) > 0
    assert state.ld.shape == (144, 3) and torch.isfinite(state.ld).all()
    assert float(state.ld.sum()) > 0
    out2 = str(tmp_path / "main.png")
    _run.sppm_main("", TSphere.build_scene, TSphere.build_camera,
                   resolution=10, iterations=1, radius=0.025, depth=3,
                   argv=["--device", "cpu", "--output", out2,
                         "--photons", "500"])
    assert os.path.getsize(out2) > 0 and "wrote" in capsys.readouterr().out


def test_left_out_paths_refuse():
    cam = TSph.build_camera(4, "unused.png")
    # The fused blocks are ported (tests/test_torch_sppm_fused.py): their
    # flags are kept, as in the JAX package; fused_cost_analysis (below)
    # gives the port's count of a block's work, with JAX's keys.
    fz = TSp.SPPMIntegrator(cam, device="cpu", fused_iterations=True,
                            fused_unroll=True)
    assert fz.fused_iterations and fz.fused_unroll and fz.fused_block == 8
    # The sharded passes are ported (tests/test_torch_parallel.py): a mesh
    # must name the shard axis; shard_camera without one is ignored, as in
    # the JAX package.
    with pytest.raises(ValueError):
        TSp.SPPMIntegrator(cam, device="cpu", mesh=object())
    assert TSp.SPPMIntegrator(cam, device="cpu", shard_camera=True).mesh \
        is None
    integ = TSp.SPPMIntegrator(cam, device="cpu")
    scene = TSph.build_scene(device="cpu")
    # Animated geometry and render_frames are ported
    # (tests/test_torch_animated.py); they refuse a transform without
    # geometry and frames with unequal light counts.
    from trace_tpu_torch.core import transform as TT

    with pytest.raises(ValueError):
        integ.render(scene, geometry_transform=TT.identity())
    light = TL.point_light(TT.translate([0.0, 5.0, 0.0]), (1.0, 1.0, 1.0))
    with pytest.raises(ValueError):
        integ.render_frames(scene, [[light], [light, light]])
    cost = integ.fused_cost_analysis(scene)
    assert cost["flops"] > 0 and cost["bytes accessed"] > 0
    with pytest.raises(ValueError, match="cuda"):
        TSp.SPPMIntegrator(cam).render(scene)
