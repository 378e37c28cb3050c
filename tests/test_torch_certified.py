"""The port's exact-shared-edge path and the sweep's other arms against the
JAX package (trace_tpu.accel.mxu, trace_tpu.ops.sweep_pallas,
trace_tpu.shapes.triangle, trace_tpu.scene).

- The epilogues, the abs-cross and the double-single edge function:
  bit-equal on random inputs (both run op by op on the CPU).
- bf16 and hi/lo panels: bit-equal (both round to nearest even on the
  host).
- The plain sweep with certified / bf16 / hi-lo / certified-bf16 / step
  counts against the JAX Pallas kernel in interpret mode, at the same
  group (4) and block size (128): hit masks may differ on at most
  ``BOUNDARY_LANES`` lanes (XLA sums its K=3 dots in its own order, so a
  lane exactly on a widened boundary can flip; 0 were seen); t within
  rtol 1e-5 + atol 1e-5 (1e-4 on bf16 panels); ids equal on untied
  lanes; step counts equal.
- Certified hit masks cover the plain ones, without exception.
- The 13x13 shared-edge heightfield of tests/test_exact_edges.py: with
  exact_shared_edges the port's closest_hit misses none of the 1152 rays
  aimed exactly at shared edges, and agrees with the JAX package's packed
  scene.intersect on t (rtol 1e-5) and on the hit point and uv (atol
  1e-5) wherever the same triangle wins.
- The slice at small size: mesh_heavy(5000) at 32^2 with exact edges is
  within MSE 1e-5 of the default render (the bound of
  test_exact_edges.py::test_certified_render_finite_and_close_to_default).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trace_tpu.accel import clusters as JC
from trace_tpu.accel import mxu as JMXU
from trace_tpu.core import transform as JT
from trace_tpu.lights import lights as JL
from trace_tpu.materials.materials import MatteMaterial as JMatte
from trace_tpu.ops import sweep_pallas as JS
from trace_tpu.scene import SceneBuilder as JSceneBuilder
from trace_tpu.shapes import triangle as JTri
from trace_tpu_torch.accel import clusters as TC
from trace_tpu_torch.accel import mxu as TMXU
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.core.vec import V3
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.lights.lights import point_light
from trace_tpu_torch.materials.materials import MatteMaterial
from trace_tpu_torch.models import mesh_heavy as TM
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.sampler import uniform as TU
from trace_tpu_torch.scene import SceneBuilder
from trace_tpu_torch.shapes import triangle as TTri
from trace_tpu_torch.wavefront import geom as TG
from trace_tpu_torch.wavefront import whitted as TWF

BOUNDARY_LANES = 2
ARMS = {
    "certified": dict(certified=True),
    "bf16": dict(panel_bf16=True),
    "hilo": dict(panel_hilo=True),
    "certified_bf16": dict(certified=True, panel_bf16=True),
    "stats": dict(collect_stats=True),
}


def _bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint32)


def _soup(nt, seed, spread=5.0, scale=0.6):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (nt, 3)).astype(np.float32)
    e1 = rng.normal(0, scale, (nt, 3)).astype(np.float32)
    e2 = rng.normal(0, scale, (nt, 3)).astype(np.float32)
    verts = np.concatenate([c, c + e1, c + e2], 0)
    idx = np.stack([np.arange(nt), np.arange(nt) + nt,
                    np.arange(nt) + 2 * nt], -1)
    return idx, verts


def _rays(nr, seed, spread=8.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (nr, 3)).astype(np.float32)
    d = rng.normal(0, 1, (nr, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


# ---------------------------------------------------------------------------
# Elementwise pieces
# ---------------------------------------------------------------------------


def test_mt_epilogues_and_abs_cross_bit_equal():
    rng = np.random.default_rng(0)
    n = 4096
    det = rng.normal(0, 1, n).astype(np.float32)
    det[:64] = 0.0                                  # grazing lanes
    det[64:128] = rng.normal(0, 1e-7, 64).astype(np.float32)
    u = rng.uniform(-0.1, 1.1, n).astype(np.float32) * det
    v = rng.uniform(-0.1, 1.1, n).astype(np.float32) * det
    tn = rng.normal(0, 3, n).astype(np.float32)
    u[128:256] = 0.0                                # on an edge
    v[256:384] = (det - u)[256:384]
    errs = [np.abs(rng.normal(0, s, n)).astype(np.float32)
            for s in (1e-7, 1e-6, 1e-6, 1e-6)]
    j = [jnp.asarray(x) for x in (det, u, v, tn)]
    t = [torch.from_numpy(x) for x in (det, u, v, tn)]
    jok, jt = JMXU.mt_epilogue(*j)
    tok, tt = TMXU.mt_epilogue(*t)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(_bits(tt.numpy()), _bits(jt))
    jok, jt = JMXU.mt_epilogue_certified(*j, *(jnp.asarray(e) for e in errs))
    tok, tt = TMXU.mt_epilogue_certified(*t,
                                         *(torch.from_numpy(e) for e in errs))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(_bits(tt.numpy()), _bits(jt))
    assert 0 < tok.sum() < n
    a = np.abs(rng.normal(0, 5, (n, 3))).astype(np.float32)
    b = np.abs(rng.normal(0, 5, (n, 3))).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(TMXU.abs_cross(torch.from_numpy(a), torch.from_numpy(b)).numpy()),
        _bits(JMXU.abs_cross(jnp.asarray(a), jnp.asarray(b))))
    assert TMXU.MT_ERR_EPS == float(JMXU.MT_ERR_EPS)
    assert TS.BF16_PANEL_ERR_EPS == float(JS.BF16_PANEL_ERR_EPS)
    assert TS.HILO_PANEL_ERR_EPS == float(JS.HILO_PANEL_ERR_EPS)


def test_double_single_edge_function_bit_equal_and_exact():
    rng = np.random.default_rng(1)
    n = 4096
    a, b, c = (rng.normal(0, 3, n).astype(np.float32) for _ in range(3))
    # Half the lanes have fl(a*b) == fl(c*d): the case the fallback serves.
    d = (rng.normal(0, 3, n)).astype(np.float32)
    d[: n // 2] = ((a * b)[: n // 2] / c[: n // 2]).astype(np.float32)
    got = TG._edge_ds(*(torch.from_numpy(x) for x in (a, b, c, d))).numpy()
    ref = JTri._edge_ds(*(jnp.asarray(x) for x in (a, b, c, d)))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    exact = (a.astype(np.float64) * b - c.astype(np.float64) * d)
    same = (a * b) == (c * d)
    assert same.sum() > 100
    np.testing.assert_array_equal(np.sign(got[same]), np.sign(exact[same]))


# ---------------------------------------------------------------------------
# Sweep tables and the sweep's arms
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def soup():
    idx, verts = _soup(700, seed=11)
    jt = JTri.pack_triangle_mesh(JT.identity(), idx, verts)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    return JC.build_clusters(jt, 16, 4), TC.build_clusters(tt, 16, 4), tt


@pytest.mark.parametrize("kind", ["bf16", "hilo"])
def test_half_precision_panels_bit_equal(soup, kind):
    ja, ta, _ = soup
    kw = {"panel_" + kind: True}
    jtb = JS.SweepTables(ja, 4, **kw)
    ttb = TS.SweepTables(ta, 4, **kw)
    assert ttb.panel.dtype == np.uint16
    assert ttb.panel.shape == (ttb.n_supers, 32 if kind == "hilo" else 16,
                               ttb.gl_pad)
    np.testing.assert_array_equal(ttb.panel, np.asarray(jtb.panel).view(
        np.uint16))
    assert ttb.err_eps == TS.panel_err_eps(kind == "bf16", kind == "hilo")
    # The stored panel round-trips through from_arrays (convert.py's path).
    back = TS.SweepTables.from_arrays(ttb.panel, ttb.slot_to_tri, ttb.s_lo,
                                      ttb.s_hi)
    assert (back.panel_bf16, back.panel_hilo) == (ttb.panel_bf16,
                                                  ttb.panel_hilo)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_plain_sweep_arm_matches_jax_interpret_kernel(soup, arm, any_hit):
    ja, ta, tt = soup
    kw = ARMS[arm]
    o, d = _rays(300, seed=12)        # 300 = 2 full blocks + a padded one
    t_max = np.full(300, 6.0 if any_hit else np.inf, np.float32)
    jsw = JS.PallasSweepAccelerator(ja, group=4, block_rays=128,
                                    interpret=True, **kw)
    jh, jtv, ji = (np.asarray(x) for x in jsw._chunked(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), any_hit))
    jh = jh & np.isfinite(jtv)        # the JAX wrapper's miss fault (C)
    tb = TS.SweepTables(ta, 4, panel_bf16=kw.get("panel_bf16", False),
                        panel_hilo=kw.get("panel_hilo", False))
    tsw = TS.SweepAccelerator(tb, "cpu", block_rays=128,
                              certified=kw.get("certified", False),
                              collect_stats=kw.get("collect_stats", False))
    launches = TS.sweep_kernel.launches
    th, ttv, ti = (x.numpy() for x in tsw.intersect(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
        any_hit))
    assert TS.sweep_kernel.launches == launches  # CPU: the plain version
    assert (th != jh).sum() <= BOUNDARY_LANES
    assert th.sum() > (20 if any_hit else 40)
    if arm == "stats":
        assert [int(s.sum()) for s in tsw.last_steps] == [
            int(np.asarray(s)) for s in jsw._last_steps]
        assert len(tsw.last_steps) == 1 and tsw.last_steps[0].shape == (3,)
    if any_hit:
        return
    both = th & jh
    # bf16 constants carry 2^-9 relative error, and t*det = o.n - v0.n
    # cancels: summation-order differences grow to ~4e-5 there.
    tol = 1e-4 if kw.get("panel_bf16") else 1e-5
    np.testing.assert_allclose(ttv[both], jtv[both], rtol=tol, atol=tol)
    # Ids on lanes whose winning t is not shared with another triangle
    # (within the panel's t error: ~5% at bf16).
    t_all = _all_t(tt, o, d)
    band = 5e-2 if kw.get("panel_bf16") else 1e-4
    t_win = np.where(both, jtv, -1.0)[:, None]
    close = np.abs(t_all - t_win) <= band * np.maximum(1.0, np.abs(t_win))
    untied = both & (close.sum(axis=1) == 1)
    assert untied.sum() > 30
    np.testing.assert_array_equal(ti[untied], ji[untied])


def _all_t(tt, o, d):
    """[N, T] t of every (ray, triangle) pair hit by the watertight test."""
    v0, v1, v2 = (V3(*torch.from_numpy(v).T[:, None, :])
                  for v in (tt.v0, tt.v1, tt.v2))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    hit, t, *_ = TG._watertight(
        v0, v1, v2, V3(ot[:, :1], ot[:, 1:2], ot[:, 2:3]),
        V3(dt[:, :1], dt[:, 1:2], dt[:, 2:3]), torch.full((len(o), 1), 1e3))
    return torch.where(hit, t, float("inf")).numpy()


@pytest.mark.parametrize("kind", ["f32", "bf16", "hilo"])
def test_certified_hits_cover_plain_hits(kind):
    # Superset property (test_exact_edges.py::
    # test_certified_epilogue_never_loses_oracle_hits): every lane the
    # uncertified f32 sweep or the watertight oracle hits, the certified
    # sweep hits too, on any panel precision.
    idx, verts = _soup(400, seed=7, spread=4.0, scale=0.7)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    ta = TC.build_clusters(tt, 16, 4)
    o, d = _rays(400, seed=8, spread=6.0)
    args = [torch.from_numpy(x) for x in (o, d)] + [torch.full((400,), np.inf)]
    plain = TS.SweepAccelerator(TS.SweepTables(ta, 4), "cpu",
                                block_rays=64).intersect(*args, False)
    cert = TS.SweepAccelerator(
        TS.SweepTables(ta, 4, panel_bf16=kind == "bf16",
                       panel_hilo=kind == "hilo"),
        "cpu", block_rays=64, certified=True).intersect(*args, False)
    oracle = np.isfinite(_all_t(tt, o, d)).any(axis=1)
    assert plain[0].sum() > 50
    assert not (plain[0] & ~cert[0]).any()
    assert not (torch.from_numpy(oracle) & ~cert[0]).any()
    if kind == "f32":  # same winner, same t: the widening never moves t
        same = plain[0] & (plain[2] == cert[2])
        assert torch.equal(cert[1][same], plain[1][same])


# ---------------------------------------------------------------------------
# Shared edges through the whole closest-hit path
# ---------------------------------------------------------------------------


def _grid(n=13, amp=0.25, seed=0):
    """test_exact_edges.py::_grid: a heightfield whose quad diagonals
    (v00+1 -- v00+n) are each shared by two triangles."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-2.0, 2.0, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gz = (amp * np.sin(2.1 * gx) * np.cos(1.7 * gy)
          + 0.05 * rng.normal(size=gx.shape)).astype(np.float32)
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (ii * n + jj).reshape(-1)
    idx = np.concatenate(
        [np.stack([v00, v00 + n, v00 + 1], -1),
         np.stack([v00 + 1, v00 + n, v00 + n + 1], -1)], axis=0
    ).astype(np.uint32)
    return idx, verts, np.stack([v00 + 1, v00 + n], -1)


def _edge_rays(verts, shared, per_edge=8, seed=1):
    """test_exact_edges.py::_edge_rays: rays aimed at f32 points ON the
    shared edges from generic origins above the surface."""
    rng = np.random.default_rng(seed)
    va, vb = verts[shared[:, 0]], verts[shared[:, 1]]
    s = rng.uniform(0.05, 0.95, (shared.shape[0], per_edge, 1)
                    ).astype(np.float32)
    p = (va[:, None, :] + s * (vb - va)[:, None, :]).reshape(-1, 3)
    p = p.astype(np.float32)
    o = p + np.stack([rng.uniform(-0.8, 0.8, p.shape[0]),
                      rng.uniform(-0.8, 0.8, p.shape[0]),
                      rng.uniform(2.0, 4.0, p.shape[0])], -1).astype(np.float32)
    d = (p - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True).astype(np.float32)
    return o, d


def _port_grid_scene(idx, verts, exact):
    b = SceneBuilder()
    mat = b.material(MatteMaterial())
    b.triangle_mesh(TT.identity(), idx, verts, mat)
    b.light(point_light(TT.translate([0.0, 0.0, 6.0]), (50.0,) * 3))
    return b.build("cpu", exact_shared_edges=exact)


def test_shared_edge_grid_no_leaks_and_matches_jax_packed_path():
    idx, verts, shared = _grid()
    o, d = _edge_rays(verts, shared)
    n = o.shape[0]
    assert (n, idx.shape[0]) == (1152, 288)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    inf = torch.full((n,), float("inf"))
    hits = {}
    for exact in (False, True):
        scene = _port_grid_scene(idx, verts, exact)
        assert scene.exact_edges == exact == scene.accel.certified
        hits[exact] = TWF.closest_hit(scene, V3.of(ot), V3.of(dt), inf,
                                      torch.zeros(n))
    th = hits[True]
    assert int((~th.valid).sum()) == 0
    # Without exact edges the same rays leak: the grid does probe edges.
    assert int((~hits[False].valid).sum()) > 100

    jb = JSceneBuilder()
    jb.triangle_mesh(JT.identity(), idx, verts, jb.material(JMatte()))
    jb.light(JL.point_light(JT.translate([0.0, 0.0, 6.0]), (50.0,) * 3))
    jscene = jb.build(exact_shared_edges=True, accelerator="clusters")
    jh = jscene.intersect(jnp.asarray(o), jnp.asarray(d),
                          jnp.full((n,), jnp.inf))
    assert not (~np.asarray(jh.valid)).any()
    same = th.prim_id.numpy() == np.asarray(jh.prim_id)
    assert same.mean() > 0.4       # both sides of an edge are legitimate
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-5)
    np.testing.assert_allclose(th.p.arr().numpy(), np.asarray(jh.p),
                               atol=1e-5)
    uv = np.stack([th.u.numpy(), th.v.numpy()], -1)
    np.testing.assert_allclose(uv[same], np.asarray(jh.uv)[same], atol=1e-5)


# ---------------------------------------------------------------------------
# The slice at small size
# ---------------------------------------------------------------------------


def test_exact_edges_render_close_to_default():
    imgs = {}
    for exact in (False, True):
        scene = TM.build_scene(5000, device="cpu", exact_shared_edges=exact)
        cam = TM.build_camera(32, "unused.png")
        integ = WhittedIntegrator(cam, TU.UniformSampler(1, seed=0),
                                  max_depth=2)
        imgs[exact] = cam.film.to_image(integ.render(scene)).numpy()
        assert integ.last_queue_drops == 0
    assert np.isfinite(imgs[True]).all() and imgs[True].max() > 0.01
    assert float(np.mean((imgs[True] - imgs[False]) ** 2)) < 1e-5
