"""The port's cluster build, sweep tables and sparse sweep against the JAX
package (trace_tpu.accel.clusters, trace_tpu.ops.sweep_pallas).

- Cluster build and sweep tables: bit-equal (both build through the same
  C++ source with -ffp-contract=off).
- Prologue helpers (slab entry distances, coherence sort key, and the
  per-block entry table ``block_entry_plain`` against the JAX wrapper's
  own lines): bit-equal.
- The kernel's split of a super's columns over W warps, modelled in
  PyTorch (per-slice (t, k) minima merged by least t, then least k),
  against ``sweep_plain`` on panels with exact ties planted across slice
  boundaries: bit-equal, for W = 4, 8 and 16.
- The sweep on CPU tensors (the plain version) against the JAX Pallas
  kernel in interpret mode, at the same group (4) and block size (128),
  so both visit supers in the same order: hit masks equal; t within
  atol 1e-5 + rtol 1e-5 (the JAX side contracts its K=3 dots through XLA,
  the port rounds every product, so t may differ in the last ulps); ids
  equal on every ray whose winning t is not tied with another triangle.
- The CUDA kernels against their plain versions on the card (``cuda``
  marker, skipped without a GPU): the sweep in every arm (certified, bf16
  and hi/lo panels, step counts, double-buffered), also on the tie
  panels, at the JAX package's tilings through the tiled kernel's
  clusters, and the block entry kernel: bit-equal. The kernel serves
  blocks of 32k rays, 1 <= k <= 16, and refuses others; the Python
  side's constants match the CUDA source's. (The JAX package's own
  tilings: tests/test_torch_sweep_tilings.py.)

JAX is imported inside the ``jx`` fixture, so the ``cuda`` test also runs
where JAX is not installed (``pytest --noconftest -m cuda``).
"""
import types

import numpy as np
import pytest
import torch

from trace_tpu_torch.accel import clusters as TC
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.core.vec import V3
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.shapes import triangle as TTri
from trace_tpu_torch.wavefront import geom as TG


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from trace_tpu.accel import clusters as JC
    from trace_tpu.core import transform as JT
    from trace_tpu.models import mesh_heavy as JM
    from trace_tpu.ops import sweep_pallas as JS
    from trace_tpu.shapes import triangle as JTri

    return types.SimpleNamespace(jax=jax, jnp=jnp, JC=JC, JT=JT, JM=JM,
                                 JS=JS, JTri=JTri)


def _soup_arrays(nt, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (nt, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.6, (nt, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.6, (nt, 3)).astype(np.float32)
    verts = np.concatenate([c, c + e1, c + e2], 0)
    idx = np.stack([np.arange(nt), np.arange(nt) + nt,
                    np.arange(nt) + 2 * nt], -1)
    return idx, verts


def _rays(nr, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (nr, 3)).astype(np.float32)
    d = rng.normal(0, 1, (nr, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _meshes(jx, which):
    """(JAX Triangles, port Triangles, leaf_tris, group) for one case."""
    if which == "soup":
        idx, verts = _soup_arrays(700, seed=11)
        leaf, group = 16, 4
    else:
        n = int(np.sqrt(5000 / 2)) + 1
        verts, idx = jx.JM.heightfield(n)
        leaf, group = 64, 8
    jt = jx.JTri.pack_triangle_mesh(jx.JT.identity(), idx, verts)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    return jt, tt, leaf, group


@pytest.mark.parametrize("which", ["soup", "mesh_heavy5k"])
def test_cluster_build_and_tables_bit_equal(jx, which):
    jt, tt, leaf, group = _meshes(jx, which)
    for f in TTri.Triangles._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      getattr(tt, f), err_msg=f)
    ja = jx.JC.build_clusters(jt, leaf, 4)
    ta = TC.build_clusters(tt, leaf, 4)
    for f in ("c_lo", "c_hi", "packed_mt", "tri_id"):
        np.testing.assert_array_equal(np.asarray(getattr(ja, f)),
                                      getattr(ta, f), err_msg=f)
    jtb = jx.JS.SweepTables(ja, group)
    ttb = TS.SweepTables(ta, group)
    assert (jtb.n_supers, jtb.gl_pad) == (ttb.n_supers, ttb.gl_pad)
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        a, b = np.asarray(getattr(jtb, f)), getattr(ttb, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_entry_boxes_and_sort_key_bit_equal(jx):
    jnp = jx.jnp
    rng = np.random.default_rng(5)
    lo = rng.uniform(-5, 4, (40, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 2.0, (40, 3)).astype(np.float32)
    o, d = _rays(200, seed=6)
    # Axis-parallel rays starting on slab planes exercise the NaN guard
    # (0 * inf); the last rays are dead (t_max < 0 after the clamp: 0).
    d[:20, 1:] = 0.0
    o[:20, 1] = lo[:20, 1]
    t_max = rng.uniform(0.0, 20.0, 200).astype(np.float32)
    t_max[-10:] = 0.0
    je = np.asarray(jx.JC._entry_boxes(jnp.asarray(lo), jnp.asarray(hi),
                                       jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(t_max)))
    te = TC.entry_boxes(torch.from_numpy(lo), torch.from_numpy(hi),
                        torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(t_max)).numpy()
    np.testing.assert_array_equal(je, te)
    assert np.isfinite(te).any() and np.isinf(te).any()
    inv = (1.0 / np.maximum(hi.max(0) - lo.min(0), 1e-12)).astype(np.float32)
    jk = np.asarray(jx.JC._sort_key(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(lo.min(0)), jnp.asarray(inv)))
    tk = TC.sort_key(torch.from_numpy(o), torch.from_numpy(d),
                     torch.from_numpy(lo.min(0)), torch.from_numpy(inv))
    np.testing.assert_array_equal(jk.astype(np.int64), tk.numpy())


def _entry_rays(nr, seed, lo, hi):
    """Rays for the entry table: random, plus axis-parallel directions
    from origins on slab planes (0 * inf), dead lanes (t_max < 0) and
    finite and infinite t_max."""
    rng = np.random.default_rng(seed)
    o, d = _rays(nr, seed)
    d[:24, 1:] = 0.0                      # along x only
    o[:24, 1] = lo[:24, 1]                # on a y slab plane
    d[24:40, :2] = 0.0                    # along z only
    d[24:40, 2] = 1.0
    o[24:40, 0] = hi[:16, 0]              # on an x slab plane
    t_max = rng.uniform(0.0, 20.0, nr).astype(np.float32)
    t_max[40:90] = np.inf
    t_max[rng.choice(nr, nr // 8, replace=False)] = -1.0
    return o, d, t_max


@pytest.mark.parametrize("block_rays, n_rays", [(32, 300), (128, 260)])
def test_block_entry_plain_matches_jax(jx, block_rays, n_rays):
    # The JAX wrapper's lines (sweep_pallas.py, _traverse_chunk): pad to
    # whole blocks with dead lanes, _entry_boxes, dead lanes to inf, the
    # per-block min.
    jnp = jx.jnp
    rng = np.random.default_rng(block_rays)
    lo = rng.uniform(-6, 4, (70, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 3.0, (70, 3)).astype(np.float32)
    hi[:5] = lo[:5]                       # flat boxes
    o, d, t_max = _entry_rays(n_rays, 7 + block_rays, lo, hi)
    b = block_rays
    pad = (-n_rays) % b
    t_p = jnp.pad(jnp.where(jnp.isfinite(t_max), t_max, np.float32(3e38)),
                  (0, pad), constant_values=-1.0)
    o_p = jnp.pad(jnp.asarray(o), ((0, pad), (0, 0)))
    d_p = jnp.pad(jnp.asarray(d), ((0, pad), (0, 0)))
    entry = jx.JC._entry_boxes(jnp.asarray(lo), jnp.asarray(hi), o_p, d_p,
                               jnp.maximum(t_p, 0.0))
    entry = jnp.where(t_p[:, None] < 0.0, jnp.inf, entry)
    je = np.asarray(jnp.min(entry.reshape(-1, b, 70), axis=1))

    tb = TS.SweepTables.from_arrays(np.zeros((70, 16, 128), np.float32),
                                    np.full(70 * 128, -1, np.int32), lo, hi)
    acc = TS.SweepAccelerator(tb, "cpu", block_rays=b)
    o_t, d_t, tp_t = acc.pad_rays(torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(t_max))
    np.testing.assert_array_equal(tp_t.numpy(), np.asarray(t_p))
    launches = TS.block_entry_kernel.launches
    te = TS.block_entry(acc.s_lo, acc.s_hi, o_t, d_t, tp_t, b).numpy()
    assert TS.block_entry_kernel.launches == launches  # CPU: plain version
    np.testing.assert_array_equal(je, te)
    assert np.isfinite(te).any() and np.isinf(te).any()


def test_block_entry_wrapper_refuses_cpu_tensors():
    lo = torch.zeros(3, 3)
    o = torch.zeros(64, 3)
    with pytest.raises(ValueError):
        TS.block_entry_kernel(lo, lo + 1, o, o + 1, torch.ones(64), 32)
    got = TS.block_entry(lo, lo + 1, o - 1, o + 1, torch.full((64,), 9.0),
                         32)
    assert got.shape == (2, 3) and (got == 1.0).all()


def _tie_tables(seed):
    """Sweep tables whose every super holds each triangle twice: columns
    [GL/2, GL) repeat [0, GL/2) (a slice boundary for W = 2..16), and a
    few columns repeat their left neighbour inside a slice. Every hit then
    ties exactly with another column."""
    idx, verts = _soup_arrays(400, seed)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    tb = TS.SweepTables(TC.build_clusters(tt, 16), 4)   # GL 64, padded 128
    panel = tb.panel.copy()
    half = tb.gl_pad // 2
    panel[:, :, 3::8] = panel[:, :, 2::8]               # in-slice twins
    panel[:, :, half:] = panel[:, :, :half]             # cross-slice twins
    slot = tb.slot_to_tri.reshape(tb.n_supers, -1).copy()
    slot[:, 3::8] = slot[:, 2::8]
    slot[:, half:] = slot[:, :half]
    return TS.SweepTables.from_arrays(panel, slot.reshape(-1), tb.s_lo,
                                      tb.s_hi)


def _sweep_split(rays, order, suffix, panel, block_rays, any_hit, warps,
                 certified=False):
    """sweep_plain with each super's columns split over ``warps`` slices
    as the kernel splits them: per slice the least t and, among equal t,
    the lowest column (-1 where none); then per ray the least t over the
    slices in slice order, strict '<' (the lowest slice among equal t)."""
    nb, n_supers = order.shape
    b = int(block_rays)
    gl = panel.shape[2]
    err_eps = TS.panel_err_eps(False, False)
    r = rays.reshape(10, nb, b)
    t_lim = r[9]
    best_t = torch.full((nb, b), float("inf"))
    best_i = torch.full((nb, b), -1, dtype=torch.int32)
    cols = torch.arange(gl, dtype=torch.int32)
    bounds = [w * gl // warps for w in range(warps + 1)]
    live = torch.ones(nb, dtype=torch.bool)
    for s in range(n_supers):
        lane_limit = (torch.where(best_t <= t_lim, -float("inf"), t_lim)
                      if any_hit else torch.minimum(best_t, t_lim))
        live &= (suffix[:, s, None] < lane_limit).any(dim=1)
        if not bool(live.any()):
            break
        sid = order[:, s].long()
        ok, t = TS._panel_test(r[:, :, :, None], panel[sid], certified,
                               err_eps)
        limit = torch.minimum(best_t, t_lim)[..., None]
        t = torch.where(ok & (t < limit), t, float("inf"))
        mt = torch.full((nb, b), float("inf"))
        mk = torch.full((nb, b), -1, dtype=torch.int32)
        for w in range(warps):
            tw = t[..., bounds[w]:bounds[w + 1]]
            cw = cols[bounds[w]:bounds[w + 1]]
            tmin = tw.amin(dim=2)
            kmin = torch.where(tw <= tmin[..., None], cw,
                               torch.iinfo(torch.int32).max).amin(dim=2)
            kmin = torch.where(torch.isinf(tmin), -1, kmin)
            take = tmin < mt
            mt, mk = torch.where(take, tmin, mt), torch.where(take, kmin, mk)
        better = live[:, None] & (mt < best_t)
        best_t = torch.where(better, mt, best_t)
        best_i = torch.where(better, sid[:, None].to(torch.int32) * gl + mk,
                             best_i)
    return best_t.reshape(-1), best_i.reshape(-1)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("warps", [4, 8, 16])
def test_warp_split_merge_matches_plain_on_ties(warps, any_hit):
    tb = _tie_tables(51)
    acc = TS.SweepAccelerator(tb, "cpu", block_rays=32)
    o, d = _rays(300, seed=52)
    t_max = np.full(300, 6.0 if any_hit else np.inf, np.float32)
    t_max[::7] = -1.0                                    # dead lanes
    ot, dt, tm = (torch.from_numpy(x) for x in (o, d, t_max))
    perm = acc.coherence_order(ot, dt, tm)
    args = acc.prologue(ot[perm], dt[perm], tm[perm])
    for certified in (False, True):
        pt, pi = TS.sweep_plain(*args, acc.panel, 32, any_hit,
                                certified=certified)
        st, si = _sweep_split(*args, acc.panel, 32, any_hit, warps,
                              certified=certified)
        assert torch.equal(st, pt) and torch.equal(si, pi)
        found = pi >= 0
        assert int(found.sum()) > (5 if any_hit else 20)
        # Every hit had an exact twin in another slice: the lower wins.
        assert bool((pi[found] % tb.gl_pad < tb.gl_pad // 2).all())


def _untied(tt, o, d, t_max, t_win):
    """Rays whose winning t belongs to exactly one triangle (watertight
    brute force over the whole soup, relative band 1e-5)."""
    v0, v1, v2 = (V3(*torch.from_numpy(v).T[:, None, :])
                  for v in (tt.v0, tt.v1, tt.v2))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    hit, t, *_ = TG._watertight(
        v0, v1, v2, V3(ot[:, :1], ot[:, 1:2], ot[:, 2:3]),
        V3(dt[:, :1], dt[:, 1:2], dt[:, 2:3]),
        torch.from_numpy(t_max)[:, None] * 2.0)
    t = torch.where(hit, t, float("inf")).numpy()
    t_win = np.where(np.isfinite(t_win), t_win, -1.0)[:, None]
    close = np.abs(t - t_win) <= 1e-5 * np.maximum(1.0, np.abs(t_win))
    return close.sum(axis=1) == 1


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_plain_sweep_matches_jax_interpret_kernel(jx, any_hit):
    jnp = jx.jnp
    jt, tt, leaf, group = _meshes(jx, "soup")
    o, d = _rays(300, seed=12)  # 300 = 2 full blocks + a padded one
    t_max = np.full(300, 6.0 if any_hit else np.inf, np.float32)
    jsw = jx.JS.PallasSweepAccelerator(jx.JC.build_clusters(jt, leaf),
                                       group=group, block_rays=128,
                                       interpret=True)
    jh, jtv, ji = (np.asarray(x) for x in jsw._chunked(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), any_hit))
    # The JAX wrapper tests ``bi != INT_MAX`` after its kernel has already
    # turned "nothing found" into -1, so a miss can come back hit=True with
    # t=inf whenever slot_to_tri[-1] >= 0 and t_max is inf (harmless
    # downstream: t=inf never wins). The port reports such lanes as
    # misses; compare on finite t.
    jh = jh & np.isfinite(jtv)
    tsw = TS.SweepAccelerator(TS.SweepTables(TC.build_clusters(tt, leaf),
                                             group), "cpu", block_rays=128)
    launches = TS.sweep_kernel.launches
    th, ttv, ti = (x.numpy() for x in tsw.intersect(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
        any_hit))
    assert TS.sweep_kernel.launches == launches  # CPU tensors: plain version
    np.testing.assert_array_equal(th, jh)
    assert th.sum() > (5 if any_hit else 30)
    if any_hit:
        return
    np.testing.assert_allclose(ttv[th], jtv[th], rtol=1e-5, atol=1e-5)
    untied = th & _untied(tt, o, d, np.full(300, 1e3, np.float32), jtv)
    assert untied.sum() > 30
    np.testing.assert_array_equal(ti[untied], ji[untied])


def test_sweep_matches_brute_force_at_other_block_sizes():
    # Different block sizes change only which of several equal-t
    # triangles wins; hits and t must not move.
    idx, verts = _soup_arrays(500, seed=21)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    tb = TS.SweepTables(TC.build_clusters(tt, 16), 4)
    o, d = _rays(257, seed=22)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    tm = torch.full((257,), float("inf"))
    ref = TS.SweepAccelerator(tb, "cpu", block_rays=128).intersect(
        ot, dt, tm, False)
    for b, chunk in ((32, 64), (64, 100_000), (256, 100)):
        got = TS.SweepAccelerator(tb, "cpu", block_rays=b,
                                  ray_chunk=chunk).intersect(ot, dt, tm, False)
        np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
        np.testing.assert_array_equal(got[1].numpy(), ref[1].numpy())


def test_dead_lanes_never_hit():
    idx, verts = _soup_arrays(300, seed=31)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    acc = TS.SweepAccelerator(TS.SweepTables(TC.build_clusters(tt, 16), 4),
                              "cpu", block_rays=64)
    o, d = _rays(200, seed=32)
    tm = torch.full((200,), float("inf"))
    full = acc.intersect(torch.from_numpy(o), torch.from_numpy(d), tm, False)
    dead = torch.arange(200) % 3 == 0
    part = acc.intersect(torch.from_numpy(o), torch.from_numpy(d),
                         torch.where(dead, -1.0, tm), False)
    assert not part[0][dead].any()
    for a, b in zip(part, full):
        np.testing.assert_array_equal(a[~dead].numpy(), b[~dead].numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    rays = torch.zeros(10, 128)
    order = torch.zeros(1, 2, dtype=torch.int32)
    suffix = torch.zeros(1, 2)
    panel = torch.zeros(2, 16, 128)
    with pytest.raises(ValueError):
        TS.sweep_kernel(rays, order, suffix, panel, 128, False)
    t, i = TS.sweep(rays, order, suffix, panel, 128, False)  # plain path
    assert (i == -1).all() and torch.isinf(t).all()


def test_kernel_constants_match_the_cuda_source():
    # The Python guard's block size and warp count are the ones the kernel
    # is compiled with, and the scenes build accelerators of that block.
    import os
    import re

    from trace_tpu_torch import scene as TSc

    src = open(os.path.join(os.path.dirname(TS.__file__), os.pardir, "csrc",
                            "sweep.cu")).read()
    consts = dict(re.findall(
        r"constexpr int (kWarps|kBlockRays|kTileCols|kMaxCluster) = (\d+);",
        src))
    assert int(consts["kWarps"]) == TS.SWEEP_WARPS
    assert int(consts["kBlockRays"]) == TS.KERNEL_BLOCK_RAYS
    assert int(consts["kTileCols"]) == TS.KERNEL_TILE_COLS
    # kernel_cluster mirrors cluster_of(): the same cap on the cluster.
    assert int(consts["kMaxCluster"]) == TS.KERNEL_MAX_CLUSTER
    assert TSc.BLOCK_RAYS == TS.KERNEL_BLOCK_RAYS


BLOCK_CASES = [(32, True, 128), (128, True, 128), (512, True, 128),
               (48, False, 128), (1024, False, 128), (128, True, 4096),
               (512, True, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "block_rays, served, gl", BLOCK_CASES,
    ids=[f"{b}-{v}" + (f"-gl{g}" if g != 128 else "")
         for b, v, g in BLOCK_CASES])
def test_cuda_kernel_block_sizes(block_rays, served, gl):
    # Blocks of 32k rays, 1 <= k <= 16, run (a thread a ray; above 32 rays
    # a cluster of CTAs, kernel_cluster); the wrapper refuses any other
    # block before any launch. GL 4096 stages four tiles a super.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rays = torch.zeros(10, 2 * block_rays, device=dev)
    order = torch.zeros(2, 2, dtype=torch.int32, device=dev)
    suffix = torch.zeros(2, 2, device=dev)
    panel = torch.zeros(2, 16, gl, device=dev)
    launches = TS.sweep_kernel.launches
    tiled = TS.sweep_kernel.tiled_launches
    if not served:
        with pytest.raises(ValueError, match="blocks of 32k rays"):
            TS.sweep_kernel(rays, order, suffix, panel, block_rays, False)
        assert TS.sweep_kernel.launches == launches
        return
    t, i, steps = TS.sweep_kernel(rays, order, suffix, panel, block_rays,
                                  False, collect_stats=True)
    torch.cuda.synchronize()
    assert TS.sweep_kernel.launches == launches + 1
    assert TS.sweep_kernel.tiled_launches == tiled + int(
        TS.kernel_tiled(block_rays, gl))
    assert (i == -1).all() and torch.isinf(t).all()
    assert (steps == 0).all()     # t_lim 0: no lane can improve
    if TS.kernel_tiled(block_rays, gl):
        c, cta, groups = TS.kernel_cluster(block_rays)
        shape = TS.sweep_kernel.tiled_shape(block_rays)
        assert (shape["cluster"], shape["cta_rays"], shape["groups"]) == (
            c, cta, groups)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trace_tpu_torch.models import mesh_heavy

    dev = torch.device("cuda")
    scene = mesh_heavy.build_scene(20_000, device=dev)
    acc = scene.accel
    rng = np.random.default_rng(41)
    o = torch.from_numpy(rng.uniform(-12, 12, (3000, 3)).astype(np.float32))
    o[:, 1] = 6.0
    d = torch.from_numpy(rng.normal(0, 1, (3000, 3)).astype(np.float32))
    d[:, 1] = -d[:, 1].abs()
    d = d / d.norm(dim=1, keepdim=True)
    o, d = o.to(dev), d.to(dev)
    for any_hit, tm in ((False, float("inf")), (True, 8.0)):
        t_max = torch.full((3000,), tm, device=dev)
        perm = acc.coherence_order(o, d, t_max)
        args = (*acc.prologue(o[perm], d[perm], t_max[perm]), acc.panel,
                acc.block_rays, any_hit)
        kt, ki = TS.sweep_kernel(*args)
        pt, pi = TS.sweep_plain(*args)
        torch.cuda.synchronize()
        assert (ki >= 0).sum() > 100
        assert torch.equal(ki, pi)
        assert torch.equal(kt, pt)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["f32", "bf16", "hilo"])
def test_cuda_kernel_arms_match_plain(kind):
    # Every arm of the kernel -- certified or not, with step counts,
    # double-buffered or not -- against the plain version: bit-equal, at
    # (group, block) (8, 32) (sweep_kernel) and, through the tiled
    # kernel's clusters, (64, 128) and (64, 512): GL 4096, four tiles a
    # super (the group-8 tables regrouped, chip_smoke.regroup_tables).
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from trace_tpu_torch.models import mesh_heavy

    dev = torch.device("cuda")
    scene = mesh_heavy.build_scene(20_000, device=dev)
    rng = np.random.default_rng(42)
    o = torch.from_numpy(rng.uniform(-12, 12, (3000, 3)).astype(np.float32))
    o[:, 1] = 6.0
    d = torch.from_numpy(rng.normal(0, 1, (3000, 3)).astype(np.float32))
    d[:, 1] = -d[:, 1].abs()
    d = d / d.norm(dim=1, keepdim=True)
    o, d = o.to(dev), d.to(dev)
    for group, block in ((8, 32), (64, 128), (64, 512)):
        tb = scene.accel.tables if group == 8 else \
            chip_smoke.regroup_tables(scene.accel.tables, group // 8)
        acc = TS.SweepAccelerator(tb, dev, block_rays=block)
        panel = TS.panel_tensor(
            TS.cast_panel(tb.panel, kind == "bf16", kind == "hilo"), dev)
        tiled = TS.sweep_kernel.tiled_launches
        for any_hit, tm in ((False, float("inf")), (True, 8.0)):
            t_max = torch.full((3000,), tm, device=dev)
            perm = acc.coherence_order(o, d, t_max)
            args = (*acc.prologue(o[perm], d[perm], t_max[perm]), panel,
                    block, any_hit)
            for certified in (False, True):
                pt, pi, ps = TS.sweep_plain(*args, certified=certified,
                                            collect_stats=True)
                for pipeline in (False, True):
                    kt, ki, ks = TS.sweep_kernel(*args, certified=certified,
                                                 collect_stats=True,
                                                 pipeline=pipeline)
                    nt, ni = TS.sweep_kernel(*args, certified=certified,
                                             pipeline=pipeline)
                    torch.cuda.synchronize()
                    assert (ki >= 0).sum() > 100
                    for a, b in ((kt, pt), (ki, pi), (ks, ps), (nt, pt),
                                 (ni, pi)):
                        assert torch.equal(a, b)
        assert TS.sweep_kernel.tiled_launches - tiled == (
            0 if group == 8 else 16)


@pytest.mark.cuda
def test_cuda_block_entry_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trace_tpu_torch.models import mesh_heavy

    dev = torch.device("cuda")
    acc = mesh_heavy.build_scene(20_000, device=dev).accel
    lo, hi = acc.tables.s_lo, acc.tables.s_hi
    o, d, t_max = _entry_rays(3000, 43, lo, hi)
    o_p, d_p, t_p = acc.pad_rays(*(torch.from_numpy(x).to(dev)
                                   for x in (o, d, t_max)))
    args = (acc.s_lo, acc.s_hi, o_p, d_p, t_p, 32)
    launches = TS.block_entry_kernel.launches
    k = TS.block_entry_kernel.table(*args)
    p = TS.block_entry_plain(*args)
    ko, ks = TS.block_entry_kernel(*args)   # the prologue kernel
    po, ps = TS.prologue_plain(*args)
    torch.cuda.synchronize()
    assert TS.block_entry_kernel.launches == launches + 1
    assert torch.isfinite(p).any() and torch.isinf(p).any()
    assert torch.equal(k, p)
    assert torch.equal(ko, po) and torch.equal(ks, ps)


@pytest.mark.cuda
def test_cuda_kernel_on_ties_matches_plain():
    # Exact twins across the warps' column slices and inside one slice.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    acc = TS.SweepAccelerator(_tie_tables(51), dev, block_rays=32)
    o, d = _rays(3000, seed=53)
    t_max = np.full(3000, np.inf, np.float32)
    t_max[::7] = -1.0
    ot, dt, tm = (torch.from_numpy(x).to(dev) for x in (o, d, t_max))
    perm = acc.coherence_order(ot, dt, tm)
    args = acc.prologue(ot[perm], dt[perm], tm[perm])
    for any_hit in (False, True):
        for certified in (False, True):
            pt, pi, ps = TS.sweep_plain(*args, acc.panel, 32, any_hit,
                                        certified=certified,
                                        collect_stats=True)
            for pipeline in (False, True):
                kt, ki, ks = TS.sweep_kernel(
                    *args, acc.panel, 32, any_hit, certified=certified,
                    collect_stats=True, pipeline=pipeline)
                torch.cuda.synchronize()
                assert (ki >= 0).sum() > 100
                for a, b in ((kt, pt), (ki, pi), (ks, ps)):
                    assert torch.equal(a, b)


def test_miss_stays_a_miss_when_the_last_slot_is_a_triangle(jx):
    # A table whose very last slot holds a real triangle (256-triangle
    # soup, leaf 32 x group 4 = 128 slots per super, last cluster full).
    # The JAX wrapper maps its kernel's "nothing found" (-1) through
    # slot_to_tri[-1] and reports a ray that misses everything as
    # hit=True with t=inf; the port reports a miss.
    jnp = jx.jnp
    rng = np.random.default_rng(2)
    c = rng.uniform(-5, 5, (256, 3)).astype(np.float32)
    verts = np.concatenate([c, c + rng.normal(0, .6, (256, 3)).astype(
        np.float32), c + rng.normal(0, .6, (256, 3)).astype(np.float32)])
    idx = np.stack([np.arange(256), np.arange(256) + 256,
                    np.arange(256) + 512], -1)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    tb = TS.SweepTables(TC.build_clusters(tt, 32), 4)
    assert tb.slot_to_tri[-1] >= 0
    o = np.array([[0.0, 100.0, 0.0]], np.float32)
    d = np.array([[0.0, 1.0, 0.0]], np.float32)
    t_max = np.full(1, np.inf, np.float32)
    hit, t, _ = TS.SweepAccelerator(tb, "cpu").intersect(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
        False)
    assert not hit.item() and torch.isinf(t).all()
    jt = jx.JTri.pack_triangle_mesh(jx.JT.identity(), idx, verts)
    jsw = jx.JS.PallasSweepAccelerator(jx.JC.build_clusters(jt, 32),
                                       group=4, block_rays=128,
                                       interpret=True)
    _, jtv, _ = jsw._chunked(jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(t_max), False)
    assert np.isinf(np.asarray(jtv)).all()
