"""The sweep at the JAX package's own tilings -- group 64 at leaf 64 (GL =
4096 columns a super) and blocks of 128 and 512 rays -- and its public
construction (ops/sweep.py: SweepAccelerator from a ClusterAccel,
from_tables, attach), against the JAX package (trace_tpu.ops.sweep_pallas).

- ``sweep_plain`` and the plain prologue through SweepAccelerator at G =
  64, B = 128 and 512, against JAX's PallasSweepAccelerator(interpret=True)
  on a 16,928-triangle heightfield: the tables bit-equal, the per-block
  order and suffix bit-equal to the JAX wrapper's lines, hit masks equal,
  t within atol 1e-5 + rtol 1e-5 (test_torch_sweep.py's tolerance: XLA
  contracts the K=3 dots, the port rounds every product), ids equal where
  the winning t is untied, and the supers swept (``collect_stats``) equal.
- The tiled kernel's split of a super (csrc/sweep.cu::sweep_tiled_kernel)
  modelled in PyTorch: a block's rays over a cluster of CTAs, column
  tiles, each split over column groups in whole vectors, every group
  keeping the least t with strict '<' in column order, the groups merged
  by (t, column), the stop vote ORed across the cluster; bit-equal to
  ``sweep_plain`` (t, slot and steps) on tables whose every hit ties with
  a twin in a later tile and another group. A per-CTA vote is not.
- The construction with the JAX package's keywords: the tables a
  ClusterAccel gives at group 64 equal JAX's, from_tables' defaults,
  attach against the scene's own sweep, ``sort_rays`` off, refusals.
"""
import types

import numpy as np
import pytest
import torch

from trace_tpu_torch.accel import clusters as TC
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.core.vec import V3
from trace_tpu_torch.models import mesh_heavy as TMH
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.shapes import triangle as TTri
from trace_tpu_torch.wavefront import geom as TG

N_GRID = 93          # 2 * 92^2 = 16,928 triangles
N_RAYS = 1100        # 2 blocks of 512 and a padded third; 9 of 128
ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from trace_tpu.accel import clusters as JC
    from trace_tpu.core import transform as JT
    from trace_tpu.ops import sweep_pallas as JS
    from trace_tpu.shapes import triangle as JTri

    return types.SimpleNamespace(jax=jax, jnp=jnp, JC=JC, JT=JT, JS=JS,
                                 JTri=JTri)


@pytest.fixture(scope="module")
def terrain(jx):
    """(JAX Triangles, port Triangles, JAX ClusterAccel, port ClusterAccel)
    of mesh_heavy's heightfield at 16,928 triangles, leaf 64."""
    verts, idx = TMH.heightfield(N_GRID)
    jt = jx.JTri.pack_triangle_mesh(jx.JT.identity(), idx, verts)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    return jt, tt, jx.JC.build_clusters(jt, 64), TC.build_clusters(tt, 64)


def _rays(tt, n, seed, dead=True):
    """Rays from above the terrain aimed at random points of it, a fifth of
    them grazing, with ``dead`` a tenth dead (t_max -1)."""
    rng = np.random.default_rng(seed)
    lo = tt.v0.min(axis=0)
    hi = tt.v0.max(axis=0)
    p = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    o = p + np.stack([rng.uniform(-3, 3, n), rng.uniform(2, 6, n),
                      rng.uniform(-3, 3, n)], -1).astype(np.float32)
    o[: n // 5, 1] = p[: n // 5, 1] + 0.2
    d = (p - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(n, np.inf, np.float32)
    if dead:
        t_max[rng.choice(n, n // 10, replace=False)] = -1.0
    return o, d, t_max


def _untied(tt, o, d, t_win):
    """Rays whose winning t belongs to exactly one triangle (watertight
    brute force, relative band 1e-5)."""
    v0, v1, v2 = (V3(*torch.from_numpy(v).T[:, None, :])
                  for v in (tt.v0, tt.v1, tt.v2))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    hit, t, *_ = TG._watertight(
        v0, v1, v2, V3(ot[:, :1], ot[:, 1:2], ot[:, 2:3]),
        V3(dt[:, :1], dt[:, 1:2], dt[:, 2:3]),
        torch.full((o.shape[0], 1), 1e30))
    t = torch.where(hit, t, float("inf")).numpy()
    t_win = np.where(np.isfinite(t_win), t_win, -1.0)[:, None]
    close = np.abs(t - t_win) <= 1e-5 * np.maximum(1.0, np.abs(t_win))
    return close.sum(axis=1) == 1


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("block_rays", [128, 512])
def test_plain_sweep_at_group_64_matches_jax(jx, terrain, block_rays,
                                             any_hit):
    jnp = jx.jnp
    jt, tt, ja, ta = terrain
    # No dead lanes: the port sorts them last (so whole chunks of them
    # skip), JAX's sort key does not, and the blocks would differ.
    o, d, t_max = _rays(tt, N_RAYS, seed=block_rays + any_hit, dead=False)
    if any_hit:
        t_max[:] = 5.0
    jsw = jx.JS.PallasSweepAccelerator(ja, group=64, block_rays=block_rays,
                                       interpret=True, collect_stats=True)
    jh, jtv, ji = (np.asarray(x) for x in jsw._chunked(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), any_hit))
    jh = jh & np.isfinite(jtv)   # JAX's miss-as-hit quirk (ROADMAP C)
    j_steps = int(sum(int(s) for s in jsw._last_steps))

    tsw = TS.SweepAccelerator(ta, "cpu", group=64, block_rays=block_rays,
                              collect_stats=True)
    assert tsw.tables.gl_pad == 4096 and tsw.tables.n_supers >= 5
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(jsw.tables, f)),
                                      getattr(tsw.tables, f), err_msg=f)
    launches = TS.sweep_kernel.launches
    th, ttv, ti = (x.numpy() for x in tsw.intersect(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
        any_hit))
    assert TS.sweep_kernel.launches == launches   # CPU: the plain version
    np.testing.assert_array_equal(th, jh)
    assert th.sum() > (100 if any_hit else 400)
    assert int(sum(int(s.sum()) for s in tsw.last_steps)) == j_steps
    if any_hit:
        return
    np.testing.assert_allclose(ttv[th], jtv[th], rtol=RTOL, atol=ATOL)
    untied = th & _untied(tt, o, d, jtv)
    assert untied.sum() > 300
    np.testing.assert_array_equal(ti[untied], ji[untied])


@pytest.mark.parametrize("block_rays", [128, 512])
def test_plain_prologue_at_group_64_matches_jax_lines(jx, terrain,
                                                      block_rays):
    # The JAX wrapper's prologue (sweep_pallas.py:511-536) against the
    # port's, on one sorted chunk with dead lanes.
    jnp = jx.jnp
    jt, tt, ja, ta = terrain
    b = block_rays
    acc = TS.SweepAccelerator(ta, "cpu", group=64, block_rays=b)
    o, d, t_max = (torch.from_numpy(x) for x in _rays(tt, N_RAYS, seed=3))
    perm = acc.coherence_order(o, d, t_max)
    o, d, t_max = o[perm], d[perm], t_max[perm]
    rays, order, suffix = acc.prologue(o, d, t_max)
    o_p, d_p, t_p = (jnp.asarray(x.numpy()) for x in acc.pad_rays(
        o, d, t_max))
    tb = acc.tables
    entry = jx.JC._entry_boxes(jnp.asarray(tb.s_lo), jnp.asarray(tb.s_hi),
                               o_p, d_p, jnp.maximum(t_p, 0.0))
    entry = jnp.where(t_p[:, None] < 0.0, jnp.inf, entry)
    entry_b = jnp.min(entry.reshape(-1, b, tb.n_supers), axis=1)
    j_order = jnp.argsort(entry_b, axis=1).astype(jnp.int32)
    j_suffix = jx.jax.lax.associative_scan(
        jnp.minimum, jnp.take_along_axis(entry_b, j_order, axis=1),
        reverse=True, axis=1)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(suffix.numpy(), np.asarray(j_suffix))
    assert rays.shape == (10, order.shape[0] * b)
    # The dead lanes sort last and fill the last block: it enters nothing.
    fin = np.isfinite(suffix.numpy()).any(axis=1)
    assert fin[:-1].all() and not fin[-1]


# -- the tiled kernel's split, modelled ----------------------------------


def _twin_mesh(seed=61):
    """(verts [1200, 3], idx [400, 3]): 400 small random triangles in a
    10-unit cube."""
    rng = np.random.default_rng(seed)
    nt = 400
    c = rng.uniform(-5, 5, (nt, 3)).astype(np.float32)
    verts = np.concatenate([c, c + rng.normal(0, 0.6, (nt, 3)),
                            c + rng.normal(0, 0.6, (nt, 3))],
                           0).astype(np.float32)
    idx = np.stack([np.arange(nt), np.arange(nt) + nt,
                    np.arange(nt) + 2 * nt], -1)
    return verts, idx


def _twin_tables(seed=61):
    """Tables of GL 128 whose hits all tie across tiles and groups: columns
    [64, 128) repeat [0, 64) (the padding of a 64-column super), and
    columns 33-40 repeat 24-31 (tile 0's last group, twinned in tile 1's
    second group at tiles of 32 columns and four groups)."""
    verts, idx = _twin_mesh(seed)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    tb = TS.SweepTables(TC.build_clusters(tt, 16), 4)    # GL 64 -> 128
    panel = tb.panel.copy()
    slot = tb.slot_to_tri.reshape(tb.n_supers, -1).copy()
    for a in (panel, slot):
        a[..., 33:41] = a[..., 24:32]
        a[..., 64:] = a[..., :64]
    return TS.SweepTables.from_arrays(panel, slot.reshape(-1), tb.s_lo,
                                      tb.s_hi)


def _sweep_tiled(rays, order, suffix, panel, block_rays, any_hit, tile,
                 groups, certified=False, cluster=1, vec=1, vote="cluster"):
    """sweep_plain with each block's rays in ``cluster`` sub-blocks (the
    CTAs of csrc/sweep.cu::sweep_tiled_kernel's cluster), each super's
    columns staged in tiles of ``tile`` and each tile split over
    ``groups`` slices of whole ``vec``-column vectors, as the kernel
    splits them: every group keeps the least t over its slices (strict
    '<' in column order: the earliest column among equal t), then per ray
    the groups merge by (t, column). ``vote``: "cluster" -- every
    sub-block leaves at the first step where no lane of the block can
    improve (the kernel's stop vote, ORed across the cluster); "cta" --
    each sub-block leaves on its own lanes' vote. -> (t, slot, steps):
    steps of each block's first sub-block (what the kernel's rank 0
    writes)."""
    nb, n_supers = order.shape
    b = int(block_rays)
    gl = panel.shape[2]
    err_eps = TS.panel_err_eps(False, False)
    r = rays.reshape(10, nb, b)
    t_lim = r[9]
    best_t = torch.full((nb, b), float("inf"))
    best_i = torch.full((nb, b), -1, dtype=torch.int32)
    big = torch.iinfo(torch.int32).max
    live = torch.ones(nb, cluster, dtype=torch.bool)
    steps = torch.zeros(nb, cluster, dtype=torch.int32)
    for s in range(n_supers):
        lane_limit = (torch.where(best_t <= t_lim, -float("inf"), t_lim)
                      if any_hit else torch.minimum(best_t, t_lim))
        cta = (suffix[:, s, None, None]
               < lane_limit.reshape(nb, cluster, -1)).any(dim=2)
        live &= cta.any(dim=1, keepdim=True) if vote == "cluster" else cta
        if not bool(live.any()):
            break
        steps += live.to(torch.int32)
        sid = order[:, s].long()
        ok, t = TS._panel_test(r[:, :, :, None], panel[sid], certified,
                               err_eps)
        limit = torch.minimum(best_t, t_lim)[..., None]
        t = torch.where(ok & (t < limit), t, float("inf"))
        gt = torch.full((groups, nb, b), float("inf"))
        gk = torch.full((groups, nb, b), -1, dtype=torch.int32)
        for c0 in range(0, gl, tile):
            nv = min(tile, gl - c0) // vec
            for w in range(groups):
                k0 = c0 + w * nv // groups * vec
                k1 = c0 + (w + 1) * nv // groups * vec
                if k0 == k1:
                    continue
                tw = t[..., k0:k1]
                tmin = tw.amin(dim=2)
                kmin = torch.where(tw <= tmin[..., None],
                                   torch.arange(k0, k1, dtype=torch.int32),
                                   big).amin(dim=2)
                take = tmin < gt[w]
                gt[w] = torch.where(take, tmin, gt[w])
                gk[w] = torch.where(take, kmin, gk[w])
        mt, mk = gt[0], gk[0]
        for w in range(1, groups):
            take = (gt[w] < mt) | ((gt[w] == mt) & (gk[w] < mk))
            mt, mk = torch.where(take, gt[w], mt), torch.where(take, gk[w],
                                                               mk)
        lanes = live.repeat_interleave(b // cluster, dim=1)
        better = lanes & (mt < best_t)
        best_t = torch.where(better, mt, best_t)
        best_i = torch.where(better, sid[:, None].to(torch.int32) * gl + mk,
                             best_i)
    return best_t.reshape(-1), best_i.reshape(-1), steps[:, 0]


def _tie_case(block_rays, any_hit):
    """The twin tables and a sorted chunk's kernel inputs at
    ``block_rays``: (tables, accelerator, (rays, order, suffix))."""
    tb = _twin_tables()
    acc = TS.SweepAccelerator(tb, "cpu", block_rays=block_rays)
    rng = np.random.default_rng(62)
    o = rng.uniform(-8, 8, (700, 3)).astype(np.float32)
    d = rng.normal(0, 1, (700, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(700, 6.0 if any_hit else np.inf, np.float32)
    t_max[::7] = -1.0
    ot, dt, tm = (torch.from_numpy(x) for x in (o, d, t_max))
    perm = acc.coherence_order(ot, dt, tm)
    return tb, acc, acc.prologue(ot[perm], dt[perm], tm[perm])


# (block_rays, tile, groups, cluster, vec): one-CTA splits, then
# the cluster kernel's shapes (kernel_cluster: 4 CTAs of 32 rays x 16
# groups at B 128; 8 of 64 x 8 or 16 of 32 x 16 at B 512; 4 columns a
# vector).
SPLITS = [(32, 32, 16, 1, 1), (128, 32, 4, 1, 1), (128, 64, 4, 1, 1),
          (512, 128, 1, 1, 1), (96, 48, 5, 1, 1), (128, 64, 16, 4, 4),
          (512, 128, 8, 8, 4), (512, 64, 16, 16, 4)]


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize(
    "block_rays, tile, groups, cluster, vec", SPLITS,
    ids=[f"{b}-{t}-{g}" + (f"-c{c}" if c > 1 else "")
         for b, t, g, c, _ in SPLITS])
def test_tiled_split_merge_matches_plain_on_ties(block_rays, tile, groups,
                                                 cluster, vec, any_hit):
    tb, acc, args = _tie_case(block_rays, any_hit)
    for certified in (False, True):
        pt, pi, ps = TS.sweep_plain(*args, acc.panel, block_rays, any_hit,
                                    certified=certified, collect_stats=True)
        st, si, ss = _sweep_tiled(*args, acc.panel, block_rays, any_hit,
                                  tile, groups, certified=certified,
                                  cluster=cluster, vec=vec)
        assert torch.equal(st, pt) and torch.equal(si, pi)
        assert torch.equal(ss, ps)
        found = pi >= 0
        assert int(found.sum()) > (20 if any_hit else 60)
        # Every hit has a twin in a later column: the earlier one wins.
        col = pi[found] % tb.gl_pad
        assert bool((col < 64).all()) and not bool(
            ((col >= 33) & (col < 41)).any())


@pytest.mark.parametrize("block_rays, cluster", [(128, 4), (512, 8)])
def test_cluster_stop_vote_must_be_cluster_wide(block_rays, cluster):
    # Any-hit, unsorted blocks: every CTA but the last aims its rays along
    # the normals of super 0's triangles from 2.5 units away; the last
    # CTA's rays point away from the mesh and never hit, so each block
    # goes on (their limit stays t_max) after the others' lanes have all
    # hit. A CTA stopping on its own lanes would keep their first hits,
    # where the block's walk lowers some t, and its rank-0 steps would not
    # be the block's.
    verts, idx = _twin_mesh()
    tb = _twin_tables()
    acc = TS.SweepAccelerator(tb, "cpu", block_rays=block_rays)
    tri = verts[idx]
    nrm = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    first = tb.slot_to_tri[:tb.gl_pad]
    rng = np.random.default_rng(63)
    n = 2 * block_rays
    pick = rng.choice(np.unique(first[first >= 0]), n)
    u = nrm[pick] * np.where(rng.random(n) < 0.5, -1.0, 1.0)[:, None]
    o, d = tri.mean(axis=1)[pick] + 2.5 * u, -u
    away = (np.arange(n) % block_rays) >= block_rays - block_rays // cluster
    o[away], d[away] = 20.0, 1.0 / np.sqrt(3.0)
    args = acc.prologue(*(torch.from_numpy(x.astype(np.float32)) for x in (
        o, d, np.full(n, 6.0))))
    pt, pi, ps = TS.sweep_plain(*args, acc.panel, block_rays, True,
                                collect_stats=True)
    split = dict(tile=64, groups=512 * cluster // block_rays,
                 cluster=cluster, vec=4)
    st, si, ss = _sweep_tiled(*args, acc.panel, block_rays, True, **split)
    assert torch.equal(st, pt) and torch.equal(si, pi) and torch.equal(ss, ps)
    assert int((pi >= 0).sum()) == int((~away).sum())
    ct, ci, cs = _sweep_tiled(*args, acc.panel, block_rays, True, vote="cta",
                              **split)
    assert not torch.equal(ct, pt) and not torch.equal(cs, ps)


def test_kernel_cluster_shapes():
    # The cluster the tiled kernel launches for each served block: a power
    # of two dividing B / 32 (at most KERNEL_MAX_CLUSTER), whole warps of
    # rays a CTA, at most 512 threads.
    assert TS.kernel_cluster(32) == (1, 32, 16)
    assert TS.kernel_cluster(128) == (4, 32, 16)
    assert TS.kernel_cluster(512) == (TS.KERNEL_MAX_CLUSTER,
                                      512 // TS.KERNEL_MAX_CLUSTER,
                                      TS.KERNEL_MAX_CLUSTER)
    assert TS.kernel_cluster(96) == (1, 96, 5)
    assert TS.kernel_cluster(384) == (4, 96, 5)
    for k in range(1, 17):
        c, cta, groups = TS.kernel_cluster(32 * k)
        assert c * cta == 32 * k and cta % 32 == 0 and (c & (c - 1)) == 0
        assert c <= TS.KERNEL_MAX_CLUSTER and cta * groups <= 512
        assert groups == 512 // cta
    for bad in (16, 48, 544):
        with pytest.raises(ValueError):
            TS.kernel_cluster(bad)


# -- the public construction ----------------------------------------------


def test_accelerator_from_clusters_matches_jax_tables(jx, terrain):
    jt, tt, ja, ta = terrain
    acc = TS.SweepAccelerator(ta, "cpu", group=64, block_rays=128,
                              ray_chunk=8192, sort_rays=False,
                              pipeline=True, certified=True)
    assert (acc.block_rays, acc.ray_chunk, acc.sort_rays, acc.pipeline,
            acc.certified) == (128, 8192, False, True, True)
    want = TS.SweepTables(ta, 64, panel_hilo=True)
    hilo = TS.SweepAccelerator(ta, "cpu", group=64, panel_hilo=True)
    np.testing.assert_array_equal(hilo.tables.panel, want.panel)
    jtb = jx.JS.SweepTables(ja, 64)
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(jtb, f)),
                                      getattr(acc.tables, f), err_msg=f)
    wrapped = TS.SweepAccelerator.from_tables(acc.tables, device="cpu")
    assert (wrapped.block_rays, wrapped.ray_chunk, wrapped.sort_rays) == (
        128, 8192, True)
    assert wrapped.panel.data_ptr() != 0 and wrapped.tables is acc.tables
    with pytest.raises(ValueError, match="packed already"):
        TS.SweepAccelerator(acc.tables, "cpu", panel_bf16=True)
    with pytest.raises(TypeError, match="ClusterAccel or SweepTables"):
        TS.SweepAccelerator(tt, "cpu")


def test_unsorted_rays_give_the_same_hits(terrain):
    _, tt, _, ta = terrain
    o, d, t_max = (torch.from_numpy(x) for x in _rays(tt, 600, seed=9))
    sort = TS.SweepAccelerator(ta, "cpu", group=64, block_rays=128)
    flat = TS.SweepAccelerator(ta, "cpu", group=64, block_rays=128,
                               sort_rays=False)
    a = sort.intersect(o, d, t_max, False)
    b = flat.intersect(o, d, t_max, False)
    assert torch.equal(a[0], b[0]) and int(a[0].sum()) > 200
    assert torch.equal(a[1], b[1])


def test_attach_matches_the_scenes_own_sweep():
    scene = TMH.build_scene(5000, device="cpu")
    own = scene.accel
    version = scene._version
    TS.attach(scene, ray_chunk=4096)
    acc = scene.accel
    assert acc is not own and scene._version == version + 1
    assert (acc.tables.group, acc.tables.leaf_tris, acc.block_rays,
            acc.ray_chunk, acc.certified) == (8, 64, 32, 4096, False)
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        np.testing.assert_array_equal(getattr(acc.tables, f),
                                      getattr(own.tables, f), err_msg=f)
    rng = np.random.default_rng(4)
    o = torch.from_numpy(np.tile([[0.0, 40.0, 0.0]], (500, 1)).astype(
        np.float32))
    d = torch.from_numpy(np.stack([rng.uniform(-0.5, 0.5, 500),
                                   -np.ones(500), rng.uniform(-0.5, 0.5, 500)],
                                  -1).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    tm = torch.full((500,), float("inf"))
    for x, y in zip(acc.intersect(o, d, tm, False),
                    own.intersect(o, d, tm, False)):
        assert torch.equal(x, y)
    exact = TMH.build_scene(5000, device="cpu", exact_shared_edges=True)
    assert TS.attach(exact, group=4).accel.certified


@pytest.mark.parametrize("bf16", [False, True])
def test_chip_smoke_regroup_equals_packing_at_group_64(terrain, bf16):
    # chip_smoke.py's phase 4 times group 64 on the 1M mesh's group-8
    # tables regrouped (no second SAH build): the same tables as packing
    # the clusters at group 64.
    import chip_smoke as CS

    _, _, _, ta = terrain
    got = CS.regroup_tables(TS.SweepTables(ta, 8, panel_bf16=bf16), 8)
    want = TS.SweepTables(ta, 64, panel_bf16=bf16)
    assert (got.group, got.leaf_tris, got.n_supers, got.gl_pad) == (
        64, 64, want.n_supers, 4096)
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
