"""The port's per-ray BVH walk (trace_tpu_torch/accel/wbvh.py) against the
JAX package's (trace_tpu/accel/wbvh.py), on the CPU.

- pack_nodes, pack_leaf_tris and tree_depth: bit-equal to JAX's on the
  400-triangle soups (seeds 0, 1) and the 13x13 heightfield.
- walk_plain ("wbvh" limit) against traverse_batch on 256 rays, closest
  and any-hit, t_max inf and 4, and on the 1-, 2- and 3-triangle trees:
  hit masks equal, ids equal where t is not tied, t within 1e-6
  relative. XLA compiles traverse_batch's loop body and contracts its
  products into FMAs (about half the lanes' t differ in the last bits);
  the port rounds every product, as the kernel does.
- The chunked, coherence-sorted accelerator equals a single unsorted
  walk, bit for bit.
- The row marks the chip bound counts: one ray's number its node visits
  and triangle tests; a batch's are the union of its rays'.
- The faults of the JAX walks the port does not carry (ROADMAP C):
  a leaf of 9 triangles sharing one centroid (max_leaf 4) is scanned
  whole, and a stack too small for the tree is refused.
- Rays whose origin lies on a node's bounding plane, with axis-parallel
  directions (+0.0 and -0.0 components): the NaN of the slab test opens
  the slab, as in JAX; hits equal the brute-force grid's.
- The kernel's binding refuses what the kernel does not take (CPU
  tensors, a stack outside [1, 64], rows off a 16-byte boundary, marks
  without counts, an unknown limit), each with its own message.
- On the card (``cuda`` marker): the kernel against walk_plain on the
  traps above, the soup and 300,000 rays, bit for bit.

JAX is imported inside the ``jx`` fixture (and ``meshes``), so the
``cuda`` test also runs where JAX is not installed (``pytest
--noconftest -m cuda``).
"""
import functools
import types

import numpy as np
import pytest
import torch

from trace_tpu_torch import convert as C
from trace_tpu_torch.accel import bvh as TB
from trace_tpu_torch.accel import wbvh as TW
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.core.vec import V3
from trace_tpu_torch.ops.bvh_walk import LIMITS, walk_kernel
from trace_tpu_torch.shapes import triangle as TTri
from trace_tpu_torch.wavefront import geom as G

T_RTOL = 1e-6


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here so that the ``cuda`` test also runs
    where JAX is not installed (``pytest --noconftest -m cuda``)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import torch_jax_arrays  # noqa: F401  (one torch thread per worker)
    from trace_tpu.accel import bvh as JB
    from trace_tpu.accel import wbvh as JW
    from trace_tpu.shapes import triangle as JTri

    return types.SimpleNamespace(jnp=jnp, JB=JB, JW=JW, JTri=JTri)


def soup(nt, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (nt, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.6, (nt, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.6, (nt, 3)).astype(np.float32)
    verts = np.concatenate([c, c + e1, c + e2], 0)
    idx = np.stack([np.arange(nt), np.arange(nt) + nt,
                    np.arange(nt) + 2 * nt], -1)
    return idx, verts


def rays(nr, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (nr, 3)).astype(np.float32)
    d = rng.normal(0, 1, (nr, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def meshes(idx, verts):
    from trace_tpu.core import transform as JT
    from trace_tpu.shapes import triangle as JTri

    return (JTri.pack_triangle_mesh(JT.identity(), idx, verts),
            TTri.pack_triangle_mesh(TT.identity(), idx, verts))


def _grid13():
    from test_torch_certified import _grid

    return _grid()[:2]


def mats(tt, max_leaf=4):
    """The port's (tree, nodes, rows) for a port Triangles."""
    bvh = TB.build_bvh(TTri.world_bounds_np(tt), max_leaf)
    return (bvh, TW.pack_nodes(bvh),
            TW.pack_leaf_tris(tt, np.asarray(bvh.prim_order, np.int64)))


def walk(nodes, rows, o, d, tm, **kw):
    t, i = TW.walk_plain(torch.from_numpy(nodes), torch.from_numpy(rows),
                         torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(tm), **kw)
    return (i >= 0).numpy(), t.numpy(), i.clamp_min(0).numpy()


def assert_agree(a, b, what=""):
    """(hit, t, id) triples: hits equal, t within T_RTOL, untied ids."""
    (ha, ta, ia), (hb, tb, ib) = a, b
    np.testing.assert_array_equal(ha, hb, err_msg=what)
    np.testing.assert_allclose(ta[ha], tb[ha], rtol=T_RTOL, err_msg=what)
    np.testing.assert_array_equal(ia[ha], ib[ha], err_msg=what)


SHAPES = {
    "soup0": lambda: soup(400, 0),
    "soup1": lambda: soup(400, 1),
    "grid13": _grid13,
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_pack_and_depth_bit_equal(jx, shape):
    jt, tt = meshes(*SHAPES[shape]())
    jb = jx.JB.build_bvh(jx.JTri.world_bounds_np(jt), 4)
    bvh, nodes, rows = mats(tt)
    jn = jx.JW.pack_nodes(jb)
    jr = jx.JW.pack_leaf_tris(jt, np.asarray(jb.prim_order, np.int64))
    np.testing.assert_array_equal(nodes.view(np.uint32), jn.view(np.uint32))
    np.testing.assert_array_equal(rows.view(np.uint32), jr.view(np.uint32))
    assert TW.tree_depth(bvh) == jx.JW.tree_depth(jb) == TW.nodes_depth(
        nodes)
    # The same on JAX's own tree carried across.
    np.testing.assert_array_equal(TW.pack_nodes(C.linear_bvh(jb)).view(
        np.uint32), jn.view(np.uint32))


@pytest.mark.parametrize("t_max", [np.inf, 4.0])
@pytest.mark.parametrize("any_hit", [False, True])
def test_walk_plain_matches_traverse_batch(jx, t_max, any_hit):
    jnp = jx.jnp
    jt, tt = meshes(*soup(400, 0))
    o, d = rays(256, 1)
    tm = np.full(256, t_max, np.float32)
    _, nodes, rows = mats(tt)
    jh, jt_, ji = jx.JW.traverse_batch(nodes, rows, jnp.asarray(o),
                                    jnp.asarray(d), jnp.asarray(tm),
                                    max_leaf=4, any_hit=any_hit)
    port = walk(nodes, rows, o, d, tm, any_hit=any_hit, stack_depth=48)
    jax_ = (np.asarray(jh), np.asarray(jt_), np.asarray(ji))
    if any_hit:   # the first hit found, in the same visit order
        np.testing.assert_array_equal(port[0], jax_[0])
        np.testing.assert_array_equal(port[2][port[0]], jax_[2][port[0]])
    else:
        assert_agree(port, jax_)
    assert 20 < port[0].sum() < 256


@pytest.mark.parametrize("nt", [1, 2, 3])
def test_walk_plain_tiny_trees(jx, nt):
    jnp = jx.jnp
    jt, tt = meshes(*soup(nt, seed=10 + nt))
    o, d = rays(64, seed=20 + nt)
    # Aim half of the rays at the triangles, so each tree is hit; every
    # other aimed lane's t_max stops short of its target, and every other
    # lane of the rest has t_max 5.
    tgt = np.asarray(jt.v0)[np.arange(32) % nt] * 0.5 + np.asarray(
        jt.v1)[np.arange(32) % nt] * 0.25 + np.asarray(jt.v2)[
        np.arange(32) % nt] * 0.25
    d[:32] = (tgt - o[:32]) / np.linalg.norm(tgt - o[:32], axis=-1,
                                               keepdims=True)
    d = d.astype(np.float32)
    tm = np.full(64, np.inf, np.float32)
    tm[:32:2] = 0.999 * np.linalg.norm(tgt - o[:32], axis=-1)[::2]
    tm[33::2] = 5.0
    bvh, nodes, rows = mats(tt)
    jh, jt_, ji = jx.JW.traverse_batch(nodes, rows, jnp.asarray(o),
                                       jnp.asarray(d), jnp.asarray(tm),
                                       max_leaf=4)
    port = walk(nodes, rows, o, d, tm, any_hit=False, stack_depth=48)
    assert_agree(port, tuple(np.asarray(x) for x in (jh, jt_, ji)))
    assert port[0].sum() >= 8 and not port[0].all()
    brute = G.triangles_closest(G.triangle_cols(tt, "cpu"),
                                V3.of(torch.from_numpy(o)),
                                V3.of(torch.from_numpy(d)),
                                torch.from_numpy(tm))
    np.testing.assert_array_equal(port[0], brute[0].numpy())


def test_chunked_sorted_accelerator_equals_one_walk():
    _, tt = meshes(*soup(300, 5))
    bvh, nodes, rows = mats(tt)
    o, d = rays(400, 6)
    tm = np.full(400, np.inf, np.float32)
    tm[::3] = 5.0
    one = TW.WBVHAccelerator(nodes, rows, 4, "cpu", ray_chunk=1 << 20,
                             sort_rays=False)
    many = TW.WBVHAccelerator(nodes, rows, 4, "cpu", ray_chunk=64,
                              sort_rays=True)
    args = tuple(torch.from_numpy(x) for x in (o, d, tm))
    for any_hit in (False, True):
        a, b = one.intersect(*args, any_hit), many.intersect(*args, any_hit)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        assert 0 < int(a[0].sum()) < 400


@pytest.mark.parametrize("limit", ["wbvh", "bvh"])
def test_walk_plain_marks_the_rows_it_touches(limit):
    # The marks a launch's bound counts: one walk visits a node and tests
    # a triangle row at most once, so one ray's marks number its visits
    # and tests; a batch's marks are the union of its rays'.
    _, tt = meshes(*soup(400, 0))
    _, nodes, rows = mats(tt)
    o, d = rays(32, 1)
    tm = np.full(32, np.inf, np.float32)
    nd, tr, o, d, tm = (torch.from_numpy(x) for x in (nodes, rows, o, d, tm))
    m = nodes.shape[0]

    def marked(sl):
        seen = torch.zeros(m + rows.shape[0], dtype=torch.uint8)
        stats = TW.walk_plain(nd, tr, o[sl], d[sl], tm[sl], any_hit=False,
                              limit=limit, collect_stats=True, seen=seen)[2]
        return stats, seen

    union = torch.zeros(m + rows.shape[0], dtype=torch.uint8)
    for k in range(32):
        stats, seen = marked(slice(k, k + 1))
        assert int(seen[:m].sum()) == int(stats[0, 0])
        assert int(seen[m:].sum()) == int(stats[1, 0])
        union |= seen
    stats, seen = marked(slice(None))
    assert torch.equal(seen, union)
    assert 0 < int(seen[m:].sum()) <= int(stats[1].sum())
    assert int(seen[:m].sum()) < int(stats[0].sum())
    with pytest.raises(ValueError, match="collect_stats"):
        TW.walk_plain(nd, tr, o, d, tm, any_hit=False, seen=seen)


def _centroid_leaf():
    """9 triangles (p_k, -p_k, q) with p_k = (1, 1, z_k): every AABB is
    centred on the origin, so both builders make one leaf of all 9. Over
    the rays' (x, y) = a (1, 1) + b q[:2] each triangle's height is a z_k,
    highest for k = 8, the last of the leaf."""
    z = 0.1 * np.arange(1, 10, dtype=np.float32)
    p = np.stack([np.ones(9), np.ones(9), z], -1).astype(np.float32)
    q = np.array([-0.5, 0.5, 0.0], np.float32)
    verts = np.concatenate([p, -p, np.repeat(q[None], 9, 0)], 0)
    idx = np.stack([np.arange(9), np.arange(9) + 9, np.arange(9) + 18], -1)
    rng = np.random.default_rng(4)
    a = rng.uniform(0.02, 0.3, 16)
    b = rng.uniform(0.3, 0.6, 16)
    xy = a[:, None] * np.array([1.0, 1.0]) + b[:, None] * q[None, :2]
    o = np.concatenate([xy, np.full((16, 1), 10.0)], 1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (16, 1))
    return idx, verts, o, d, a


def test_leaf_of_coincident_centroids_is_scanned_whole(jx):
    jnp = jx.jnp
    idx, verts, o, d, a = _centroid_leaf()
    jt, tt = meshes(idx, verts)
    bvh, nodes, rows = mats(tt, max_leaf=4)
    assert bvh.n_prims.tolist() == [9] and TW.tree_depth(bvh) == 0
    tm = np.full(16, np.inf, np.float32)
    port = walk(nodes, rows, o, d, tm, any_hit=False)
    brute = G.triangles_closest(G.triangle_cols(tt, "cpu"),
                                V3.of(torch.from_numpy(o)),
                                V3.of(torch.from_numpy(d)),
                                torch.from_numpy(tm))
    assert port[0].all() and (port[2] == 8).all()
    np.testing.assert_array_equal(port[2], brute[2].numpy())
    np.testing.assert_array_equal(port[1], brute[1].numpy())
    # JAX's walk stops at max_leaf: it returns triangle 3, a (z_8 - z_3)
    # = 0.5 a further.
    jh, jt_, ji = jx.JW.traverse_batch(nodes, rows, jnp.asarray(o),
                                       jnp.asarray(d), jnp.asarray(tm),
                                       max_leaf=4)
    assert np.asarray(jh).all() and (np.asarray(ji) == 3).all()
    np.testing.assert_allclose(np.asarray(jt_) - port[1], 0.5 * a,
                               rtol=1e-4)


def _chain_tree(depth):
    """A LinearBVH whose interior nodes form a chain ``depth`` deep: each
    interior node's first child a leaf, its second the next interior."""
    m = 2 * depth + 1
    right = np.full(m, -1, np.int32)
    count = np.zeros(m, np.int32)
    start = np.zeros(m, np.int32)
    for k in range(depth):
        right[2 * k] = 2 * k + 2
        count[2 * k + 1] = 1
        start[2 * k + 1] = k
    count[m - 1], start[m - 1] = 1, depth
    lo = np.zeros((m, 3), np.float32)
    return TB.LinearBVH(lo, lo + 1, right, start, count,
                        np.zeros(m, np.int32),
                        np.arange(depth + 1, dtype=np.int32))


def test_stack_too_small_or_too_deep_is_refused(jx):
    jnp = jx.jnp
    _, tt = meshes(*soup(400, 0))
    bvh, nodes, rows = mats(tt)
    depth = TW.tree_depth(bvh)
    with pytest.raises(ValueError, match="stack_depth"):
        TW.WBVHAccelerator(nodes, rows, 4, "cpu", stack_depth=depth + 1)
    with pytest.raises(ValueError, match="stack_depth"):
        TB.BVHAccelerator(bvh, tt, 4, "cpu", stack_depth=depth + 1)
    TW.WBVHAccelerator(nodes, rows, 4, "cpu", stack_depth=depth + 2)
    chain = _chain_tree(63)
    assert TW.tree_depth(chain) == 63
    with pytest.raises(ValueError, match="above the kernel's 64"):
        TW.WBVHAccelerator(TW.pack_nodes(chain), np.zeros((64, 12),
                                                          np.float32),
                           1, "cpu", stack_depth=64)
    # attach raises a small stack to the tree's depth + 2.
    scene = type("S", (), dict(n_triangles=400, triangles=tt,
                               device=torch.device("cpu")))()
    TW.attach(scene, stack_depth=3)
    assert scene.accel.stack_depth == depth + 2 and depth + 2 > 3
    # JAX's walk with a stack below the depth drops far children silently.
    o, d = rays(256, 1)
    tm = jnp.full(256, jnp.inf)
    full = np.asarray(jx.JW.traverse_batch(nodes, rows, jnp.asarray(o),
                                           jnp.asarray(d), tm, max_leaf=4,
                                           stack_depth=48)[0])
    short = np.asarray(jx.JW.traverse_batch(nodes, rows, jnp.asarray(o),
                                            jnp.asarray(d), tm, max_leaf=4,
                                            stack_depth=2)[0])
    assert (full & ~short).sum() == 34 and not (short & ~full).any()


def _plane_rays(n=8):
    """A flat n x n grid of triangle pairs at z = 0, and 64 rays straight
    down whose origins lie on the integer planes x = k (every node's
    bounds lie on them), y random or integer too, with d.x = +0.0 or -0.0
    and d.y = +0.0 or -0.0: (idx, verts, o, d)."""
    xs = np.arange(n + 1, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([gx, gy, np.zeros_like(gx)], -1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    v00 = (ii * (n + 1) + jj).reshape(-1)
    idx = np.concatenate([np.stack([v00, v00 + n + 1, v00 + 1], -1),
                          np.stack([v00 + 1, v00 + n + 1, v00 + n + 2], -1)])
    rng = np.random.default_rng(7)
    m = 64
    o = np.stack([rng.integers(0, n + 1, m).astype(np.float32),
                  np.where(np.arange(m) % 2 == 0,
                           rng.integers(0, n + 1, m),
                           rng.uniform(0, n, m)).astype(np.float32),
                  np.full(m, 5.0, np.float32)], -1)
    sx = np.where(np.arange(m) % 4 < 2, 0.0, -0.0).astype(np.float32)
    sy = np.where(np.arange(m) % 3 == 0, -0.0, 0.0).astype(np.float32)
    d = np.stack([sx, sy, np.full(m, -1.0, np.float32)], -1)
    return idx, verts, o, d


def test_rays_on_bounding_planes(jx):
    jnp = jx.jnp
    idx, verts, o, d = _plane_rays()
    m = o.shape[0]
    assert np.signbit(d[:, 0]).any() and np.signbit(d[:, 1]).any()
    jt, tt = meshes(idx, verts)
    bvh, nodes, rows = mats(tt)
    tm = np.full(m, np.inf, np.float32)
    port = walk(nodes, rows, o, d, tm, any_hit=False)
    brute = G.triangles_closest(G.triangle_cols(tt, "cpu"),
                                V3.of(torch.from_numpy(o)),
                                V3.of(torch.from_numpy(d)),
                                torch.from_numpy(tm))
    assert port[0].all()
    np.testing.assert_array_equal(port[0], brute[0].numpy())
    np.testing.assert_array_equal(port[1], brute[1].numpy())
    jh, jt_, _ = jx.JW.traverse_batch(nodes, rows, jnp.asarray(o),
                                      jnp.asarray(d), jnp.asarray(tm),
                                      max_leaf=4)
    np.testing.assert_array_equal(port[0], np.asarray(jh))
    np.testing.assert_array_equal(port[1], np.asarray(jt_))
    # Any-hit finds the same lanes.
    occ = walk(nodes, rows, o, d, tm, any_hit=True)[0]
    np.testing.assert_array_equal(occ, port[0])


# ---------------------------------------------------------------------------
# The walk kernel's binding, and the kernel on the card
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _kernel_cases():
    """name -> (nodes, rows, o, d, t_max, stack_depth) as numpy, shared
    and read only: the soup under rays with t_max +inf, 4, 0, -1 and NaN;
    the coincident-centroid leaf; the on-plane rays with +-0.0
    directions; a chain 63 deep walked with a stack of 2 (pushes beyond
    it dropped)."""
    def packed(idx, verts):
        tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
        return mats(tt)[1:]

    o, d = rays(96, 1)
    tm = np.tile(np.float32([np.inf, 4.0, 0.0, -1.0, np.nan, np.inf]), 16)
    cases = {"soup": (*packed(*soup(400, 0)), o, d, tm, 48)}
    idx, verts, o, d, _ = _centroid_leaf()
    cases["centroid_leaf"] = (*packed(idx, verts), o, d,
                              np.full(16, np.inf, np.float32), 48)
    idx, verts, o, d = _plane_rays()
    cases["on_plane"] = (*packed(idx, verts), o, d,
                         np.full(64, np.inf, np.float32), 48)
    chain = _chain_tree(63)
    o = np.float32([[0.5, 0.5, -1.0], [0.25, 0.75, 2.0], [2.0, 0.5, 0.5]])
    d = np.float32([[0.0, 0.0, 1.0], [0.0, -0.0, -1.0], [-1.0, 0.0, 0.0]])
    tri = np.zeros((64, 12), np.float32)
    tri[:, 9] = np.arange(64, dtype=np.int32).view(np.float32)
    cases["chain_stack2"] = (TW.pack_nodes(chain), tri, o, d,
                             np.full(3, np.inf, np.float32), 2)
    return cases


REFUSED = {
    "cpu_tensors": ({}, "CUDA tensors"),
    "stack_0": (dict(stack_depth=0), "stack_depth"),
    "stack_65": (dict(stack_depth=65), "stack_depth"),
    "unaligned_nodes": (dict(shift="nodes"), "16-byte aligned"),
    "unaligned_tris": (dict(shift="tris"), "16-byte aligned"),
    "seen_without_stats": (dict(seen=True), "collect_stats"),
    "limit": (dict(limit="sah"), "limit"),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_walk_kernel_refuses(what):
    kw, match = REFUSED[what]
    kw = dict(kw)
    nodes, rows, o, d, tm, _ = _kernel_cases()["soup"]
    args = {k: torch.from_numpy(x) for k, x in zip(
        ("nodes", "tris", "o", "d", "t_max"), (nodes, rows, o, d, tm))}
    shift = kw.pop("shift", None)
    if shift:   # the same rows 4 bytes past a 16-byte boundary
        x = args[shift]
        flat = torch.zeros(x.numel() + 1, dtype=x.dtype)
        args[shift] = flat[1:].view(x.shape).copy_(x)
        assert args[shift].data_ptr() % 16 and args[shift].is_contiguous()
    if kw.pop("seen", False):
        kw["seen"] = torch.zeros(nodes.shape[0] + rows.shape[0],
                                 dtype=torch.uint8)
    with pytest.raises(ValueError, match=match):
        walk_kernel(*args.values(), any_hit=False, **kw)
    assert walk_kernel.launches == 0


@pytest.mark.cuda
def test_cuda_walk_kernel_matches_walk_plain():
    """On the card: the kernel against walk_plain in both limits, closest
    and any-hit, with and without counts, on the traps of _kernel_cases and
    on 300,000 rays through the soup (more than the card holds at once; a
    third of them walk nothing): t bits, ids, per-ray visits and tests,
    and marks equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cases = dict(_kernel_cases())
    nodes, rows, _, _, _, depth = cases["soup"]
    o, d = rays(300_000, 3)
    tm = np.tile(np.float32([np.inf, 4.0, 0.0, np.inf, np.nan, 2.0]),
                 50_000)
    cases["soup_300k"] = (nodes, rows, o, d, tm, depth)
    launched = walk_kernel.launches
    for name, case in cases.items():
        nd, tr, o, d, tm = (torch.from_numpy(x).to(dev) for x in case[:5])
        m = nd.shape[0]
        for limit in LIMITS:
            for any_hit in (False, True):
                kw = dict(any_hit=any_hit, limit=limit, stack_depth=case[5])
                sk, sp = (torch.zeros(m + tr.shape[0], dtype=torch.uint8,
                                      device=dev) for _ in range(2))
                k = walk_kernel(nd, tr, o, d, tm, collect_stats=True,
                                seen=sk, **kw)
                p = TW.walk_plain(nd, tr, o, d, tm, collect_stats=True,
                                  seen=sp, **kw)
                bare = walk_kernel(nd, tr, o, d, tm, **kw)
                torch.cuda.synchronize()
                what = f"{name} {limit} any_hit={any_hit}"
                assert torch.equal(k[0].view(torch.int32),
                                   p[0].view(torch.int32)), what
                for a, b in ((k[1], p[1]), (k[2], p[2]), (sk, sp),
                             (bare[0], k[0]), (bare[1], k[1])):
                    assert torch.equal(a, b), what
                assert int(k[2][0].sum()) > 0, what
    assert walk_kernel.launches == launched + 8 * len(cases)
