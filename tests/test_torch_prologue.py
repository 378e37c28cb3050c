"""The sweep's prologue (ops/sweep.py: ``prologue``, ``prologue_plain``,
csrc/entry.cu's prologue kernel) and the accelerator's dead-chunk skip.

- The plain prologue against the JAX wrapper's own lines
  (sweep_pallas.py:527-536: ``_entry_boxes``, dead lanes to inf, the
  per-block min, ``jnp.argsort`` and a reverse ``associative_scan``) on the
  5k-triangle mesh_heavy tables, at group 8 and at group 1, on rays that
  give dead blocks, tied entries and zero entries: order and suffix equal
  (values; the two frameworks may round max(-0.0, 0) to either zero).
- A numpy model of the kernel's algorithm (finite entries compacted into
  64-bit keys, f32 bits with -0.0 made +0.0, << 32 | super id; a bitonic
  network padded virtually with +inf keys; the +inf supers' ids through the
  suffix row as scratch; full rows) against the plain version on rows
  with ties, +0.0/-0.0 and +inf, of every length from 0 to S: equal.
- ``SweepAccelerator.intersect`` skips the chunks with no live lane: for
  0, 1, one chunk, one chunk + 1 and all live lanes, over several chunks,
  (hit, t, tri) equal to launching every chunk, with the skipped chunks
  counted; and against the JAX ``_chunked`` in interpret mode: hit masks
  equal, t within 1e-5 (XLA contracts the JAX side's dots), ids equal on
  every ray whose winning t is not tied with another triangle.
- ``cuda`` marker (skipped without a GPU): the prologue kernel against the
  plain version on dense, sparse and all-dead chunks, and on a group-1
  table whose rows sort in the global workspace: bit-equal.

JAX is imported inside the ``jx`` fixture, so the ``cuda`` tests also run
where JAX is not installed (``pytest --noconftest -m cuda``).
"""
import types

import numpy as np
import pytest
import torch

from trace_tpu_torch.accel import clusters as TC
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.shapes import triangle as TTri

INF = np.float32(np.inf)


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


def _heightfield_tables(target_tris, group):
    from trace_tpu_torch.models import mesh_heavy

    n = int(np.sqrt(target_tris / 2)) + 1
    verts, idx = mesh_heavy.heightfield(n)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    return TS.SweepTables(TC.build_clusters(tt, 64, 4), group)


def _prologue_rays(tb, n, seed):
    """Rays over the mesh_heavy terrain: downward from above (most entries
    positive), origins inside super boxes (entries 0), axis-parallel rays
    from outside (entries tied across boxes that share a slab plane),
    origins on a box's upper x face looking down x (entry -0.0 before the
    clamp), and whole dead blocks of 32 (t_max < 0)."""
    rng = np.random.default_rng(seed)
    lo, hi = tb.s_lo, tb.s_hi
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(2, 6, n)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.5
    q = n // 8
    box = rng.integers(0, lo.shape[0], n)
    mid = (lo[box] + hi[box]) * np.float32(0.5)
    o[:q] = mid[:q]                                   # inside a box
    d[q:2 * q] = [1.0, 0.0, 0.0]                      # along +x, from outside
    o[q:2 * q, 0] = -11.0
    o[q:2 * q, 1:] = mid[q:2 * q, 1:]
    o[2 * q:3 * q] = mid[2 * q:3 * q]                 # on the +x face, -x
    o[2 * q:3 * q, 0] = hi[box[2 * q:3 * q], 0]
    d[2 * q:3 * q] = [-1.0, 0.0, 0.0]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(n, np.inf, np.float32)
    t_max[3 * q:4 * q] = rng.uniform(0.5, 8.0, q)
    t_max[4 * q:5 * q] = -1.0                          # dead blocks
    return o, d, t_max


@pytest.mark.parametrize("group", [8, 1])
def test_plain_prologue_matches_jax(jx, group):
    jnp = jx.jnp
    tb = _heightfield_tables(5000, group)
    b = 32
    o, d, t_max = _prologue_rays(tb, 32 * 24, seed=group)
    acc = TS.SweepAccelerator(tb, "cpu", block_rays=b)
    o_p, d_p, t_p = acc.pad_rays(*(torch.from_numpy(x) for x in (o, d,
                                                                   t_max)))
    order, suffix = TS.prologue(acc.s_lo, acc.s_hi, o_p, d_p, t_p, b)
    # The JAX wrapper's lines (PallasSweepAccelerator._traverse_chunk).
    s = tb.n_supers
    tj = jnp.asarray(t_p.numpy())
    entry = jx.JC._entry_boxes(jnp.asarray(tb.s_lo), jnp.asarray(tb.s_hi),
                               jnp.asarray(o_p.numpy()),
                               jnp.asarray(d_p.numpy()), jnp.maximum(tj, 0.0))
    entry = jnp.where(tj[:, None] < 0.0, jnp.inf, entry)
    entry_b = jnp.min(entry.reshape(-1, b, s), axis=1)
    j_order = jnp.argsort(entry_b, axis=1).astype(jnp.int32)
    entry_o = jnp.take_along_axis(entry_b, j_order, axis=1)
    j_suffix = jx.jax.lax.associative_scan(jnp.minimum, entry_o,
                                           reverse=True, axis=1)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(suffix.numpy(), np.asarray(j_suffix))
    # The rays reach what they were made for.
    e = np.asarray(entry_b)
    assert np.isinf(e).all(axis=1).sum() >= 3           # dead blocks
    assert (e == 0).any(axis=1).sum() >= 3              # zero entries
    fin = np.where(np.isfinite(e) & (e > 0), e, np.nan)
    ties = [np.unique(r[~np.isnan(r)], return_counts=True)[1].max()
            for r in fin if (~np.isnan(r)).any()]
    assert max(ties) >= 2                               # tied entries


def _bitonic(keys: np.ndarray) -> None:
    """csrc/entry.cu::sort_keys on a numpy uint64 row, in place."""
    k = keys.size
    p = 1
    while p < k:
        p <<= 1
    x = np.arange(p // 2)
    m = 2
    while m <= p:
        j = m // 2
        while j > 0:
            lo = ((x & ~(j - 1)) << 1) | (x & (j - 1))
            hi = lo ^ (m - 1) if j == m // 2 else lo | j
            lo, hi = lo[hi < k], hi[hi < k]
            a, c = keys[lo], keys[hi]
            swap = a > c
            keys[lo[swap]], keys[hi[swap]] = c[swap], a[swap]
            j //= 2
        m *= 2


def _kernel_model(entry_b: np.ndarray):
    """The prologue kernel's steps 2-4 on an entry table [NB, S]."""
    nb, s = entry_b.shape
    order = np.empty((nb, s), np.int32)
    suffix = np.empty((nb, s), np.float32)
    ids = np.arange(s)
    for b in range(nb):
        e = np.ascontiguousarray(entry_b[b], np.float32)
        fin = e < INF
        bits = e.view(np.uint32).astype(np.uint64)
        bits[bits == 0x80000000] = 0                   # -0.0 -> +0.0
        keys = (bits[fin] << np.uint64(32)) | ids[fin].astype(np.uint64)
        k = keys.size
        _bitonic(keys)
        below = np.cumsum(fin) - fin                   # finite ids below s
        scratch = np.empty(s, np.int64)
        scratch[ids[~fin] - below[~fin]] = ids[~fin]
        order[b, :k] = (keys & np.uint64(0xFFFFFFFF)).astype(np.int32)
        order[b, k:] = scratch[:s - k]
        suffix[b, :k] = (keys >> np.uint64(32)).astype(np.uint32).view(
            np.float32)
        suffix[b, k:] = INF
    return order, suffix


def test_kernel_key_model_equals_stable_argsort():
    rng = np.random.default_rng(3)
    s = 77
    # Few distinct values: every row is full of ties; +0.0 and -0.0 tie.
    vals = np.array([0.0, -0.0, 0.25, 0.5, 1.0, 1e-30, 3.5, 7e30, INF],
                    np.float32)
    rows = [vals[rng.integers(0, vals.size, s)] for _ in range(40)]
    rows += [np.full(s, INF), np.zeros(s, np.float32),
             np.full(s, -0.0, np.float32),
             rng.uniform(0, 10, s).astype(np.float32)]
    for k in (1, 2, 3, 31, 32, 33, 64, 65, 76):        # k finite entries
        r = np.full(s, INF)
        r[rng.choice(s, k, replace=False)] = vals[rng.integers(0, 8, k)]
        rows.append(r)
    table = np.stack(rows).astype(np.float32)
    m_order, m_suffix = _kernel_model(table)
    order, suffix = TS.order_suffix(torch.from_numpy(table))
    np.testing.assert_array_equal(m_order, order.numpy())
    np.testing.assert_array_equal(m_suffix, suffix.numpy())
    assert sorted(m_order[5]) == list(range(s))         # full rows


def _soup_tables(seed):
    rng = np.random.default_rng(seed)
    nt = 700
    c = rng.uniform(-5, 5, (nt, 3)).astype(np.float32)
    verts = np.concatenate([c, c + rng.normal(0, .6, (nt, 3)).astype(
        np.float32), c + rng.normal(0, .6, (nt, 3)).astype(np.float32)])
    idx = np.stack([np.arange(nt), np.arange(nt) + nt,
                    np.arange(nt) + 2 * nt], -1)
    return verts, idx


def _every_chunk(acc, o, d, t_max, any_hit):
    """SweepAccelerator.intersect with every chunk launched."""
    n = o.shape[0]
    perm = acc.coherence_order(o, d, t_max)
    o, d, t_max = o[perm], d[perm], t_max[perm]
    c = acc.ray_chunk
    outs = [acc._traverse_chunk(o[s:s + c], d[s:s + c], t_max[s:s + c],
                                any_hit) for s in range(0, n, c)]
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n)
    return [torch.cat(x)[inv] for x in zip(*outs)]


@pytest.fixture(scope="module")
def soup(jx):
    verts, idx = _soup_tables(11)
    jt = jx.JTri.pack_triangle_mesh(jx.JT.identity(), idx, verts)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    jsw = jx.JS.PallasSweepAccelerator(jx.JC.build_clusters(jt, 16),
                                       group=4, block_rays=128,
                                       ray_chunk=1 << 16, interpret=True)
    tb = TS.SweepTables(TC.build_clusters(tt, 16), 4)
    rng = np.random.default_rng(12)
    o = rng.uniform(-8, 8, (300, 3)).astype(np.float32)
    d = rng.uniform(-4, 4, (300, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return types.SimpleNamespace(jsw=jsw, tb=tb, o=o, d=d, tt=tt)


@pytest.mark.parametrize("live", [0, 1, 64, 65, 300])
def test_intersect_skips_dead_chunks(jx, soup, live):
    # 300 rays in chunks of 64 (two blocks of 32): five chunks, the dead
    # lanes sorted last.
    jnp = jx.jnp
    rng = np.random.default_rng(live)
    t_max = np.full(300, -1.0, np.float32)
    t_max[rng.choice(300, live, replace=False)] = np.inf
    acc = TS.SweepAccelerator(soup.tb, "cpu", block_rays=32, ray_chunk=64)
    args = [torch.from_numpy(x) for x in (soup.o, soup.d, t_max)]
    got = acc.intersect(*args, False)
    assert acc.skipped_chunks == 5 - -(-live // 64)
    ref = _every_chunk(acc, *args, False)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r)
    jh, jt, ji = (np.asarray(x) for x in soup.jsw._chunked(
        jnp.asarray(soup.o), jnp.asarray(soup.d), jnp.asarray(t_max), False))
    jh = jh & np.isfinite(jt)   # the JAX wrapper's miss-as-hit (ROADMAP C)
    th, tt_, ti = (x.numpy() for x in got)
    np.testing.assert_array_equal(th, jh)
    assert th.sum() >= min(live, 30) // 3
    np.testing.assert_allclose(tt_[th], jt[th], rtol=1e-5, atol=1e-5)
    # Ids wherever the winning t is not within 1e-5 of another hit's.
    tr = soup.tt
    for i in np.nonzero(th)[0]:
        o, d = soup.o[i].astype(np.float64), soup.d[i].astype(np.float64)
        e1, e2 = tr.v1 - tr.v0, tr.v2 - tr.v0
        p = np.cross(d, e2)
        det = np.einsum("ij,ij->i", e1, p)
        s = o - tr.v0
        u = np.einsum("ij,ij->i", s, p) / det
        qv = np.cross(s, e1)
        v = (qv @ d) / det
        t = np.einsum("ij,ij->i", e2, qv) / det
        ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
        if (np.abs(t[ok] - jt[i]) <= 1e-5 * max(1.0, jt[i])).sum() == 1:
            assert ti[i] == ji[i]


def _cuda_case(kind):
    from trace_tpu_torch.models import mesh_heavy

    dev = torch.device("cuda")
    acc = mesh_heavy.build_scene(20_000, device=dev).accel
    o, d, t_max = _prologue_rays(acc.tables, 4096, seed=44)
    if kind == "sparse":
        t_max[np.arange(4096) % 40 != 0] = -1.0
    elif kind == "dead":
        t_max[:] = -1.0
    return acc, dev, (torch.from_numpy(x).to(dev) for x in (o, d, t_max))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "sparse", "dead"])
def test_cuda_prologue_kernel_matches_plain(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    acc, dev, rays = _cuda_case(kind)
    o_p, d_p, t_p = acc.pad_rays(*rays)
    args = (acc.s_lo, acc.s_hi, o_p, d_p, t_p, 32)
    launches = TS.block_entry_kernel.launches
    ko, ks = TS.block_entry_kernel(*args)
    po, ps = TS.prologue_plain(*args)
    to, ts = TS.prologue_torch(*args)
    torch.cuda.synchronize()
    assert TS.block_entry_kernel.launches == launches + 1
    assert torch.equal(ko, po) and torch.equal(to, po)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert torch.equal(ts.view(torch.int32), ps.view(torch.int32))
    assert torch.isfinite(ps).any() == (kind != "dead")


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [1, 8, 40])
def test_cuda_prologue_kernel_workspace_matches_plain(capacity):
    # The 20k mesh packed at group 1 (one cluster a super, ~300 supers);
    # rows with more finite entries than ``capacity`` sort in the global
    # workspace.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    acc = TS.SweepAccelerator(_heightfield_tables(20_000, 1), dev)
    o, d, t_max = _prologue_rays(acc.tables, 4096, seed=45)
    o_p, d_p, t_p = acc.pad_rays(*(torch.from_numpy(x).to(dev)
                                   for x in (o, d, t_max)))
    args = (acc.s_lo, acc.s_hi, o_p, d_p, t_p, 32)
    ko, ks = TS.block_entry_kernel(*args, key_capacity=capacity)
    po, ps = TS.prologue_plain(*args)
    torch.cuda.synchronize()
    assert int((torch.isfinite(ps).sum(dim=1) > capacity).sum()) > 10
    assert torch.equal(ko, po)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
