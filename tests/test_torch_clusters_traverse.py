"""The port's cluster traversal (trace_tpu_torch/accel/clusters.py: traverse,
_test_stage, _test_stage_mt, _bf16_floor, ClusterAccelerator) against the
JAX package's (trace_tpu/accel/clusters.py), on the CPU.

- build_clusters with super_size 1 and 4: every table equal to JAX's.
- _bf16_floor: bit-equal.
- traverse on the 400-triangle soup (seed 0) and 256 rays (seed 1) on
  JAX's own tables (convert.cluster_accel), for the matmul and the
  watertight stages, super_size 1 and 4, bf16 and f32 entries, certified,
  closest and any-hit: hit masks and ids equal, t within 1e-5 relative.
  The stage products associate otherwise in torch.matmul than in XLA's
  dot (and the watertight stage's XLA loop contracts into FMAs); the
  largest difference measured on these cases was 2.4e-7 relative.
- Any-hit with t_max = inf: the port's lanes retire on a hit only, so
  they find every lane closest-hit finds; JAX's retire at the first stage
  with no hit (inf <= inf), 12 of 57 found (ROADMAP C).
- ClusterAccelerator.refit equals a rebuild on the moved mesh; chunked
  and sorted equals one chunk.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wbvh import meshes, rays, soup
from trace_tpu.accel import clusters as JC
from trace_tpu_torch import convert as C
from trace_tpu_torch.accel import clusters as TC

T_RTOL = 1e-5
# (use_mxu, super_size, entry_bf16, certified, any_hit)
CASES = {
    "mxu": (True, 1, True, False, False),
    "watertight": (False, 1, True, False, False),
    "mxu_f32_entry": (True, 1, False, False, False),
    "mxu_super4": (True, 4, True, False, False),
    "watertight_super4_f32_entry": (False, 4, False, False, False),
    "certified": (True, 1, True, True, False),
    "certified_super4": (True, 4, True, True, False),
    "any_hit": (True, 1, True, False, True),
    "any_hit_super4": (True, 4, True, False, True),
}


@pytest.mark.parametrize("g", [1, 4])
def test_build_clusters_equals_jax(g):
    jt, tt = meshes(*soup(400, 0))
    ja = JC.build_clusters(jt, 16, 4, super_size=g)
    ta = TC.build_clusters(tt, 16, 4, super_size=g)
    for f in TC.ClusterAccel._fields:
        a, b = np.asarray(getattr(ja, f)), np.asarray(getattr(ta, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ta.super_size == g and ta.c_lo.shape[0] % g == 0


def test_bf16_floor_bit_equal():
    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(0, 10, 4096)).astype(np.float32)
    x[:8] = [0.0, np.inf, 1.0, 3.0e38, 1e-40, 2.0 ** -126, 0.1, 65504.0]
    j = np.asarray(JC._bf16_floor(jnp.asarray(x)).astype(jnp.float32))
    t = TC._bf16_floor(torch.from_numpy(x)).float().numpy()
    np.testing.assert_array_equal(t.view(np.uint32), j.view(np.uint32))
    assert (t <= x).all()


@pytest.mark.parametrize("case", list(CASES))
def test_traverse_matches_jax(case):
    use_mxu, g, bf16, cert, any_hit = CASES[case]
    jt, _ = meshes(*soup(400, 0))
    ja = JC.build_clusters(jt, 16, 4, super_size=g)
    o, d = rays(256, 1)
    tm = np.full(256, 4.0 if any_hit else np.inf, np.float32)
    kw = dict(use_mxu=use_mxu, entry_bf16=bf16, certified=cert)
    jh, jt_, ji = (np.asarray(x) for x in JC.traverse(
        ja, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm), 8, any_hit,
        **kw))
    stats = {}
    th, tt_, ti = (x.numpy() for x in TC.traverse(
        TC.to_device(C.cluster_accel(ja), "cpu"), *(torch.from_numpy(x)
                                                    for x in (o, d, tm)),
        8, any_hit, stats=stats, **kw))
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(ti[th], ji[th])
    np.testing.assert_allclose(tt_[th], jt_[th], rtol=T_RTOL)
    assert 20 < th.sum() < 256 and stats["stages"] >= 1


@pytest.mark.parametrize("g", [1, 4])
def test_refit_equals_rebuild(g):
    _, tt = meshes(*soup(400, 0))
    shift = np.float32([0.25, -0.5, 0.125])
    moved = tt._replace(v0=tt.v0 + shift, v1=tt.v1 + shift,
                        v2=tt.v2 + shift)
    acc = TC.ClusterAccelerator(TC.build_clusters(tt, 16, 4, super_size=g),
                                "cpu", stage_clusters=8)
    acc.refit(torch.from_numpy(moved.v0), moved.v1, moved.v2)
    fresh = TC.build_clusters(moved, 16, 4, super_size=g)
    np.testing.assert_array_equal(fresh.tri_id, acc.clusters.tri_id)
    real = (fresh.tri_id >= 0).any(1)   # the padding rows' boxes differ
    for f in ("s_lo", "s_hi", "packed", "packed_mt"):
        np.testing.assert_array_equal(getattr(acc.clusters, f),
                                      getattr(fresh, f), err_msg=f)
    for f in ("c_lo", "c_hi"):
        np.testing.assert_array_equal(getattr(acc.clusters, f)[real],
                                      getattr(fresh, f)[real], err_msg=f)
    assert not np.array_equal(acc.clusters.s_lo, TC.build_clusters(
        tt, 16, 4, super_size=g).s_lo)
    o, d = (torch.from_numpy(x) for x in rays(256, 1))
    tm = torch.full((256,), float("inf"))
    got = acc.intersect(o, d, tm, False)
    want = TC.ClusterAccelerator(fresh, "cpu", stage_clusters=8).intersect(
        o, d, tm, False)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_any_hit_with_infinite_t_max_retires_on_hits_only():
    jt, tt = meshes(*soup(400, 0))
    ja = JC.build_clusters(jt, 16, 4)
    o, d = rays(400, 6)
    tm = np.full(400, np.inf, np.float32)
    args = [torch.from_numpy(x) for x in (o, d, tm)]
    acc = TC.to_device(TC.build_clusters(tt, 16, 4), "cpu")
    closest = TC.traverse(acc, *args, 8, False)[0]
    occ = TC.traverse(acc, *args, 8, True)[0]
    assert torch.equal(occ, closest) and int(closest.sum()) == 57
    jocc = np.asarray(JC.traverse(ja, *(jnp.asarray(x) for x in (o, d, tm)),
                                  8, True)[0])
    assert jocc.sum() == 12 and not (jocc & ~occ.numpy()).any()


def test_chunked_sorted_equals_one_chunk():
    _, tt = meshes(*soup(400, 0))
    ca = TC.build_clusters(tt, 16, 4)
    o, d = (torch.from_numpy(x) for x in rays(400, 6))
    tm = torch.full((400,), float("inf"))
    tm[::3] = 5.0
    one = TC.ClusterAccelerator(ca, "cpu", 8, ray_chunk=1 << 20)
    many = TC.ClusterAccelerator(ca, "cpu", 8, ray_chunk=64)
    for any_hit in (False, True):
        a, b = one.intersect(o, d, tm, any_hit), many.intersect(o, d, tm,
                                                                  any_hit)
        assert torch.equal(a[0], b[0])
        assert torch.equal(a[1], b[1]) and torch.equal(a[2][a[0]],
                                                       b[2][b[0]])
