"""The port's SAH tree, refit and "bvh" walk (trace_tpu_torch/accel/bvh.py,
accel/native.py) against the JAX package's (trace_tpu/accel/bvh.py), on
the CPU.

- build_bvh: the port's native tree (its own csrc/bvh_builder.cpp) and its
  numpy tree are equal, array for array, to JAX's build_bvh(native=True)
  on the 400-triangle soups (seeds 0, 1) and the 13x13 heightfield.
- refit_bvh, native and numpy, equals JAX's on moved vertices, and a
  refit to the build's own bounds gives the tree back.
- On JAX's own tree (convert.linear_bvh), the walk's "bvh" limit against
  the vmapped _traverse_one, closest and any-hit: hit masks equal, ids
  equal where t is not tied, t within 1e-6 relative (XLA contracts the
  jitted loop's products into FMAs; ROADMAP C).
- BVHAccelerator and attach: the same answers through the accelerator
  interface, any-hit within t_max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_certified import _grid
from test_torch_wbvh import assert_agree, meshes, rays, soup
from trace_tpu.accel import bvh as JB
from trace_tpu.shapes import triangle as JTri
from trace_tpu_torch import convert as C
from trace_tpu_torch.accel import bvh as TB
from trace_tpu_torch.accel import wbvh as TW
from trace_tpu_torch.shapes import triangle as TTri

SHAPES = {
    "soup0": lambda: soup(400, 0),
    "soup1": lambda: soup(400, 1),
    "grid13": lambda: _grid()[:2],
}


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_build_bvh_equals_jax(shape, native):
    jt, tt = meshes(*SHAPES[shape]())
    jb = JB.build_bvh(JTri.world_bounds_np(jt), 4, native=True)
    tb = TB.build_bvh(TTri.world_bounds_np(tt), 4, native=native)
    for f in TB.LinearBVH._fields:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _moved(idx, verts, seed=2):
    rng = np.random.default_rng(seed)
    v = verts + np.float32([0.3, -0.2, 0.1]) + rng.normal(
        0, 0.05, verts.shape).astype(np.float32)
    return meshes(idx, v.astype(np.float32))


@pytest.mark.parametrize("native", [True, False])
def test_refit_bvh_equals_jax(native):
    idx, verts = soup(400, 0)
    jt, tt = meshes(idx, verts)
    jb = JB.build_bvh(JTri.world_bounds_np(jt), 4)
    tb = TB.build_bvh(TTri.world_bounds_np(tt), 4)
    jm, tm = _moved(idx, verts)
    jr = JB.refit_bvh(jb, JTri.world_bounds_np(jm))
    tr = TB.refit_bvh(tb, TTri.world_bounds_np(tm), native=native)
    for f in TB.LinearBVH._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f), err_msg=f)
    assert not np.array_equal(tr.lo, tb.lo)
    back = TB.refit_bvh(tr, TTri.world_bounds_np(tt), native=native)
    np.testing.assert_array_equal(back.lo, tb.lo)
    np.testing.assert_array_equal(back.hi, tb.hi)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_walk_matches_traverse_one(seed, any_hit):
    jt, tt = meshes(*soup(400, seed))
    jb = JB.build_bvh(JTri.world_bounds_np(jt), 4)
    o, d = rays(256, seed + 1)
    tm = np.full(256, np.inf, np.float32)
    tm[::4] = 4.0
    jh, jt_, ji = jax.vmap(lambda oo, dd, t: JB._traverse_one(
        jb, jt, oo, dd, t, 4, any_hit))(jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(tm))
    bvh = C.linear_bvh(jb)
    nodes = TW.pack_nodes(bvh)
    rows = TW.pack_leaf_tris(tt, np.asarray(bvh.prim_order, np.int64))
    t, i = TW.walk_plain(*(torch.from_numpy(x) for x in (nodes, rows, o, d,
                                                          tm)),
                         any_hit=any_hit, limit="bvh")
    port = ((i >= 0).numpy(), t.numpy(), i.clamp_min(0).numpy())
    jax_ = tuple(np.asarray(x) for x in (jh, jt_, ji))
    if any_hit:   # the first hit found, in the same visit order
        np.testing.assert_array_equal(port[0], jax_[0])
        np.testing.assert_array_equal(port[2][port[0]], jax_[2][port[0]])
    else:
        assert_agree(port, jax_)
    assert 20 < port[0].sum() < 256


def test_bvh_accelerator_and_attach():
    _, tt = meshes(*soup(400, 0))
    scene = type("S", (), dict(n_triangles=400, triangles=tt,
                               device=torch.device("cpu")))()
    TB.attach(scene)
    acc = scene.accel
    assert isinstance(acc, TB.BVHAccelerator)
    assert acc.walk.stack_depth == TB.STACK_DEPTH and acc.walk.limit == "bvh"
    o, d = (torch.from_numpy(x) for x in rays(256, 1))
    tm = torch.full((256,), 4.0)
    hit, t, idx = acc.intersect(o, d, tm, False)
    ref_t, ref_i = TW.walk_plain(acc.walk.nodes, acc.walk.tris, o, d, tm,
                                 any_hit=False, limit="bvh")
    assert torch.equal(hit, ref_i >= 0) and torch.equal(t, ref_t)
    assert torch.equal(idx, ref_i.clamp_min(0))
    occ = acc.intersect(o, d, tm, True)[0]
    assert torch.equal(occ, hit) and bool((t[hit] <= 4.0).all())
