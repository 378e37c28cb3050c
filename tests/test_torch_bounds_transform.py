"""The port's core/bounds.py and the rest of core/transform.py against the
JAX package's (trace_tpu/core/{bounds,transform}.py) on the same seeded
numpy inputs. JAX runs op by op here, one rounding an operation as torch
and numpy do, so the results are held equal, with two stated bounds:
slerp goes through arccos, cos and sin, whose float32 roundings differ
between XLA and numpy, so its components are held within 2 ulp of 1
(2.4e-7; measured 1.2e-7); and torch's CPU sqrt is not correctly rounded
(1 ulp off on 0.7% of inputs, where XLA's and numpy's agree), so the
bounding sphere's radius is held within 1 ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from trace_tpu.core import bounds as JB
from trace_tpu.core import transform as JT
from trace_tpu_torch.core import bounds as TB
from trace_tpu_torch.core import transform as TT

N = 512
SLERP_ATOL = 2.0 ** -22


def _np(x):
    return np.asarray(x.cpu().numpy() if torch.is_tensor(x) else x)


def _transforms(mod, rng):
    """A few transforms of each kind, built by ``mod`` from the same
    seeded parameters: rotations about random axes, scales (one mirrored),
    translations, compositions and a perspective projection."""
    axes = rng.normal(size=(4, 3))
    degs = rng.uniform(-180.0, 180.0, 4)
    out = [mod.rotate(float(d), a) for d, a in zip(degs, axes)]
    out += [mod.scale(2.0, 0.5, 1.5), mod.scale(-1.0, 1.0, 1.0),
            mod.translate(rng.normal(size=3).astype(np.float32))]
    out.append(mod.compose(out[-1], out[0], out[4]))
    out.append(mod.perspective(60.0, 0.01, 100.0))
    return out


def _boxes(rng, n=N):
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    return a, b


def test_rotate_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(16):
        deg, axis = float(rng.uniform(-360, 360)), rng.normal(size=3)
        t, j = TT.rotate(deg, axis), JT.rotate(deg, axis)
        np.testing.assert_array_equal(t.m, j.m)
        np.testing.assert_array_equal(t.inv_m, j.inv_m)


def test_apply_normal_and_bounds_match_jax():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(N, 3)).astype(np.float32)
    lo, hi = _boxes(rng)
    for t, j in zip(_transforms(TT, np.random.default_rng(2)),
                    _transforms(JT, np.random.default_rng(2))):
        np.testing.assert_array_equal(t.m, j.m)
        np.testing.assert_array_equal(
            _np(TT.apply_normal(t, torch.from_numpy(n))),
            np.asarray(JT.apply_normal(j, jnp.asarray(n))))
        tb = TT.apply_bounds(t, TB.from_points(torch.from_numpy(lo),
                                               torch.from_numpy(hi)))
        jb = JT.apply_bounds(j, JB.from_points(jnp.asarray(lo),
                                               jnp.asarray(hi)))
        np.testing.assert_array_equal(_np(tb.p_min), np.asarray(jb.p_min))
        np.testing.assert_array_equal(_np(tb.p_max), np.asarray(jb.p_max))


def test_handedness_and_scale_match_jax():
    ts = _transforms(TT, np.random.default_rng(3))
    js = _transforms(JT, np.random.default_rng(3))
    got = [(bool(TT.swaps_handedness(t)), bool(TT.has_scale(t)))
           for t in ts]
    want = [(bool(JT.swaps_handedness(j)), bool(JT.has_scale(j)))
            for j in js]
    assert got == want
    # Each answer occurs: a mirror, a scale, a pure rotation.
    assert {g[0] for g in got} == {True, False}
    assert {g[1] for g in got} == {True, False}


def test_quaternions_match_jax():
    rng = np.random.default_rng(4)
    # Rotations near 180 degrees take the largest-diagonal branches.
    degs = np.concatenate([rng.uniform(-170, 170, 12),
                           [179.0, -179.5, 180.0, 0.0]])
    axes = rng.normal(size=(degs.size, 3))
    axes[-4:-1] = np.eye(3)
    tq, jq = [], []
    for d, a in zip(degs, axes):
        t, j = TT.rotate(float(d), a), JT.rotate(float(d), a)
        q, r = TT.quat_from_transform(t), JT.quat_from_transform(j)
        np.testing.assert_array_equal(q.v, np.asarray(r.v))
        np.testing.assert_array_equal(q.w, np.asarray(r.w))
        np.testing.assert_array_equal(TT.quat_to_transform(q).m,
                                      np.asarray(JT.quat_to_transform(r).m))
        tq.append(q)
        jq.append(r)
    branches = {int(np.argmax(np.diag(TT.rotate(float(d), a).m)[:3]))
                for d, a in zip(degs[-4:-1], axes[-4:-1])}
    assert branches == {0, 1, 2}
    i = TT.quat_identity()
    ji = JT.quat_identity()
    np.testing.assert_array_equal(i.v, np.asarray(ji.v))
    np.testing.assert_array_equal(i.w, np.asarray(ji.w))
    for a, b, ja, jb in zip(tq, tq[1:], jq, jq[1:]):
        np.testing.assert_array_equal(TT.quat_dot(a, b),
                                      np.asarray(JT.quat_dot(ja, jb)))
        n, jn = TT.quat_normalize(a), JT.quat_normalize(ja)
        np.testing.assert_array_equal(n.v, np.asarray(jn.v))
        for t in (0.0, 0.25, 0.5, 1.0):
            s = TT.slerp(a, b, np.float32(t))
            js = JT.slerp(ja, jb, jnp.float32(t))
            for x, y in ((s.v, js.v), (s.w, js.w)):
                np.testing.assert_allclose(x, np.asarray(y), rtol=0,
                                           atol=SLERP_ATOL)
    # The near-parallel branch: a normalized lerp.
    a = TT.quat_from_transform(TT.rotate_z(10.0))
    b = TT.quat_from_transform(TT.rotate_z(11.0))
    s = TT.slerp(a, b, np.float32(0.5))
    js = JT.slerp(JT.quat_from_transform(JT.rotate_z(10.0)),
                  JT.quat_from_transform(JT.rotate_z(11.0)),
                  jnp.float32(0.5))
    assert float(TT.quat_dot(a, b)) > 0.9995
    np.testing.assert_array_equal(s.v, np.asarray(js.v))
    np.testing.assert_array_equal(s.w, np.asarray(js.w))


def test_bounds_functions_match_jax():
    rng = np.random.default_rng(5)
    a, b = _boxes(rng)
    p = rng.normal(size=(N, 3)).astype(np.float32)
    c, d = _boxes(rng)
    tb = TB.from_points(torch.from_numpy(a), torch.from_numpy(b))
    jb = JB.from_points(jnp.asarray(a), jnp.asarray(b))
    tb2 = TB.from_points(torch.from_numpy(c), torch.from_numpy(d))
    jb2 = JB.from_points(jnp.asarray(c), jnp.asarray(d))
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    pairs = [
        (TB.union(tb, tb2), JB.union(jb, jb2)),
        (TB.union_point(tb, tp), JB.union_point(jb, jp)),
        (TB.intersect_bounds(tb, tb2), JB.intersect_bounds(jb, jb2)),
        (TB.expand(tb, 0.25), JB.expand(jb, 0.25)),
        (TB.from_point(tp), JB.from_point(jp)),
    ]
    for t, j in pairs:
        np.testing.assert_array_equal(_np(t.p_min), np.asarray(j.p_min))
        np.testing.assert_array_equal(_np(t.p_max), np.asarray(j.p_max))
    inter = TB.intersect_bounds(tb, tb2)
    jinter = JB.intersect_bounds(jb, jb2)
    values = [
        (TB.is_valid(tb), JB.is_valid(jb)),
        (TB.is_valid(TB.empty3("cpu")), JB.is_valid(JB.empty3())),
        (TB.inside(tb, tp), JB.inside(jb, jp)),
        (TB.inside(inter, tp), JB.inside(jinter, jp)),
        (TB.diagonal(tb), JB.diagonal(jb)),
        (TB.surface_area(tb), JB.surface_area(jb)),
        (TB.volume(tb), JB.volume(jb)),
        (TB.maximum_extent(tb), JB.maximum_extent(jb)),
        (TB.offset(tb, tp), JB.offset(jb, jp)),
        (TB.offset(inter, tp), JB.offset(jinter, jp)),
        (TB.lerp(tb, 0.3), JB.lerp(jb, 0.3)),
        (TB.bounding_sphere(tb)[0], JB.bounding_sphere(jb)[0]),
        (TB.bounding_sphere(inter)[0], JB.bounding_sphere(jinter)[0]),
        *[(TB.corner(tb, k), JB.corner(jb, k)) for k in range(8)],
    ]
    for i, (t, j) in enumerate(values):
        np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=str(i))
    for t, j in ((tb, jb), (inter, jinter)):
        np.testing.assert_array_max_ulp(_np(TB.bounding_sphere(t)[1]),
                                        np.asarray(JB.bounding_sphere(j)[1]),
                                        maxulp=1)
    assert (_np(TB.bounding_sphere(inter)[1]) == 0).any()
    e = TB.empty3("cpu")
    np.testing.assert_array_equal(_np(e.p_min), np.asarray(JB.empty3().p_min))
    assert not bool(TB.is_valid(e)) and bool(TB.is_valid(tb).all())
    assert set(_np(TB.maximum_extent(tb)).tolist()) == {0, 1, 2}
    t2 = TB.union(TB.Bounds2(tp[:, :2], tp[:, :2] + 1.0),
                  TB.Bounds2(torch.from_numpy(a[:, :2]),
                             torch.from_numpy(b[:, :2])))
    j2 = JB.union(JB.Bounds2(jp[:, :2], jp[:, :2] + 1.0),
                  JB.Bounds2(jnp.asarray(a[:, :2]), jnp.asarray(b[:, :2])))
    assert isinstance(t2, TB.Bounds2)
    np.testing.assert_array_equal(_np(t2.p_min), np.asarray(j2.p_min))
    np.testing.assert_array_equal(_np(t2.p_max), np.asarray(j2.p_max))


def _plane_rays(rng, n=N):
    """Rays against the unit box: half random, half with the origin on
    one of the box's six planes and the direction parallel to it (the
    0 * inf = NaN axis), some of them along an edge (two zero
    components)."""
    o = rng.uniform(-2.0, 3.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    half = np.arange(n) >= n // 2
    axis = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n).astype(np.float32)
    rows = np.nonzero(half)[0]
    o[rows, axis[rows]] = side[rows]
    d[rows, axis[rows]] = 0.0
    edge = rows[::3]
    d[edge, (axis[edge] + 1) % 3] = 0.0
    return o, d


@pytest.mark.parametrize("t_max", [np.inf, 2.5])
def test_slab_tests_match_jax_on_rays_in_the_box_planes(t_max):
    rng = np.random.default_rng(6)
    o, d = _plane_rays(rng)
    lo = np.zeros(3, np.float32)
    hi = np.ones(3, np.float32)
    tb = TB.from_points(torch.from_numpy(lo), torch.from_numpy(hi))
    jb = JB.from_points(jnp.asarray(lo), jnp.asarray(hi))
    tm = np.float32(t_max)
    hit, t0, t1 = TB.ray_intersect(tb, torch.from_numpy(o),
                                   torch.from_numpy(d), float(tm))
    jhit, jt0, jt1 = JB.ray_intersect(jb, jnp.asarray(o), jnp.asarray(d),
                                      jnp.float32(tm))
    for x, y in ((hit, jhit), (t0, jt0), (t1, jt1)):
        np.testing.assert_array_equal(_np(x), np.asarray(y))
    with np.errstate(divide="ignore"):
        inv = (np.float32(1) / d).astype(np.float32)
    p = TB.ray_intersect_p(tb, torch.from_numpy(o), torch.from_numpy(inv),
                           float(tm))
    jp = JB.ray_intersect_p(jb, jnp.asarray(o), jnp.asarray(inv),
                            jnp.float32(tm))
    np.testing.assert_array_equal(_np(p), np.asarray(jp))
    # The plane rays produce NaN slab distances, taken as overlapping: a
    # ray inside a face's span hits, one beside it misses, and no t is
    # NaN.
    on = np.arange(N) >= N // 2
    assert not np.isnan(_np(t0)).any() and not np.isnan(_np(t1)).any()
    assert 0 < int(_np(hit)[on].sum()) < int(on.sum())
