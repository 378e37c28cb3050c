"""The port's instanced geometry (trace_tpu_torch/accel/instances.py and
the scene tables around it) against the JAX package's
accel/instances.py, on the same inputs made from a seed.

Cases: four tetrahedra (brute-force base), a 128-triangle height grid
(the base's sweep: the plain version on the CPU), and 25 copies of a
clipped and of an unclipped sphere; each instance set has overlapping
copies (one exact duplicate) so instances tie, and a mirrored copy.

Tolerances: instance tables and bases equal as arrays. The walk against
op-by-op JAX (``jax.disable_jit()``; jitted JAX contracts the transforms
into FMAs, ROADMAP C): hit masks equal, t, element and instance equal on
the brute-force and sphere bases; through the sweep, t within 1e-6
relative (its Moller-Trumbore epilogue is not the JAX cluster sweep's)
and the triangle equal but where two triangles of the base tie (shared
edges, ROADMAP C). Any-hit with finite limits: hit masks equal. Hit
records within 2e-5 (the port's planar normalize multiplies by the
reciprocal, JAX's packed one divides).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_jax_arrays import arrays_from_jax, both3, jax_rules, np3
from trace_tpu.core import transform as JT
from trace_tpu.materials.materials import MatteMaterial as JMatte
from trace_tpu.scene import SceneBuilder as JSceneBuilder
from trace_tpu_torch import convert as C
from trace_tpu_torch.accel import instances as TI
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.materials.materials import MatteMaterial as TMatte
from trace_tpu_torch.ops.sweep import SweepAccelerator
from trace_tpu_torch.scene import SceneBuilder as TSceneBuilder

REC_ATOL = 2e-5
N_RAYS = 512


def tetra():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     np.float32)
    idx = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.uint32)
    return idx, verts


def grid_mesh(n=9):
    """(n-1)^2 * 2 triangles of a wavy height grid: above the 64 that
    take the brute-force grid."""
    xs = np.linspace(0.0, 1.0, n, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gz = 0.1 * np.sin(6.0 * gx) * np.cos(5.0 * gy)
    verts = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (ii * n + jj).reshape(-1)
    tris = np.concatenate(
        [np.stack([v00, v00 + n, v00 + 1], -1),
         np.stack([v00 + 1, v00 + n, v00 + n + 1], -1)], 0).astype(np.uint32)
    return tris, verts


def transforms(T):
    """test_instances.py's four placements, an exact duplicate of the
    first (ties) and a mirrored copy overlapping it."""
    return [
        T.translate([0.0, 0.0, -3.0]),
        T.compose(T.translate([2.0, 0.5, -4.0]), T.rotate_y(40.0)),
        T.compose(T.translate([-2.0, -0.5, -5.0]),
                  T.compose(T.rotate_x(25.0), T.scale(1.5, 0.8, 1.2))),
        T.compose(T.translate([0.5, 2.0, -6.0]), T.rotate_z(70.0)),
        T.translate([0.0, 0.0, -3.0]),
        T.compose(T.translate([0.2, 0.1, -3.2]), T.scale(-1.0, 1.0, 1.0)),
    ]


def sphere_transforms(T, n_side=5):
    return [T.translate([1.6 * i - 0.8 * n_side, 0.9 * j - 0.45 * n_side,
                         -6.0]) for i in range(n_side) for j in range(n_side)
            ] + [T.translate([-4.0, -2.25, -6.0])]   # a duplicate


def sphere_entry(T, clipped):
    e = dict(object_to_world=T.compose(T.rotate_x(30.0),
                                       T.scale(1.0, 1.0, 1.3)),
             radius=0.6, material_id=0)
    if clipped:
        e.update(z_min=-0.45, z_max=0.5, phi_max=300.0)
    return e


def build(mod, sb, matte, case, normals=None):
    """(scene, its one instanced geometry) of a case, by ``mod``'s own
    SceneBuilder (the JAX package's or the port's)."""
    b = sb()
    mat = b.material(matte(Kd=(0.7, 0.6, 0.5)))
    other = b.material(matte(Kd=(0.2, 0.3, 0.4)))
    if case in ("tetra", "grid"):
        idx, verts = tetra() if case == "tetra" else grid_mesh()
        b.instanced_mesh(idx, verts, transforms(mod), mat, normals=normals,
                         material_ids=[-1, -1, other, -1, -1, other])
    else:
        b.instanced_spheres([sphere_entry(mod, case == "clipped")],
                            sphere_transforms(mod))
    scene = b.build() if sb is JSceneBuilder else b.build(device="cpu")
    return scene, scene.instanced[0]


CASES = ("tetra", "grid", "clipped", "unclipped")


@pytest.fixture(scope="module")
def scenes():
    return {c: (build(JT, JSceneBuilder, JMatte, c),
                build(TT, TSceneBuilder, TMatte, c)) for c in CASES}


def probe_rays(case, n=N_RAYS, seed=0):
    """test_instances.py's probe rays toward the instances."""
    rng = np.random.default_rng(seed)
    if case in ("tetra", "grid"):
        o = np.array([0.0, 0.3, 4.0], np.float32) + 0.3 * rng.normal(
            size=(n, 3)).astype(np.float32)
        tgt = np.stack([rng.uniform(-3, 3, n), rng.uniform(-1.5, 2.5, n),
                        rng.uniform(-6.5, -2.5, n)], -1)
    else:
        o = np.array([0.0, 0.5, 4.0], np.float32) + 0.4 * rng.normal(
            size=(n, 3)).astype(np.float32)
        tgt = np.stack([rng.uniform(-4.5, 4.5, n), rng.uniform(-3, 3, n),
                        np.full(n, -6.0)], -1)
    d = tgt.astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_tables_equal_jax(scenes, case):
    (js, jg), (ts, tg) = scenes[case]
    for f in TI.InstanceTable._fields:
        np.testing.assert_array_equal(getattr(tg.table, f),
                                      np.asarray(getattr(jg.table, f)), f)
    base = jax.tree.map(np.asarray, jg.base)
    for f in tg.base._fields:
        np.testing.assert_array_equal(getattr(tg.base, f),
                                      getattr(base, f), f)
    assert (tg.n_base, tg.n_instances) == (jg.n_base, jg.n_instances)
    assert ts.instanced_offsets == js._instanced_offsets
    np.testing.assert_array_equal(ts.world_lo, js.world_lo)
    np.testing.assert_array_equal(ts.world_hi, js.world_hi)
    assert (getattr(tg, "accel", None) is not None) == (case == "grid")
    if case == "grid":
        # The base's sweep tables, bit-equal to the JAX package's.
        a = arrays_from_jax(js)
        for f in C.SWEEP_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(tg.sweep_tables, f)), a["inst0_" + f], f)


def _walks(scenes, case, t_max, any_hit):
    (js, jg), (ts, tg) = scenes[case]
    o, d = probe_rays(case)
    (to, _), (td, _) = both3(o), both3(d)
    with jax.disable_jit():
        jr = jg.traverse(jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
                         any_hit)
    with jax_rules():
        tr = tg.traverse(to, td, torch.from_numpy(t_max), any_hit)
    return [x.numpy() for x in tr], [np.asarray(x) for x in jr]


@pytest.mark.parametrize("case", CASES)
def test_walk_matches_jax_closest(scenes, case):
    t_max = np.full(N_RAYS, np.inf, np.float32)
    t_max[::7] = 6.5       # limits that cut some instances
    t_max[3::11] = -1.0    # dead lanes
    (h, t, e, i), (jh, jt, je, ji) = _walks(scenes, case, t_max, False)
    np.testing.assert_array_equal(h, jh)
    assert h.sum() > 50
    if case == "grid":
        np.testing.assert_allclose(t, jt, rtol=1e-6)
        # The base's own ties (a ray through a shared edge) may take
        # either triangle; the instance must agree.
        tie = e != je
        both = h & jh
        rel = np.abs(t[both] - jt[both]) / jt[both]
        print(f"grid: {int(both.sum())} hits, t differs on "
              f"{int((rel > 0).sum())} (max rel {rel.max():.2e}), "
              f"triangles on {int(tie.sum())}")
        assert tie.sum() <= 2
        np.testing.assert_array_equal(i, ji)
    else:
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(e, je)
        np.testing.assert_array_equal(i, ji)
    if case in ("tetra", "clipped"):
        # The duplicate instance ties exactly; the first in demand order
        # (the earlier index, equal demand) keeps it.
        dup = 4 if case == "tetra" else 25
        assert not (i[h] == dup).any()


@pytest.mark.parametrize("case", CASES)
def test_walk_matches_jax_any_hit(scenes, case):
    rng = np.random.default_rng(3)
    lo = 4.0 if case in ("tetra", "grid") else 8.0   # spheres lie further
    t_max = rng.uniform(lo, lo + 6.0, N_RAYS).astype(np.float32)
    (h, t, _, _), (jh, jt, _, _) = _walks(scenes, case, t_max, True)
    np.testing.assert_array_equal(h, jh)
    assert 20 < h.sum() < N_RAYS
    assert (t[h] <= t_max[h]).all()


def test_any_hit_walks_on_without_a_hit():
    """With t_max = +inf, the JAX walk's any-hit test (best_t <= t_max)
    retires every lane after its first instance, hit or not; the port's
    retires a lane only on a hit, so any-hit sees every occluder
    (ROADMAP C). Its mask equals the closest hit's."""
    js, jg = build(JT, JSceneBuilder, JMatte, "tetra")
    ts, tg = build(TT, TSceneBuilder, TMatte, "tetra")
    o, d = probe_rays("tetra")
    (to, _), (td, _) = both3(o), both3(d)
    inf = torch.full((N_RAYS,), float("inf"))
    h_any = tg.traverse(to, td, inf, True)[0]
    h_closest = tg.traverse(to, td, inf, False)[0]
    assert torch.equal(h_any, h_closest) and int(h_any.sum()) > 50
    with jax.disable_jit():
        j_any = np.asarray(jg.traverse(jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(inf.numpy()), True)[0])
    missed = int(h_closest.sum()) - int(j_any.sum())
    print(f"JAX any-hit at t_max inf: {int(j_any.sum())} hits, "
          f"{missed} fewer than the closest hit's {int(h_closest.sum())}")
    assert not (j_any & ~h_any.numpy()).any() and missed > 0


@pytest.mark.parametrize("group", [1, 3, 64])
def test_walk_group_keeps_result(scenes, group):
    """Any group size gives the same walk (the module docstring's
    argument), on the spheres, where lanes retire in every group."""
    _, (ts, tg) = scenes["clipped"]
    o, d = probe_rays("clipped", seed=4)
    (to, _), (td, _) = both3(o), both3(d)
    tm = torch.full((N_RAYS,), float("inf"))
    ref = TI.sweep_instances(tg, to, td, tm, group=2)
    got = TI.sweep_instances(tg, to, td, tm, group=group, ray_chunk=100)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_negative_limits_are_dead(scenes):
    """Limits -inf and -1 give identical walks (nothing hits), for the
    instance walk and for the sweep accelerator inside it; the sweep
    counts a -inf lane dead and launches nothing for it."""
    _, (ts, tg) = scenes["grid"]
    o, d = probe_rays("grid")
    (to, _), (td, _) = both3(o), both3(d)
    tm = torch.full((N_RAYS,), float("inf"))
    neg = torch.arange(N_RAYS) % 3 == 0
    outs = [tg.traverse(to, td, torch.where(neg, v, tm))
            for v in (-float("inf"), -1.0)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert not outs[0][0][neg].any() and outs[0][0][~neg].any()

    acc = tg.accel
    assert isinstance(acc, SweepAccelerator)
    oa, da = to.arr(), td.arr()
    res = []
    for v in (-float("inf"), -1.0):
        res.append(acc.intersect(oa, da, torch.where(neg, v, tm), False))
        t_p = acc.pad_rays(oa, da, torch.where(neg, v, tm))[2]
        assert (t_p[:N_RAYS][neg] == -1.0).all()
    for a, b in zip(*res):
        assert torch.equal(a, b)
    before = acc.skipped_chunks
    acc.ray_chunk = 64
    try:
        allneg = torch.full((N_RAYS,), -float("inf"))
        assert acc.live_chunks(allneg) == []
        assert acc.live_chunks(torch.where(neg, float("nan"), -1.0)) != []
        h, t, _ = acc.intersect(oa, da, allneg, False)
        assert not h.any() and torch.isinf(t).all()
        assert acc.skipped_chunks - before == N_RAYS // 64
    finally:
        acc.ray_chunk = 65536


def _hit_fields(rec) -> dict:
    """A port HitP or a JAX SurfaceHit as numpy arrays by field."""
    if hasattr(rec, "uv"):
        g = {k: np.asarray(getattr(rec, k)) for k in (
            "p", "n", "ns", "dpdu", "dpdv", "s_dpdu", "s_dpdv", "s_dndu",
            "s_dndv", "wo", "t")}
        g["u"], g["v"] = np.asarray(rec.uv[:, 0]), np.asarray(rec.uv[:, 1])
    else:
        g = {k: np3(getattr(rec, k)) for k in (
            "p", "n", "ns", "dpdu", "dpdv", "s_dpdu", "s_dpdv", "s_dndu",
            "s_dndv", "wo")}
        g.update(t=rec.t.numpy(), u=rec.u.numpy(), v=rec.v.numpy())
    for k in ("prim_id", "material_id", "valid"):
        g[k] = np.asarray(getattr(rec, k))
    return g


def _records(jg, tg, case, offset):
    o, d = probe_rays(case, seed=5)
    (to, _), (td, _) = both3(o), both3(d)
    tm = torch.full((N_RAYS,), float("inf"))
    time = np.zeros(N_RAYS, np.float32)
    with jax_rules():
        h, _, e, i = tg.traverse(to, td, tm)
        trec = tg.make_hit_record(to, td, torch.from_numpy(time), e, i, h,
                                  prim_offset=offset)
    with jax.disable_jit():
        jrec = jg.make_hit_record(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(time),
            jnp.asarray(e.numpy()), jnp.asarray(i.numpy()),
            jnp.asarray(h.numpy()), prim_offset=offset)
    return _hit_fields(trec), _hit_fields(jrec), h.numpy()


def _check_records(t, j, h, min_hits):
    v = h & t["valid"] & j["valid"]
    np.testing.assert_array_equal(t["valid"], j["valid"])
    assert v.sum() > min_hits
    for k in ("prim_id", "material_id"):
        np.testing.assert_array_equal(t[k][v], j[k][v], k)
    for k in ("p", "n", "ns", "dpdu", "dpdv", "s_dpdu", "s_dpdv", "s_dndu",
              "s_dndv", "wo", "t", "u", "v"):
        np.testing.assert_allclose(t[k][v], j[k][v], rtol=REC_ATOL,
                                   atol=REC_ATOL, err_msg=k)


@pytest.mark.parametrize("with_normals", [False, True])
def test_mesh_hit_records_match_jax(with_normals):
    """Tetra copies, one mirrored, with and without vertex normals: the
    mirror flips the shading normal only where the base has them."""
    idx, verts = tetra()
    normals = None
    if with_normals:
        nv = verts - verts.mean(0)
        normals = (nv / np.linalg.norm(nv, axis=-1, keepdims=True)).astype(
            np.float32)
    (js, jg) = build(JT, JSceneBuilder, JMatte, "tetra", normals)
    (ts, tg) = build(TT, TSceneBuilder, TMatte, "tetra", normals)
    assert tg.table.swaps.tolist() == [False] * 5 + [True]
    t, j, h = _records(jg, tg, "tetra", offset=7)
    _check_records(t, j, h, 40)
    mirrored = h & (t["prim_id"] >= 7 + 5 * 4)
    assert mirrored.sum() > 3


@pytest.mark.parametrize("case", ["clipped", "unclipped"])
def test_sphere_hit_records_match_jax(scenes, case):
    (js, jg), (ts, tg) = scenes[case]
    t, j, h = _records(jg, tg, case, offset=3)
    _check_records(t, j, h, 100)


def test_compose44_sums_in_k_order():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(64, 4, 4)).astype(np.float32)
    b = rng.normal(size=(64, 4, 4)).astype(np.float32)
    ref = np.zeros((64, 4, 4), np.float32)
    for k in range(4):
        ref = ref + a[:, :, k:k + 1] * b[:, k:k + 1, :]
    got = TI.compose44(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)
