"""The port's Scene ray queries and SceneBuilder.build options against the
JAX package's, on small fixture scenes carried across with convert.py
(every JAX query of a scene in one jitted call).

Scenes: test_lights_scene.py's two spheres and sphere-behind-triangle,
the shadows scene, a one-sided and a two-sided emissive triangle, a
300-triangle mesh_heavy terrain (through the sweep's plain version), and
four instanced tetrahedra beside a sphere.

Gates: hit masks, primitive and material ids equal; t, p and n within
rtol 1e-4 / atol 1e-4 of the jitted JAX query (jitted JAX contracts into
FMAs, the port rounds each operation, ROADMAP C; measured up to 9.4e-5
on the sphere-behind-triangle scene); occlusion, unoccluded and
transmittance equal (on the instanced scene only where t_max is finite:
JAX's any-hit instance walk stops lanes without a hit at t_max = inf,
ROADMAP C); emitted radiance within 1e-6.
intersect_p equals intersect's hit under the same t_max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_jax_arrays import jax_rules, port_scene
from trace_tpu.core import transform as JT
from trace_tpu.lights import lights as JL
from trace_tpu.materials.materials import MatteMaterial as JMatte
from trace_tpu.materials.textures import ConstantTexture as JConst
from trace_tpu.models import mesh_heavy as JMH
from trace_tpu.models import spheres as JSph
from trace_tpu.scene import SceneBuilder as JBuilder
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.lights import lights as TL
from trace_tpu_torch.materials.materials import MatteMaterial
from trace_tpu_torch.scene import SceneBuilder

N_RAYS = 512


def _two_spheres():
    b = JBuilder()
    mat = b.material(JMatte(Kd=(0.5, 0.5, 0.5)))
    b.sphere(JT.translate([0.0, 0.0, 0.0]), 1.0, mat)
    b.sphere(JT.translate([0.0, 0.0, -5.0]), 1.0, mat)
    b.light(JL.point_light(JT.translate([0.0, 3.0, 0.0]), (10.0, 10.0, 10.0)))
    return b.build()


def _sphere_behind_triangle():
    b = JBuilder()
    mat = b.material(JMatte())
    b.sphere(JT.translate([0.0, 0.0, -3.0]), 1.0, mat)
    verts = np.array([[-1, -1, -1.5], [1, -1, -1.5], [0, 1, -1.5]],
                     np.float32)
    b.triangle_mesh(JT.identity(), np.array([[0, 1, 2]], np.uint32), verts,
                    mat)
    b.light(JL.point_light(JT.identity(), (1.0, 1.0, 1.0)))
    return b.build()


def _emitters():
    b = JBuilder()
    mid = b.material(JMatte(JConst([0.5, 0.5, 0.5]), JConst(0.0)))
    b.sphere(JT.translate([0.3, 0.3, -2.0]), 0.5, mid)
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    for two_sided, shift in ((False, 0.0), (True, 1.5)):
        b.triangle_mesh(JT.translate([shift, 0.0, 0.0]),
                        np.array([[0, 1, 2]], np.int64), verts,
                        material=mid, emission=(5.0, 4.0, 3.0 + shift),
                        two_sided=two_sided)
    return b.build()


def _tetra_instances():
    b = JBuilder()
    mat = b.material(JMatte())
    b.sphere(JT.translate([0.0, 0.0, -4.0]), 1.0, mat)
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                     np.float32)
    idx = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int64)
    xfs = [JT.translate([x, y, -1.0]) for x in (-1.5, 0.5) for y in
           (-1.5, 0.5)]
    b.instanced_mesh(idx, verts, xfs, mat)
    b.light(JL.point_light(JT.translate([0.0, 4.0, 2.0]), (5.0, 5.0, 5.0)))
    return b.build()


SCENES = {
    "two_spheres": _two_spheres,
    "sphere_behind_triangle": _sphere_behind_triangle,
    "shadows": lambda: JSph.build_scene(),
    "emitters": _emitters,
    "mesh300": lambda: JMH.build_scene(target_tris=300),
    "instanced": _tetra_instances,
}


def _rays(js, n=N_RAYS, seed=0):
    """Rays from points around the scene's bounds toward points inside
    them: most hit something, some miss; t_max inf, or finite on a third
    of the lanes."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(js.world_lo), np.asarray(js.world_hi)
    c, ext = (lo + hi) / 2, np.maximum(hi - lo, 1.0)
    o = c + (rng.random((n, 3)) - 0.5) * ext * 3.0
    tgt = c + (rng.random((n, 3)) - 0.5) * ext
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.full(n, np.inf)
    fin = rng.random(n) < 1 / 3
    t_max[fin] = rng.random(fin.sum()) * np.linalg.norm(ext) * 2
    return (o.astype(np.float32), d.astype(np.float32),
            t_max.astype(np.float32))


def _query_points(js, o, jhit):
    """(o_far, p1, p0, ng): points off the surfaces around the rays, and
    the hit points with their normals (the origins where a ray missed)."""
    rng = np.random.default_rng(3)
    p1 = (o + rng.normal(size=o.shape)).astype(np.float32)
    o_far = (o + rng.normal(size=o.shape) * 4.0).astype(np.float32)
    valid = np.asarray(jhit.valid)
    p0 = np.where(valid[:, None], np.asarray(jhit.p), o).astype(np.float32)
    ng = np.where(valid[:, None], np.asarray(jhit.n), 0.0).astype(np.float32)
    return o_far, p1, p0, ng


@pytest.fixture(scope="module", params=list(SCENES))
def case(request):
    """Per scene: the rays, the JAX hits and every other JAX query, in
    two jitted calls (the queries from hit points need the hits)."""
    js = SCENES[request.param]()
    o, d, tm = _rays(js)
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm)
    jhit, jocc = jax.jit(lambda o, d, t: (js.intersect(o, d, t),
                                          js.intersect_p(o, d, t)))(
        jo, jd, jt)
    pts = _query_points(js, o, jhit)

    @jax.jit
    def rest(hit, wo, o_far, p1, p0, ng):
        return dict(unocc=js.unoccluded(o_far, p1),
                    unocc_n=js.unoccluded(p0, p1, n_geom=ng),
                    trans=js.transmittance(o_far, p1),
                    le=js.area_light_radiance(hit, wo))

    jq = rest(jhit, -jd, *(jnp.asarray(a) for a in pts))
    return (request.param, js, port_scene(js), (o, d, tm), jhit, jocc,
            pts, {k: np.asarray(v) for k, v in jq.items()})


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_intersect_matches_jax(case):
    name, js, ts, (o, d, tm), jh = case[:5]
    with jax_rules():
        hit = ts.intersect(_t(o), _t(d), _t(tm))
    valid = hit.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(jh.valid))
    assert 0 < valid.sum() < len(valid) or name == "instanced"
    v = valid
    np.testing.assert_allclose(hit.t.numpy()[v], np.asarray(jh.t)[v],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(hit.prim_id.numpy()[v],
                                  np.asarray(jh.prim_id)[v])
    np.testing.assert_array_equal(hit.material_id.numpy()[v],
                                  np.asarray(jh.material_id)[v])
    for port, jax_ in ((hit.p, jh.p), (hit.n, jh.n)):
        np.testing.assert_allclose(port.arr().numpy()[v],
                                   np.asarray(jax_)[v], rtol=1e-4, atol=1e-4)
    # With a time array given, the same record.
    with jax_rules():
        again = ts.intersect(_t(o), _t(d), _t(tm),
                             time=torch.zeros(len(o)))
    assert torch.equal(again.t, hit.t)


def test_intersect_p_matches_jax_and_intersect(case):
    name, _, ts, (o, d, tm), _, jocc = case[:6]
    occ = ts.intersect_p(_t(o), _t(d), _t(tm))
    lanes = np.isfinite(tm) if name == "instanced" else slice(None)
    np.testing.assert_array_equal(occ.numpy()[lanes], np.asarray(jocc)[lanes])
    np.testing.assert_array_equal(
        occ.numpy(), ts.intersect(_t(o), _t(d), _t(tm)).valid.numpy())


def test_unoccluded_and_transmittance_match_jax(case):
    # Without a normal: between points off the surfaces. With one: from
    # the hit points, nudged along the normal.
    _, _, ts, _, _, _, (o_far, p1, p0, ng), jq = case
    got = ts.unoccluded(_t(o_far), _t(p1)).numpy()
    np.testing.assert_array_equal(got, jq["unocc"])
    np.testing.assert_array_equal(
        ts.unoccluded(_t(p0), _t(p1), n_geom=_t(ng)).numpy(), jq["unocc_n"])
    tr = ts.transmittance(_t(o_far), _t(p1))
    assert tr.shape == (len(p0), 3)
    np.testing.assert_array_equal(tr.numpy(), jq["trans"])
    assert (got.sum() > 0) and ((~got).sum() > 0)


def test_area_light_radiance_matches_jax(case):
    name, _, ts, (o, d, tm), _, _, _, jq = case
    hit = ts.intersect(_t(o), _t(d), _t(tm))
    got = ts.area_light_radiance(hit, _t(-d)).numpy()
    np.testing.assert_allclose(got, jq["le"], rtol=1e-6, atol=1e-6)
    if name == "emitters":
        lit = got.max(-1) > 0
        assert lit.sum() > 0
        # Both triangles emit toward the rays that reach their lit sides.
        assert set(np.unique(got[lit][:, 2]).round(3)) == {3.0, 4.5}


def test_transmittance_case_of_the_shadows_scene():
    # test_lights_scene.py's case on the port's own build of the scene.
    from trace_tpu_torch.models.spheres import build_scene

    scene = build_scene(device="cpu")
    p0 = torch.tensor([[0.3, 2.0, -2.2], [0.3, 2.0, -2.2]])
    p1 = torch.tensor([[0.3, -1.0, -2.2], [0.3, 1.9, -2.2]])
    tr = scene.transmittance(p0, p1).numpy()
    assert tr[0].max() == 0.0 and tr[1].min() == 1.0


def _port_mesh_builder(n_tris=300):
    from trace_tpu_torch.models import mesh_heavy

    verts, idx = mesh_heavy.heightfield(int(np.sqrt(n_tris / 2)) + 1)
    b = SceneBuilder()
    mat = b.material(MatteMaterial())
    b.triangle_mesh(TT.identity(), idx, verts, mat)
    b.sphere(TT.translate([0.0, 3.0, 0.0]), 0.5, mat)
    b.light(TL.point_light(TT.translate([0.0, 10.0, 0.0]), (50.0, 50.0,
                                                            50.0)))
    return b


def test_build_options_choose_the_route():
    b = _port_mesh_builder()
    sweep = b.build(device="cpu")
    assert sweep.accel is not None and sweep.n_triangles > 64
    brute = b.build(device="cpu", use_bvh=False)
    assert brute.accel is None and brute.chunk_size == 2048
    chunked = b.build(device="cpu", use_bvh=False, chunk_size=37)
    leaf1 = b.build(device="cpu", max_prims_per_leaf=1,
                    accelerator="pallas_sweep")
    assert leaf1.accel is not None
    lo, hi = sweep.world_lo, sweep.world_hi
    js = type("S", (), dict(world_lo=lo, world_hi=hi))
    o, d, tm = (_t(a) for a in _rays(js, 1024, seed=4))
    h = {k: s.intersect(o, d, tm) for k, s in (
        ("sweep", sweep), ("brute", brute), ("chunked", chunked),
        ("leaf1", leaf1))}
    for k in ("brute", "chunked", "leaf1"):
        assert torch.equal(h[k].valid, h["sweep"].valid), k
        v = h["sweep"].valid
        np.testing.assert_allclose(h[k].t[v].numpy(), h["sweep"].t[v].numpy(),
                                   rtol=1e-5, atol=1e-6)
        tied = (h[k].t == h["sweep"].t) & v
        assert torch.equal(h[k].prim_id[tied], h["sweep"].prim_id[tied]), k
    # Chunking the brute-force grid changes nothing, bit for bit.
    for f in ("valid", "t", "prim_id"):
        assert torch.equal(getattr(h["chunked"], f), getattr(h["brute"], f))
    assert torch.equal(chunked.intersect_p(o, d, tm), brute.intersect_p(
        o, d, tm))


def test_use_bvh_true_puts_a_small_mesh_through_the_sweep():
    from trace_tpu_torch.models.spheres import build_scene

    scene = build_scene(device="cpu")            # 4 triangles: brute force
    assert scene.accel is None
    b = SceneBuilder()
    mat = b.material(MatteMaterial())
    verts = np.array([[-1, -1, -1.5], [1, -1, -1.5], [0, 1, -1.5],
                      [0, 0, -3.0]], np.float32)
    b.triangle_mesh(TT.identity(), np.array([[0, 1, 2], [0, 1, 3]]), verts,
                    mat)
    forced = b.build(device="cpu", use_bvh=True)
    plain = b.build(device="cpu")
    assert forced.accel is not None and plain.accel is None
    o = torch.tensor([[0.0, 0.0, 2.0], [0.0, -2.0, 2.0], [0.1, -0.5, 2.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    tm = torch.full((3,), float("inf"))
    a, b_ = forced.intersect(o, d, tm), plain.intersect(o, d, tm)
    assert a.valid.tolist() == b_.valid.tolist() == [True, False, True]
    v = a.valid
    np.testing.assert_allclose(a.t[v].numpy(), b_.t[v].numpy(), rtol=1e-6)
    assert a.prim_id[v].tolist() == b_.prim_id[v].tolist()


@pytest.mark.parametrize("accelerator", ["clusters", "wbvh"])
def test_accelerators_install_their_type(accelerator):
    from trace_tpu_torch.accel.clusters import ClusterAccelerator
    from trace_tpu_torch.accel.wbvh import WBVHAccelerator

    b = _port_mesh_builder()
    scene = b.build(device="cpu", accelerator=accelerator)
    kind = {"clusters": ClusterAccelerator, "wbvh": WBVHAccelerator}
    assert isinstance(scene.accel, kind[accelerator])
    # At 64 triangles or fewer, or with use_bvh=False, no accelerator.
    assert b.build(device="cpu", accelerator=accelerator,
                   use_bvh=False).accel is None
    sweep = b.build(device="cpu")
    lo, hi = sweep.world_lo, sweep.world_hi
    js = type("S", (), dict(world_lo=lo, world_hi=hi))
    o, d, tm = (_t(a) for a in _rays(js, 1024, seed=4))
    got, want = scene.intersect(o, d, tm), sweep.intersect(o, d, tm)
    assert torch.equal(got.valid, want.valid)
    v = want.valid
    np.testing.assert_allclose(got.t[v].numpy(), want.t[v].numpy(),
                               rtol=1e-5, atol=1e-6)
    tied = (got.t == want.t) & v
    assert torch.equal(got.prim_id[tied], want.prim_id[tied])
    assert torch.equal(scene.intersect_p(o, d, tm), sweep.intersect_p(
        o, d, tm))


def test_unknown_accelerator_raises():
    with pytest.raises(ValueError):
        _port_mesh_builder().build(device="cpu", accelerator="octree")
