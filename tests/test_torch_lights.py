"""The port's light table and light sampling (lights/lights.py,
wavefront/lights.py) against the JAX package, on JAX-built scenes carried
across by convert.scene_from_numpy: the Cornell box (its ceiling panel is
an area light) and a scene built here with a spot, a distant and a point
light. Tolerance: rtol 1e-5 with an absolute floor of 1e-6 (radiance,
wi, pdf, light points); the area CDF must be bit-equal, which the picks
at its bucket edges check.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_jax_arrays import both, both3, np3, port_scene
from trace_tpu.core import transform as JT
from trace_tpu.lights import lights as JL
from trace_tpu.materials import materials as JM
from trace_tpu.models import cornell as JC
from trace_tpu.scene import SceneBuilder as JSceneBuilder
from trace_tpu.wavefront import geom as JG
from trace_tpu.wavefront import lights as JWL
from trace_tpu.wavefront import whitted as JWF
from trace_tpu_torch.lights import lights as TL
from trace_tpu_torch.models import cornell as TC
from trace_tpu_torch.wavefront import geom as TG
from trace_tpu_torch.wavefront import lights as TWL
from trace_tpu_torch.wavefront import whitted as TWF

N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, msg=""):
    np.testing.assert_allclose(np3(t) if isinstance(t, tuple) else t.numpy(),
                               np3(j) if isinstance(j, tuple) else
                               np.asarray(j), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def _delta_scene():
    b = JSceneBuilder()
    white = b.material(JM.MatteMaterial(Kd=(0.8, 0.8, 0.8)))
    b.sphere(JT.translate([0.0, 0.5, 0.0]), 0.5, white)
    b.triangle_mesh(JT.identity(), np.array([[0, 1, 2], [0, 2, 3]], np.uint32),
                    np.array([[-3, 0, -3], [-3, 0, 3], [3, 0, 3], [3, 0, -3]],
                             np.float32), white)
    frm = np.array([1.0, 4.0, 1.0], np.float32)
    spot = JT.compose(JT.translate(frm), JT.inverse(JT.dir_to_z(-frm)))
    b.light(JL.spot_light(spot, (30.0, 20.0, 10.0), 30.0, 20.0))
    b.light(JL.distant_light(JT.rotate_x(30.0), (0.5, 0.6, 0.7),
                             (0.3, 1.0, 0.2)))
    b.light(JL.point_light(JT.translate([-2.0, 3.0, 1.0]), (9.0, 9.0, 9.0)))
    return b.build()


@pytest.fixture(scope="module")
def scenes():
    jc = JC.build_scene()
    jd = _delta_scene()
    return {"cornell": (jc, port_scene(jc)), "delta": (jd, port_scene(jd))}


def test_light_tables_match_jax(scenes):
    built = TC.build_scene(device="cpu")
    for name, (js, ts) in scenes.items():
        for f in ("kind", "flags", "p", "i", "direction", "w2l", "l2w",
                  "cos_total_width", "cos_falloff_start", "tri_start",
                  "tri_count", "total_area", "two_sided", "world_center",
                  "world_radius"):
            np.testing.assert_array_equal(getattr(ts.lights, f),
                                          np.asarray(getattr(js.lights, f)),
                                          err_msg=f"{name} {f}")
        np.testing.assert_array_equal(TL.is_delta(ts.lights),
                                      np.asarray(JL.is_delta(js.lights)))
        assert ts.max_area_tris == js.max_area_tris
    jc = scenes["cornell"][0]
    for f in ("kind", "flags", "p", "i", "tri_start", "tri_count",
              "total_area", "two_sided", "world_radius"):
        np.testing.assert_array_equal(getattr(built.lights, f),
                                      np.asarray(getattr(jc.lights, f)), f)
    np.testing.assert_array_equal(built.tri_light_id.numpy(),
                                  np.asarray(jc.tri_light_id))


def _p_ref(rng, lo, hi):
    return rng.uniform(lo, hi, (N, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["cornell", "delta"])
def test_sample_li_static_matches_jax(scenes, name):
    js, ts = scenes[name]
    rng = np.random.default_rng(3)
    tp, jp = both3(_p_ref(rng, -0.95, 0.95))
    tu0, ju0 = both(rng.uniform(0, 1, N).astype(np.float32))
    tu1, ju1 = both(rng.uniform(0, 1, N).astype(np.float32))
    kinds = set()
    for j in range(TWL.light_count(ts)):
        kinds.add(TWL.kind_of(ts, j))
        assert TWL.kind_of(ts, j) == JWL.kind_of(js, j)
        t = TWL.sample_li_static(ts, j, tp, tu0, tu1)
        jj = JWL.sample_li_static(js, j, jp, ju0, ju1)
        for k, what in enumerate(("radiance", "wi", "pdf", "p_light")):
            _close(t[k], jj[k], f"light {j} {what}")
        assert bool((t[0].x > 0).any())
    assert kinds == ({TL.AREA} if name == "cornell"
                     else {TL.SPOT, TL.DISTANT, TL.POINT})


def test_area_cdf_bit_equal_at_bucket_edges(scenes):
    js, ts = scenes["cornell"]
    j = int(np.flatnonzero(ts.lights.kind == TL.AREA)[0])
    start, count = int(ts.lights.tri_start[j]), int(ts.lights.tri_count[j])
    cdf = TWL.area_cdf(ts.triangles, start, count)
    assert cdf.dtype == np.float32 and cdf[-1] == np.float32(1.0)
    # u0 exactly on, just below and just above every edge: a CDF one ulp
    # off in either package would pick the neighbouring triangle.
    u0 = np.concatenate([cdf, np.nextafter(cdf, np.float32(0)),
                         np.nextafter(cdf, np.float32(1))]).astype(np.float32)
    u0 = np.clip(u0, 0, np.nextafter(np.float32(1), np.float32(0)))
    u1 = np.full(u0.shape, 0.25, np.float32)
    n = u0.shape[0]
    tp, jp = both3(np.zeros((n, 3), np.float32))
    t = TWL.sample_li_static(ts, j, tp, torch.from_numpy(u0),
                             torch.from_numpy(u1))
    jj = JWL.sample_li_static(js, j, jp, jnp.asarray(u0), jnp.asarray(u1))
    np.testing.assert_allclose(np3(t[3]), np3(jj[3]), rtol=1e-6, atol=1e-7)
    tris = ts.triangles
    s = slice(start, start + count)
    c = np.cross(tris.v1[s] - tris.v0[s], tris.v2[s] - tris.v0[s])
    areas = 0.5 * np.sqrt((c * c).sum(-1)).astype(np.float32)
    np.testing.assert_array_equal(
        cdf, (np.cumsum(areas) / max(areas.sum(), 1e-20)).astype(np.float32))


def test_area_light_radiance_matches_jax(scenes):
    js, ts = scenes["cornell"]
    rng = np.random.default_rng(8)
    o = _p_ref(rng, -0.9, 0.9)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[: N // 2, 1] = np.abs(d[: N // 2, 1]) + 1.0   # half of them upward
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    to, jo = both3(o)
    td, jd = both3(d)
    inf = np.full(N, np.inf, np.float32)
    th = TWF.closest_hit(ts, to, td, torch.from_numpy(inf), torch.zeros(N))
    jh = JWF.closest_hit(js, jo, jd, jnp.asarray(inf), jnp.zeros(N))
    np.testing.assert_array_equal(th.valid.numpy(), np.asarray(jh.valid))
    np.testing.assert_array_equal(th.prim_id.numpy(), np.asarray(jh.prim_id))
    te = TWL.area_light_radiance(ts, th, th.wo)
    je = JWL.area_light_radiance(js, jh, jh.wo)
    _close(te, je, "emission")
    assert 10 < int((te.x > 0).sum()) < N // 2
    # A scene without area lights emits nothing.
    dt, dj = scenes["delta"]
    z = TWL.area_light_radiance(dj, th, th.wo)
    assert not bool((z.x != 0).any())


def test_environment_light_builds():
    from trace_tpu_torch.core import transform as TT
    from trace_tpu_torch.materials.materials import MatteMaterial
    from trace_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    m = b.material(MatteMaterial())
    b.sphere(TT.translate([0.0, 0.0, 0.0]), 1.0, m)
    b.light(TL.infinite_light())
    scene = b.build(device="cpu")
    assert TL.has_env(scene.lights) and scene.env.k == 2
    assert float(scene.lights.world_radius) > 0


def test_instancing_raises():
    """Instancing is ported (tests/test_torch_instances*.py); an instance
    list with no transform still raises, as the JAX package's
    build_instances does (ValueError: nothing to stack)."""
    from trace_tpu_torch.core import transform as TT
    from trace_tpu_torch.materials.materials import MatteMaterial
    from trace_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    m = b.material(MatteMaterial())
    verts = np.eye(3, dtype=np.float32)
    with pytest.raises(ValueError):
        b.instanced_mesh(np.array([[0, 1, 2]], np.uint32), verts, [], m)
    b.instanced_mesh(np.array([[0, 1, 2]], np.uint32), verts,
                     [TT.identity()], m)
    scene = b.build(device="cpu")
    assert len(scene.instanced) == 1 and scene.n_triangles == 0
