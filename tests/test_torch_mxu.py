"""The all-pairs matmul accelerator (accel/mxu.py: TriMatmulConsts,
build_consts, intersect_grid, MXUAccelerator, attach), convert.py's
carry of JAX's constants, and accel/morton.py::attach, against the JAX
package (trace_tpu.accel.mxu, trace_tpu.accel.morton).

Tolerances: the constants bit-equal (both round one f64 computation to
f32); hit masks and ids equal, where no two triangles tie; t within 1e-6
relative (the six products are torch's and XLA's CPU matmuls, which may
associate a 3-term dot differently); morton.attach's cluster boxes and
order bit-equal to the JAX build run op by op, and its hits through both
packages' cluster traversals equal with t within 1e-6 relative.
"""
import types

import numpy as np
import pytest
import torch

from torch_jax_arrays import port_scene
from trace_tpu_torch import convert as C
from trace_tpu_torch.accel import clusters as TC
from trace_tpu_torch.accel import morton as TMo
from trace_tpu_torch.accel import mxu as TX
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.models import mesh_heavy as TMH
from trace_tpu_torch.sampler.uniform import UniformSampler

T_RTOL = 1e-6
GOLDEN = "tests/goldens/mesh_heavy5k_32.npy"


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from trace_tpu.accel import morton as JMo
    from trace_tpu.accel import mxu as JX
    from trace_tpu.core import transform as JT
    from trace_tpu.materials.materials import MatteMaterial
    from trace_tpu.lights.lights import point_light
    from trace_tpu.scene import SceneBuilder

    return types.SimpleNamespace(jax=jax, jnp=jnp, JX=JX, JMo=JMo, JT=JT,
                                 Matte=MatteMaterial, point=point_light,
                                 Builder=SceneBuilder)


def _soup(n=300, seed=4):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    verts = np.concatenate([c, c + e1, c + e2], 0)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n],
                   -1)
    return idx, verts


def _rays(n=2048, seed=9):
    """Rays from a shell around the soup towards points inside it; a
    quarter with a finite t_max."""
    rng = np.random.default_rng(seed)
    o = rng.normal(0, 1, (n, 3)).astype(np.float32)
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 9.0).astype(
        np.float32)
    target = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_max = np.where(rng.uniform(size=n) < 0.25,
                     rng.uniform(5.0, 12.0, n), np.inf).astype(np.float32)
    return o, d, t_max


@pytest.fixture(scope="module")
def scenes(jx):
    """The soup and one sphere, in both packages (the port's carried
    across from JAX's arrays)."""
    b = jx.Builder()
    m = b.material(jx.Matte(Kd=(0.5, 0.5, 0.5)))
    idx, verts = _soup()
    b.triangle_mesh(jx.JT.identity(), idx, verts, m)
    b.sphere(jx.JT.translate([0.5, 0.2, -0.3]), 0.8, m)
    b.light(jx.point(jx.JT.translate([0.0, 10.0, 0.0]), (10.0, 10.0, 10.0)))
    js = b.build(use_bvh=False)
    return js, port_scene(js)


def test_build_consts_and_convert_match_jax(jx, scenes):
    js, ts = scenes
    jc = jx.JX.build_consts(js.triangles)
    tc = TX.build_consts(ts.triangles)
    carried = C.tri_matmul_consts(jc)
    assert TX.TriMatmulConsts._fields == tuple(
        f for f in ("n", "e1", "e2", "w", "q", "v0n", "degenerate"))
    for f in TX.TriMatmulConsts._fields:
        np.testing.assert_array_equal(getattr(tc, f), np.asarray(
            getattr(jc, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(carried, f), getattr(tc, f))
    assert tc.n.shape == (3, 300) and tc.n.dtype == np.float32


def _agree(jh, jt, th, tt):
    """Hit masks equal and t within T_RTOL where both hit."""
    jh, jt = np.asarray(jh), np.asarray(jt)
    th, tt = th.numpy(), tt.numpy()
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_allclose(tt[th], jt[jh], rtol=T_RTOL)
    return int(th.sum())


def test_intersect_grid_matches_jax(jx, scenes):
    js, ts = scenes
    o, d, t_max = _rays()
    jc = jx.JX.build_consts(js.triangles)
    tc = TX.consts_to(TX.build_consts(ts.triangles), "cpu")
    jh, jt = jx.JX.intersect_grid(jc, jx.jnp.asarray(o), jx.jnp.asarray(d),
                                  jx.jnp.asarray(t_max))
    th, tt = TX.intersect_grid(tc, torch.from_numpy(o), torch.from_numpy(d),
                               torch.from_numpy(t_max))
    assert th.shape == (2048, 300)
    assert _agree(jh, jt, th, tt) > 1000


@pytest.fixture(scope="module")
def attached(jx, scenes):
    js, ts = scenes
    jx.JX.attach(js, tri_chunk=128)
    v = ts._version
    TX.attach(ts, tri_chunk=128)
    assert ts._version == v + 1
    return js, ts


def test_mxu_accelerator_closest_and_any_hit_match_jax(jx, attached):
    """MXUAccelerator.closest / any_hit (the JAX package's methods) and
    intersect (the port's interface), chunked by 128 triangles."""
    js, ts = attached
    assert isinstance(ts.accel, TX.MXUAccelerator)
    assert ts.accel.n_triangles == 300 and ts.accel.tri_chunk == 128
    o, d, t_max = _rays(seed=11)
    jo, jd, jtm = (jx.jnp.asarray(x) for x in (o, d, t_max))
    to, td, ttm = (torch.from_numpy(x) for x in (o, d, t_max))
    (jhs, jts, jis), (jht, jtt, jit) = js.accel.closest(js, jo, jd, jtm)
    (ths, tts, tis), (tht, ttt, tit) = ts.accel.closest(ts, to, td, ttm)
    for jh, jt, ji, th, tt, ti in ((jhs, jts, jis, ths, tts, tis),
                                   (jht, jtt, jit, tht, ttt, tit)):
        assert _agree(jh, jt, th, tt) > 0
        np.testing.assert_array_equal(ti.numpy()[th.numpy()],
                                      np.asarray(ji)[np.asarray(jh)])
    np.testing.assert_array_equal(
        ts.accel.any_hit(ts, to, td, ttm).numpy(),
        np.asarray(js.accel.any_hit(js, jo, jd, jtm)))
    h, t, i = ts.accel.intersect(to, td, ttm, False)
    assert torch.equal(h, tht) and torch.equal(t, ttt) and torch.equal(i, tit)


def test_mxu_attach_renders_the_5k_golden():
    """Whitted 32^2 on the 5k mesh_heavy through mxu.attach, against the
    JAX package's render (the golden): the MSE gate."""
    scene = TX.attach(TMH.build_scene(5000, device="cpu"))
    cam = TMH.build_camera(32, "unused.png")
    integ = WhittedIntegrator(cam, UniformSampler(1, seed=0), max_depth=2)
    img = cam.film.to_image(integ.render(scene)).numpy()
    golden = np.load(GOLDEN)
    mse = float(np.mean((img - golden) ** 2))
    print(f"5k golden through mxu.attach: MSE {mse:.3e}")
    assert isinstance(scene.accel, TX.MXUAccelerator) and mse < 5e-4


def test_morton_attach_matches_jax(jx, scenes):
    """morton.attach installs a ClusterAccelerator over the device Morton
    build and bumps the version, as JAX's; its clusters equal the JAX
    build op by op (boxes and order bit for bit) and the hits agree."""
    js, ts = scenes
    v = ts._version
    ts = TMo.attach(ts.with_geometry(ts.triangles, None), leaf_tris=64,
                    stage_clusters=2, ray_chunk=512)
    assert ts._version == v + 1
    assert isinstance(ts.accel, TC.ClusterAccelerator)
    assert ts.accel.stage_clusters == 2 and ts.accel.ray_chunk == 512
    with jx.jax.disable_jit():
        jx.JMo.attach(js, leaf_tris=64, stage_clusters=2, ray_chunk=512)
    jc, tc = js.accel.clusters, ts.accel.clusters
    for f in ("c_lo", "c_hi", "tri_id"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    o, d, t_max = _rays(seed=13)
    jo, jd, jtm = (jx.jnp.asarray(x) for x in (o, d, t_max))
    _, (jh, jt, ji) = js.accel.closest(js, jo, jd, jtm)
    th, tt, ti = ts.accel.intersect(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(t_max), False)
    assert _agree(jh, jt, th, tt) > 1000
    np.testing.assert_array_equal(ti.numpy()[th.numpy()],
                                  np.asarray(ji)[np.asarray(jh)])
