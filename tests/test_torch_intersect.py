"""The port's fused brute-force intersection against the JAX package
(trace_tpu.ops.intersect_pallas).

- Packing: the port's compact triangle panel holds exactly the constants
  of the JAX package's B (bit-equal, both computed in f64 and rounded
  once), read directly or through ``tris_from_b``; the ray rows hold A's
  o and d bit for bit and o x d to 1 ulp.
- ``intersect_plain`` against ``intersect_fused(interpret=True)`` on a
  300-triangle soup, as tests/test_accel_equivalence.py holds the JAX
  kernel against brute force: hits equal, t within rtol 1e-4 + atol 1e-3,
  ids equal where hit.
- A Whitted render through ``intersect.attach`` against the sweep path's
  render of the same scene: the two intersectors share the arithmetic
  and differ only in which of several equal-t triangles wins, so the
  images agree to MSE 1e-8.
- The CUDA kernel against the plain version on the card (``cuda`` marker,
  skipped without a GPU): bit-equal.

JAX is imported inside the ``jx`` fixture, so the ``cuda`` test also runs
where JAX is not installed (``pytest --noconftest -m cuda``).
"""
import types

import numpy as np
import pytest
import torch

from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.models import mesh_heavy as TM
from trace_tpu_torch.ops import intersect as TI
from trace_tpu_torch.sampler import uniform as TU


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from trace_tpu.ops import intersect_pallas as JI

    return types.SimpleNamespace(jax=jax, jnp=jnp, JI=JI)


def _soup(nt, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (nt, 3)).astype(np.float32)
    v1 = c + rng.normal(0, 0.8, (nt, 3)).astype(np.float32)
    v2 = c + rng.normal(0, 0.8, (nt, 3)).astype(np.float32)
    return c, v1, v2


def _rays(nr, seed):
    """Rays from [-8, 8]^3 aimed at points of the soup's [-4, 4]^3 core."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (nr, 3)).astype(np.float32)
    d = rng.uniform(-4, 4, (nr, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("nt", [300, 256])
def test_pack_tris_holds_the_jax_b_constants(jx, nt):
    v0, v1, v2 = _soup(nt, seed=nt)
    b = jx.JI.pack_tris(v0, v1, v2)
    panel, ids = TI.pack_tris(v0, v1, v2)
    nb = -(-nt // TI.TRI_BLOCK)
    assert panel.shape == (nb, 16, TI.TRI_BLOCK) and ids.shape == (nb * 128,)
    g = b.reshape(16, nb, TI.GROUPS, TI.TRI_BLOCK).transpose(1, 0, 2, 3)
    np.testing.assert_array_equal(panel[:, 0:3], g[:, 0:3, 3])     # n
    np.testing.assert_array_equal(panel[:, 0:3], -g[:, 3:6, 0])    # -n
    np.testing.assert_array_equal(panel[:, 3:6], -g[:, 6:9, 2])    # e1
    np.testing.assert_array_equal(panel[:, 6:9], g[:, 6:9, 1])     # e2
    np.testing.assert_array_equal(panel[:, 9:12], -g[:, 3:6, 1])   # w
    np.testing.assert_array_equal(panel[:, 12:15], -g[:, 3:6, 2])  # q
    np.testing.assert_array_equal(panel[:, 15], -g[:, 9, 3])       # v0.n
    np.testing.assert_array_equal(ids, g[:, 9, 4].reshape(-1))
    assert (ids[nt:] == -1).all() and (ids[:nt] == np.arange(nt)).all()
    got = TI.tris_from_b(b)
    np.testing.assert_array_equal(got[0], panel)
    np.testing.assert_array_equal(got[1], ids)


def test_pack_rays_holds_the_jax_a_rows(jx):
    o, d = _rays(300, seed=1)
    t_max = np.linspace(0.5, 9.0, 300).astype(np.float32)
    a, tcol, pad = jx.JI.pack_rays(jx.jnp.asarray(o), jx.jnp.asarray(d),
                                   jx.jnp.asarray(t_max))
    a, tcol = np.asarray(a), np.asarray(tcol)
    rays, tpad = TI.pack_rays(torch.from_numpy(o), torch.from_numpy(d),
                              torch.from_numpy(t_max))
    rays = rays.numpy()
    assert rays.shape == (10, 384) and tpad == 84
    np.testing.assert_array_equal(rays[:6, :300], a[:300, :6].T)
    # o x d: the JAX side computes it under jit, where XLA may contract.
    np.testing.assert_allclose(rays[6:9, :300], a[:300, 6:9].T, rtol=2e-7,
                               atol=1e-6)
    np.testing.assert_array_equal(rays[9, :300], tcol[:300, 0])
    assert (rays[:, 300:] == 0).all()       # padding lanes never hit


@pytest.mark.parametrize("t_max", [np.inf, 4.0], ids=["inf", "4"])
def test_plain_matches_jax_fused_interpret_kernel(jx, t_max):
    v0, v1, v2 = _soup(300, seed=7)
    o, d = _rays(256, seed=8)
    tm = np.full(256, t_max, np.float32)
    jacc = jx.JI.PallasMXUAccelerator(
        types.SimpleNamespace(v0=v0, v1=v1, v2=v2), interpret=True)
    jh, jt, ji = (np.asarray(x) for x in jacc.traverse(
        jx.jnp.asarray(o), jx.jnp.asarray(d), jx.jnp.asarray(tm)))
    panel, ids = TI.pack_tris(v0, v1, v2)
    acc = TI.IntersectAccelerator(panel, ids, "cpu")
    launches = TI.intersect_kernel.launches
    th, tt, ti = (x.numpy() for x in acc.intersect(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm),
        False))
    assert TI.intersect_kernel.launches == launches  # CPU: the plain version
    assert th.sum() > (100 if np.isinf(t_max) else 30)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_allclose(tt[th], jt[th], atol=1e-3, rtol=1e-4)
    np.testing.assert_array_equal(ti[th], ji[th])
    assert np.isinf(tt[~th]).all()


def _kernel_filter(rays, panel):
    """csrc/intersect.cu::passes in numpy float32 (every operation one
    rounding, as the kernel's --fmad=false build): rays [10, N], panel
    [NT, 16, 128] -> bool [N, NT*128]."""
    f, u32 = np.float32, np.uint32
    p = panel.transpose(1, 0, 2).reshape(16, -1)[:, None, :]
    o0, o1, o2, d0, d1, d2, m0, m1, m2 = (rays[i][None].T for i in range(9))

    def dot(a0, a1, a2, r):
        return (a0 * p[r] + a1 * p[r + 1]) + a2 * p[r + 2]

    dd = dot(d0, d1, d2, 0)
    u_det = dot(m0, m1, m2, 6) - dot(d0, d1, d2, 9)
    v_sum = dot(m0, m1, m2, 3) + dot(d0, d1, d2, 12)
    t_det = dot(o0, o1, o2, 0) - p[15]
    neg = ~dd.view(u32) & u32(0x80000000)
    u = (u_det.view(u32) ^ neg).view(f)
    v = (v_sum.view(u32) ^ neg ^ u32(0x80000000)).view(f)
    tn = (t_det.view(u32) ^ neg).view(f)
    adet = np.abs(dd)
    return ((adet > f(1e-12)) & (u >= 0) & (v >= 0) & (u + v <= adet)
            & (tn > 0))


def test_kernel_filter_passes_exactly_the_epilogue_ok():
    # The kernel tests each pair branch-free with sign-bit flips and only
    # then divides; its filter must pass exactly the pairs that
    # mt_epilogue's ok (before t < t_max and the id) passes. Rays through
    # vertices and along edges give u, v = +-0; rays in a triangle's plane
    # give det = 0; a zero triangle (padding) gives det = +-0.
    with np.errstate(all="ignore"):
        v0, v1, v2 = _soup(250, seed=17)
        v1[:10], v2[:10] = v0[:10] + [1, 0, 0], v0[:10] + [0, 0, 1]  # flat
        o, d = _rays(300, seed=18)
        o[:40] = v0[:40] + [0.0, 3.0, 0.0]                 # at vertices
        d[:40] = [0.0, -1.0, 0.0]
        e = (v1[40:80] + v2[40:80]) * np.float32(0.5)       # at edges
        o[40:80] = e + [0.0, 2.0, 0.0]
        d[40:80] = (e - o[40:80]) / np.linalg.norm(e - o[40:80], axis=1,
                                                   keepdims=True)
        o[80:90] = v0[:10] + [-2.0, 0.0, 0.0]               # in the plane
        d[80:90] = [1.0, 0.0, 0.0]
        panel, _ = TI.pack_tris(v0, v1, v2)
        rays, _ = TI.pack_rays(torch.from_numpy(o), torch.from_numpy(d),
                               torch.full((300,), np.inf))
        got = _kernel_filter(rays.numpy(), panel)
        r = rays[:, :, None]
        pt = torch.from_numpy(panel).permute(1, 0, 2).reshape(16, -1)[:, None]
        dot = TI._dot3
        ok, _ = TI.mt_epilogue(
            -dot(r[3], r[4], r[5], pt[:, 0], 0),
            dot(r[6], r[7], r[8], pt[:, 0], 6)
            - dot(r[3], r[4], r[5], pt[:, 0], 9),
            -dot(r[6], r[7], r[8], pt[:, 0], 3)
            - dot(r[3], r[4], r[5], pt[:, 0], 12),
            dot(r[0], r[1], r[2], pt[:, 0], 0) - pt[15, 0])
    np.testing.assert_array_equal(got, ok.numpy())
    assert 100 < got.sum() < got.size // 10


def test_ties_go_to_the_lowest_id_and_misses_are_minus_one():
    # Triangles 5, 9 (same block) and 200 (a later block) are one
    # triangle, far from the rest of the soup. The ray that hits it must
    # report id 5; a ray that hits nothing reports -1 and t = inf.
    v0, v1, v2 = _soup(300, seed=3)
    for j in (5, 9, 200):
        v0[j], v1[j], v2[j] = [49, 49, 100], [52, 49, 100], [49, 52, 100]
    o = np.float32([[50, 50, 200], [0, 500, 0]])
    d = np.float32([[0, 0, -1], [0, 1, 0]])
    panel, ids = TI.pack_tris(v0, v1, v2)
    rays, _ = TI.pack_rays(torch.from_numpy(o), torch.from_numpy(d),
                           torch.full((2,), float("inf")))
    for chunk in (1, 8):
        bt, bi = TI.intersect_plain(rays, torch.from_numpy(panel),
                                    torch.from_numpy(ids), tri_chunk=chunk)
        assert bi[:2].tolist() == [5, -1]
        assert bt[0].item() == 100.0 and torch.isinf(bt[1])


def test_render_through_fused_accelerator_matches_sweep_render():
    scene = TM.build_scene(2000, device="cpu")
    imgs = []
    for fused in (False, True):
        if fused:
            TI.attach(scene)
            assert isinstance(scene.accel, TI.IntersectAccelerator)
        cam = TM.build_camera(24, "unused.png")
        integ = WhittedIntegrator(cam, TU.UniformSampler(1, seed=0),
                                  max_depth=2)
        imgs.append(cam.film.to_image(integ.render(scene)).numpy())
        assert integ.last_queue_drops == 0
    assert (imgs[0] > 0).any(-1).mean() > 0.2
    assert float(np.mean((imgs[0] - imgs[1]) ** 2)) < 1e-8


def test_kernel_wrapper_refuses_cpu_tensors():
    rays = torch.zeros(10, 128)
    tris = torch.zeros(1, 16, 128)
    ids = torch.full((128,), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        TI.intersect_kernel(rays, tris, ids)
    t, i = TI.intersect(rays, tris, ids)  # the plain version
    assert (i == -1).all() and torch.isinf(t).all()


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    scene = TM.build_scene(5000, device="cpu")
    tr = scene.triangles
    panel, ids = TI.pack_tris(tr.v0, tr.v1, tr.v2)
    tp, ip = torch.from_numpy(panel).to(dev), torch.from_numpy(ids).to(dev)
    rng = np.random.default_rng(43)
    o = torch.from_numpy(rng.uniform(-12, 12, (3000, 3)).astype(np.float32))
    o[:, 1] = 6.0
    d = torch.from_numpy(rng.normal(0, 1, (3000, 3)).astype(np.float32))
    d[:, 1] = -d[:, 1].abs()
    d = d / d.norm(dim=1, keepdim=True)
    for tm in (float("inf"), 8.0):
        rays, _ = TI.pack_rays(o.to(dev), d.to(dev),
                               torch.full((3000,), tm, device=dev))
        kt, ki = TI.intersect_kernel(rays, tp, ip)
        pt, pi = TI.intersect_plain(rays, tp, ip)
        torch.cuda.synchronize()
        assert (ki >= 0).sum() > 100
        assert torch.equal(ki, pi)
        assert torch.equal(kt, pt)
