"""The device cluster build (accel/morton.py), the sweep tables packed on
the device, the frame transform and the sweep's refit, against the JAX
package (trace_tpu.accel.morton, trace_tpu.shapes.triangle,
trace_tpu.ops.sweep_pallas).

Tolerances:
- Morton codes, cluster order (tri_id, with ties on a heightfield), boxes:
  bit-equal, jitted or not.
- The clusters' Moller-Trumbore constants: bit-equal to the JAX build run
  op by op (``jax.disable_jit``). Under ``jax.jit`` XLA's CPU compiler
  contracts jnp.cross's ``a*b - c*d`` into fused multiply-adds, so the
  jitted n, w, q and v0.n part from the port's (which rounds every
  product) in the last bits of the products: up to 1024-8801 ulps of the
  result where the difference cancels (measured on the soups), and
  within 2^-22 of the summed magnitudes of the products (``_fma_scale``)
  everywhere. e1 and e2 (plain differences) stay bit-equal.
- The frame transform: bit-equal to JAX op by op (a mirror flips
  flip_normal); jitted, XLA's CPU compiler chains each row into fused
  multiply-adds, and the vertices part in the last bit (within 2^-22 of
  the summed magnitudes of the terms).
- Device-packed sweep tables against the host packing of the same
  clusters, and the refit against JAX's PallasSweepAccelerator.refit
  (numpy only, no kernel): bit-equal.
- ``cuda`` (skipped without a GPU): the device build and packing on the
  card against the CPU's, bit-equal; an animated frame on the card runs
  the sweep and prologue kernels on its device-built tables and matches
  the CPU's frame (atol 2e-3).

JAX is imported inside the ``jx`` fixture, so the ``cuda`` test also runs
where JAX is not installed (``pytest --noconftest -m cuda``).
"""
import types

import numpy as np
import pytest
import torch

from trace_tpu_torch import convert as C
from trace_tpu_torch.accel import clusters as TC
from trace_tpu_torch.accel import morton as TM
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.shapes import triangle as TTri

LEAF = 64


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from trace_tpu.accel import clusters as JC
    from trace_tpu.accel import morton as JM
    from trace_tpu.core import transform as JT
    from trace_tpu.integrators import common as JCm
    from trace_tpu.ops import sweep_pallas as JS
    from trace_tpu.shapes import triangle as JTri

    return types.SimpleNamespace(jax=jax, jnp=jnp, JC=JC, JM=JM, JT=JT,
                                 JCm=JCm, JS=JS, JTri=JTri)


def _soup(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    verts = np.concatenate([c, c + e1, c + e2], 0)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n],
                   -1)
    return idx, verts


def _heightfield(k=20):
    """A heightfield and one far-off triangle: the far triangle stretches
    the centroid box, so most of the field's centroids share a Morton
    code."""
    xs, zs = np.meshgrid(np.arange(k, dtype=np.float32),
                         np.arange(k, dtype=np.float32))
    y = (0.3 * np.sin(xs) * np.cos(zs)).astype(np.float32)
    verts = np.stack([xs, y, zs], -1).reshape(-1, 3)
    a = (np.arange(k - 1)[:, None] * k + np.arange(k - 1)[None, :]).ravel()
    idx = np.concatenate([np.stack([a, a + 1, a + k], -1),
                          np.stack([a + 1, a + k + 1, a + k], -1)])
    far = np.array([[4000, 4000, 4000], [4001, 4000, 4000],
                    [4000, 4001, 4001]], np.float32)
    idx = np.concatenate([idx, [[k * k, k * k + 1, k * k + 2]]])
    return idx, np.concatenate([verts, far])


def _flat(n=200, seed=5):
    """A soup in the plane y = 0.5: the centroid box has extent 0 in y."""
    idx, verts = _soup(n, seed)
    verts[:, 1] = 0.5
    return idx, verts


MESHES = {"soup": lambda: _soup(300, 1), "soup5k": lambda: _soup(5000, 2),
          "heightfield": _heightfield, "flat": _flat}


def _mesh(jx, which, xf=None):
    """(JAX Triangles, port Triangles) of one mesh under ``xf`` (port
    Transform; identity by default)."""
    idx, verts = MESHES[which]()
    xf = xf or TT.identity()
    jxf = jx.JT.Transform(jx.jnp.asarray(xf.m), jx.jnp.asarray(xf.inv_m))
    normals = np.tile(np.array([[0.0, 0.6, 0.8]], np.float32),
                      (verts.shape[0], 1))
    jt = jx.JTri.pack_triangle_mesh(jxf, idx, verts, normals=normals)
    tt = TTri.pack_triangle_mesh(xf, idx, verts, normals=normals)
    return jt, tt


def _jax_build(jx, jt, jit: bool):
    v = [jx.jnp.asarray(getattr(jt, f)) for f in ("v0", "v1", "v2")]
    if jit:
        out = jx.JM._build(*v, LEAF)
    else:
        with jx.jax.disable_jit():
            out = jx.JM._build(*v, LEAF)
    lo, hi, _, mt, tid = (np.asarray(x) for x in out)
    return dict(c_lo=lo, c_hi=hi, packed_mt=mt, tri_id=tid)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("which", sorted(MESHES))
def test_morton_codes_match_jax(jx, which):
    jt, tt = _mesh(jx, which)
    cent = (tt.v0 + tt.v1 + tt.v2) / np.float32(3.0)
    lo = cent.min(0)
    inv = (1.0 / np.maximum(cent.max(0) - lo, np.float32(1e-12))).astype(
        np.float32)
    j = np.asarray(jx.JM.morton_codes(*(jx.jnp.asarray(x)
                                        for x in (cent, lo, inv))))
    t = TM.morton_codes(*(torch.from_numpy(x) for x in (cent, lo, inv)))
    np.testing.assert_array_equal(j.astype(np.int64), t.numpy())
    if which == "heightfield":
        assert t.numel() - torch.unique(t).numel() > 300   # ties


@pytest.mark.parametrize("which", sorted(MESHES))
def test_device_build_matches_jax_op_by_op(jx, which):
    jt, tt = _mesh(jx, which)
    ta = TM.build_clusters_device(TTri.to_device(tt, "cpu"), LEAF)
    ja = _jax_build(jx, jt, jit=False)
    assert ta.leaf_tris == LEAF
    for f, a in ja.items():
        b = getattr(ta, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
    # Padding slots carry zero constants (det = 0: never hit).
    pad = ta.tri_id[:, :LEAF] < 0
    mt = ta.packed_mt[:, :16 * LEAF].reshape(-1, 16, LEAF)
    assert bool((mt.transpose(1, 2)[pad] == 0).all())


def _fma_scale(b0, b1, b2):
    """Per constant, the summed magnitudes of the products it is made of
    ([C, 16L]): |a_i b_j| + |a_j b_i| for each cross-product component,
    sum_j |v0_j| (|n_j| + scale(n_j)) for v0.n; 0 for e1 and e2."""
    def cross_scale(a, b):
        a0, a1, a2 = np.abs(a).transpose(2, 0, 1)
        c0, c1, c2 = np.abs(b).transpose(2, 0, 1)
        return np.stack([a1 * c2 + a2 * c1, a2 * c0 + a0 * c2,
                         a0 * c1 + a1 * c0], -1)
    e1, e2 = b1 - b0, b2 - b0
    n = np.cross(e1, e2)
    sn = cross_scale(e1, e2)
    v0n = (np.abs(b0) * (np.abs(n) + sn)).sum(-1)
    flat = lambda x: x.transpose(0, 2, 1).reshape(x.shape[0], -1)
    z = np.zeros_like(flat(e1))
    return np.concatenate([flat(sn), z, z, flat(cross_scale(e2, b0)),
                           flat(cross_scale(b0, e1)), v0n], 1)


@pytest.mark.parametrize("which", sorted(MESHES))
def test_device_build_within_bound_of_jitted_jax(jx, which):
    jt, tt = _mesh(jx, which)
    ta = TM.build_clusters_device(TTri.to_device(tt, "cpu"), LEAF)
    ja = _jax_build(jx, jt, jit=True)
    for f in ("c_lo", "c_hi", "tri_id"):
        np.testing.assert_array_equal(ja[f], getattr(ta, f).numpy(),
                                      err_msg=f)
    tid = ta.tri_id[:, :LEAF].numpy()
    blocks = [np.where((tid >= 0)[..., None], v[np.maximum(tid, 0)], 0.0)
              .astype(np.float64) for v in (tt.v0, tt.v1, tt.v2)]
    scale = _fma_scale(*blocks)
    a = ja["packed_mt"][:, :16 * LEAF].astype(np.float64)
    b = ta.packed_mt[:, :16 * LEAF].numpy().astype(np.float64)
    l3 = 3 * LEAF
    np.testing.assert_array_equal(a[:, l3:3 * l3], b[:, l3:3 * l3])  # e1, e2
    assert np.all(np.abs(a - b) <= 2.0 ** -22 * scale)


@pytest.mark.parametrize("kind", ["f32", "bf16", "hilo"])
def test_device_tables_equal_host_packing(jx, kind):
    _, tt = _mesh(jx, "soup5k")
    ta = TM.build_clusters_device(TTri.to_device(tt, "cpu"), LEAF)
    host = TC.to_host(ta)
    opt = dict(panel_bf16=kind == "bf16", panel_hilo=kind == "hilo")
    dt = TS.SweepTables(ta, 8, **opt)
    ht = TS.SweepTables(host, 8, **opt)
    assert torch.is_tensor(dt.panel) and isinstance(ht.panel, np.ndarray)
    assert (dt.n_supers, dt.gl_pad, dt.panel_bf16, dt.panel_hilo) == (
        ht.n_supers, ht.gl_pad, ht.panel_bf16, ht.panel_hilo)
    assert dt.n_supers * 8 > ta.tri_id.shape[0]   # a padded last super
    bits = (dt.panel.view(torch.int16).numpy().view(np.uint16)
            if kind != "f32" else dt.panel.numpy())
    np.testing.assert_array_equal(bits, ht.panel)
    for f in ("slot_to_tri", "s_lo", "s_hi"):
        np.testing.assert_array_equal(getattr(dt, f).numpy(),
                                      getattr(ht, f), err_msg=f)
    da, ha = (TS.SweepAccelerator(t, "cpu") for t in (dt, ht))
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi", "world_lo",
              "world_inv_extent"):
        assert torch.equal(getattr(da, f), getattr(ha, f)), f


def test_sweep_world_box_matches_jax(jx):
    # The ray sort's world box, now reduced with tensor ops on the device,
    # against the JAX accelerator's host reduction.
    jt, tt = _mesh(jx, "soup5k")
    jacc = jx.JS.PallasSweepAccelerator(jx.JC.build_clusters(jt, LEAF, 4),
                                        group=8)
    acc = TS.SweepAccelerator(TS.SweepTables(TC.build_clusters(tt, LEAF, 4),
                                             8), "cpu")
    np.testing.assert_array_equal(jacc._world_lo, acc.world_lo.numpy())
    np.testing.assert_array_equal(jacc._world_inv_extent,
                                  acc.world_inv_extent.numpy())


MOTIONS = {
    "rigid": lambda T: T.compose(T.translate([0.15, -0.1, 0.3]),
                                 T.rotate_y(20.0)),
    "mirror": lambda T: T.compose(T.translate([0.2, 0.0, 0.0]),
                                  T.scale(-1.0, 1.0, 1.0)),
}


@pytest.mark.parametrize("motion", sorted(MOTIONS))
def test_transform_triangles_matches_jax(jx, motion):
    jt, tt = _mesh(jx, "soup")
    jxf = MOTIONS[motion](jx.JT)
    xf = C.transform_from_jax(jxf)
    port = TTri.transform_triangles(TTri.to_device(tt, "cpu"), xf)
    jdev = jx.jax.tree.map(jx.jnp.asarray, jt)
    with jx.jax.disable_jit():
        eager = jx.JTri.transform_triangles(jdev, jxf)
    for f in TTri.Triangles._fields:
        a, b = np.asarray(getattr(eager, f)), getattr(port, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # Jitted, XLA's CPU compiler chains the row's products into fused
    # multiply-adds: within 2^-22 of the summed magnitudes of the terms.
    jitted, _ = jx.JCm._transform_and_build(jdev, jxf, LEAF)
    m = np.abs(np.asarray(xf.m, np.float64))
    for f in ("v0", "v1", "v2"):
        v = np.abs(getattr(tt, f).astype(np.float64))
        scale = v @ m[:3, :3].T + m[:3, 3]
        diff = np.abs(np.asarray(getattr(jitted, f), np.float64)
                      - getattr(port, f).numpy())
        assert np.all(diff <= 2.0 ** -22 * scale), f
    for f in ("n0", "flip_normal", "material_id"):
        np.testing.assert_array_equal(np.asarray(getattr(jitted, f)),
                                      getattr(port, f).numpy(), err_msg=f)
    flipped = bool(np.linalg.det(np.asarray(xf.m)[:3, :3]) < 0)
    np.testing.assert_array_equal(port.flip_normal.numpy(),
                                  tt.flip_normal ^ flipped)
    assert flipped == (motion == "mirror")


def test_convert_carries_triangles_and_transform(jx):
    jt, tt = _mesh(jx, "soup")
    back = C.triangles_from_jax(jx.jax.tree.map(jx.jnp.asarray, jt))
    for f in TTri.Triangles._fields:
        np.testing.assert_array_equal(getattr(back, f), getattr(tt, f))
    jxf = jx.JT.compose(jx.JT.translate([1.0, 2.0, 3.0]), jx.JT.rotate_x(30.0))
    xf = C.transform_from_jax(jxf)
    assert xf.m.dtype == np.float32
    np.testing.assert_array_equal(xf.m, np.asarray(jxf.m))
    np.testing.assert_array_equal(xf.inv_m, np.asarray(jxf.inv_m))
    for deg in (2.0, 20.0, -135.0):
        t, j = TT.rotate_y(deg), jx.JT.rotate_y(deg)
        np.testing.assert_array_equal(t.m, np.asarray(j.m))
        np.testing.assert_array_equal(t.inv_m, np.asarray(j.inv_m))


def _moved(tt):
    xf = TT.compose(TT.translate([0.1, -0.05, 0.2]),
                    TT.from_matrix(np.diag([1.0, 1.1, 0.9, 1.0])))
    return TTri.to_numpy(TTri.transform_triangles(TTri.to_device(tt, "cpu"),
                                                  xf))


@pytest.mark.parametrize("which", ["soup5k", "heightfield"])
def test_refit_matches_jax(jx, which):
    jt, tt = _mesh(jx, which)
    mv = _moved(tt)
    jacc = jx.JS.PallasSweepAccelerator(jx.JC.build_clusters(jt, LEAF, 4),
                                        group=8)
    jacc.refit(mv.v0, mv.v1, mv.v2)
    acc = TS.SweepAccelerator(TS.SweepTables(TC.build_clusters(tt, LEAF, 4),
                                             8), "cpu")
    acc.refit(torch.from_numpy(mv.v0), mv.v1, mv.v2)
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        np.testing.assert_array_equal(np.asarray(getattr(jacc.tables, f)),
                                      getattr(acc.tables, f), err_msg=f)
    np.testing.assert_array_equal(jacc._world_lo, acc.world_lo.numpy())
    np.testing.assert_array_equal(jacc._world_inv_extent,
                                  acc.world_inv_extent.numpy())


def test_refit_equals_a_static_build_of_the_same_clusters(jx):
    # A refit to the build's own vertices gives the static tables back, bit
    # for bit; on device-built (Morton) tables too, whose refit runs
    # through the host's double-precision constants.
    _, tt = _mesh(jx, "soup5k")
    static = TS.SweepTables(TC.build_clusters(tt, LEAF, 4), 8)
    acc = TS.SweepAccelerator(static, "cpu")
    acc.refit(_moved(tt).v0, _moved(tt).v1, _moved(tt).v2)
    acc.refit(tt.v0, tt.v1, tt.v2)
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        np.testing.assert_array_equal(getattr(static, f),
                                      getattr(acc.tables, f), err_msg=f)
    dev = TTri.to_device(tt, "cpu")
    ma = TM.build_clusters_device(dev, LEAF)
    macc = TS.SweepAccelerator(TS.SweepTables(ma, 8), "cpu")
    macc.refit(dev.v0, dev.v1, dev.v2)
    host = TC.to_host(ma)
    packed = TC.refit_clusters(host, tt.v0, tt.v1, tt.v2)
    ref = TS.SweepTables(packed, 8)
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        np.testing.assert_array_equal(getattr(ref, f),
                                      getattr(macc.tables, f), err_msg=f)
    # Boxes are exact; the f64 constants differ from the device build's
    # f32 ones by rounding only.
    np.testing.assert_array_equal(macc.tables.s_lo,
                                  TS.SweepTables(ma, 8).s_lo.numpy())
    with pytest.raises(ValueError, match="group"):
        TS.SweepAccelerator(TS.SweepTables.from_arrays(
            static.panel, static.slot_to_tri, static.s_lo, static.s_hi),
            "cpu").refit(tt.v0, tt.v1, tt.v2)


@pytest.mark.cuda
def test_cuda_device_build_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, verts = _soup(20_000, 7)
    tt = TTri.pack_triangle_mesh(TT.identity(), idx, verts)
    xf = TT.compose(TT.translate([0.1, 0.2, 0.3]), TT.scale(1.0, -1.0, 1.0))
    out = {}
    for dev in ("cpu", "cuda"):
        tris = TTri.transform_triangles(TTri.to_device(tt, dev), xf)
        acc = TM.build_clusters_device(tris, LEAF)
        tb = TS.SweepTables(acc, 8)
        out[dev] = [x.cpu() for x in (*tris, acc.c_lo, acc.c_hi,
                                      acc.packed_mt, acc.tri_id, tb.panel,
                                      tb.slot_to_tri, tb.s_lo, tb.s_hi)]
    for i, (a, b) in enumerate(zip(out["cpu"], out["cuda"])):
        assert torch.equal(a, b), i


@pytest.mark.cuda
def test_cuda_animated_frame_runs_the_kernels():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from trace_tpu_torch.integrators.whitted import WhittedIntegrator
    from trace_tpu_torch.models import mesh_heavy
    from trace_tpu_torch.sampler.uniform import UniformSampler

    xf = TT.compose(TT.translate([0.0, 0.05, 0.0]), TT.rotate_y(2.0))
    imgs = {}
    for dev in ("cpu", "cuda"):
        scene = mesh_heavy.build_scene(5000, device=dev)
        integ = WhittedIntegrator(mesh_heavy.build_camera(32, "unused.png"),
                                  UniformSampler(1, seed=0), max_depth=2)
        TS.sweep_kernel.reset_counts()
        TS.block_entry_kernel.reset_counts()
        imgs[dev] = integ.camera.film.to_image(integ.render(
            scene, geometry=scene.triangles, geometry_transform=xf)).cpu()
        launched = TS.sweep_kernel.launches
        assert (launched > 0) == (dev == "cuda")
        assert TS.block_entry_kernel.launches == launched
    np.testing.assert_allclose(imgs["cuda"].numpy(), imgs["cpu"].numpy(),
                               atol=2e-3)
