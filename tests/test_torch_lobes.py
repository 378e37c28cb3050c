"""The port's lobes (wavefront/shade.py) and material dispatch
(wavefront/materials.py) against the JAX package's planar twins.

Inputs: 4096 lanes of local directions (both hemispheres), uniforms and
lobe parameters drawn by numpy from fixed seeds, fed to both packages.
JAX runs op by op (no jit), so the two compute the same f32 operations
in the same order; they part only where a transcendental rounds
differently: XLA's and torch's f32 sin, cos and log differ in the last
bit on ~5% of inputs. A cancellation can amplify that bit, e.g. a
cosine-hemisphere sample next to the disk's rim, whose z = sqrt(1 - x^2
- y^2) is then rounding noise. Tolerance: rtol 1e-5 with an absolute
floor of 1e-6 on every lane but at most 1 in 1000 (4 of 4096), which
must agree to rtol 1e-2, atol 1e-3; kinds, masks and sampled flags must
be exact. Sampled directions are compared where the sample succeeded
(pdf > 0 in both): a failed sample's direction is unused.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from trace_tpu.bxdf import ggx as JGGX
from trace_tpu.bxdf import lobes as JLB
from trace_tpu.core.vec import V3 as JV3
from trace_tpu.materials import materials as JM
from trace_tpu.wavefront import materials as JWM
from trace_tpu.wavefront import shade as JS
from trace_tpu_torch.core.vec import V3 as TV3
from trace_tpu_torch.materials import materials as TM
from trace_tpu_torch.wavefront import materials as TWM
from trace_tpu_torch.wavefront import shade as TS

N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, msg="", where=None):
    if isinstance(t, TV3):
        t, j = t.arr(), j.arr()
    t, j = t.numpy(), np.asarray(j)
    if where is not None:
        t, j = t[where], j[where]
    off = ~np.isclose(t, j, rtol=RTOL, atol=ATOL)
    if off.ndim > 1:
        off = off.any(-1)
    assert off.sum() <= N // 1000, (msg, int(off.sum()))
    np.testing.assert_allclose(t[off], j[off], rtol=1e-2, atol=1e-3,
                               err_msg=msg)


def _exact(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


def _both3(a):
    a = np.asarray(a, np.float32)
    return (TV3(*[torch.from_numpy(a[:, i].copy()) for i in range(3)]),
            JV3(*[jnp.asarray(a[:, i]) for i in range(3)]))


def _both(a):
    a = np.asarray(a)
    return torch.from_numpy(a.copy()), jnp.asarray(a)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _slot_params(kind: int, seed: int) -> dict:
    """numpy fields of a LobeSlotP for ``kind`` (every lane that kind)."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    p = dict(kind=np.full(N, kind, np.int32),
             c0=f32(rng.uniform(0.1, 1.0, (N, 3))),
             c1=f32(rng.uniform(0.1, 1.0, (N, 3))),
             eta_a=np.ones(N, np.float32),
             eta_b=f32(rng.uniform(1.2, 2.4, N)),
             a=f32(rng.uniform(0.02, 0.9, N)),
             b=f32(rng.uniform(0.02, 0.9, N)),
             fr_kind=rng.integers(0, 3, N).astype(np.int32),
             fr_eta=f32(rng.uniform(0.1, 2.0, (N, 3))),
             fr_k=f32(rng.uniform(0.5, 4.0, (N, 3))))
    if kind == TS.OREN_NAYAR:
        s2 = f32(np.deg2rad(rng.uniform(1.0, 60.0, N))) ** 2
        p["a"] = f32(1.0 - s2 / (2.0 * (s2 + 0.33)))
        p["b"] = f32(0.45 * s2 / (s2 + 0.09))
    if kind == TS.MICROFACET_REFLECTION:
        # Plastic's swapped coat indices on a third of the lanes.
        swap = rng.uniform(size=N) < 1 / 3
        p["eta_a"] = np.where(swap, np.float32(1.5), p["eta_a"])
        p["eta_b"] = np.where(swap, np.float32(1.0), p["eta_b"])
    return p


def _slots(p: dict):
    t, j = {}, {}
    for k, v in p.items():
        if v.ndim == 2:
            t[k], j[k] = _both3(v)
        else:
            t[k], j[k] = _both(v)
    return TS.LobeSlotP(**t), JS.LobeSlotP(**j)


KINDS = [TS.NONE, TS.LAMBERTIAN_REFLECTION, TS.LAMBERTIAN_TRANSMISSION,
         TS.SPECULAR_REFLECTION, TS.SPECULAR_TRANSMISSION,
         TS.FRESNEL_SPECULAR, TS.OREN_NAYAR, TS.MICROFACET_REFLECTION,
         TS.MICROFACET_TRANSMISSION]


def test_constants_match_jax():
    for name in ("BSDF_REFLECTION", "BSDF_TRANSMISSION", "BSDF_DIFFUSE",
                 "BSDF_GLOSSY", "BSDF_SPECULAR", "BSDF_ALL", "NONE",
                 "LAMBERTIAN_REFLECTION", "LAMBERTIAN_TRANSMISSION",
                 "SPECULAR_REFLECTION", "SPECULAR_TRANSMISSION",
                 "FRESNEL_SPECULAR", "OREN_NAYAR", "MICROFACET_REFLECTION",
                 "MICROFACET_TRANSMISSION", "RADIANCE", "IMPORTANCE"):
        assert getattr(TS, name) == getattr(JLB, name), name
    kinds = torch.arange(9, dtype=torch.int32)
    _exact(TS.lobe_flags(kinds), JLB.lobe_flags(jnp.arange(9)))


@pytest.mark.parametrize("mode", [TS.RADIANCE, TS.IMPORTANCE])
@pytest.mark.parametrize("kind", KINDS)
def test_lobe_f_pdf_sample_match_jax(kind, mode):
    rng = np.random.default_rng(100 + kind)
    tp, jp = _slots(_slot_params(kind, kind))
    two, jwo = _both3(_unit(rng, N))
    twi, jwi = _both3(_unit(rng, N))
    tu0, ju0 = _both(rng.uniform(0, 1, N).astype(np.float32))
    tu1, ju1 = _both(rng.uniform(0, 1, N).astype(np.float32))
    _close(TS.lobe_f(tp, two, twi, mode), JS.lobe_f(jp, jwo, jwi, mode), "f")
    _close(TS.lobe_pdf(tp, two, twi), JS.lobe_pdf(jp, jwo, jwi), "pdf")
    ts = TS.lobe_sample(tp, two, tu0, tu1, mode)
    js = JS.lobe_sample(jp, jwo, ju0, ju1, mode)
    _exact(ts.sampled_flags, js.sampled_flags, "sampled_flags")
    _exact(ts.pdf > 0, js.pdf > 0, "pdf > 0")
    _close(ts.wi, js.wi, "sample wi", where=ts.pdf.numpy() > 0)
    _close(ts.f, js.f, "sample f")
    _close(ts.pdf, js.pdf, "sample pdf")
    if kind != TS.NONE:
        assert bool((ts.pdf > 0).any())


def test_fresnel_conductor_and_dielectric_match_jax():
    rng = np.random.default_rng(7)
    tc, jc = _both(rng.uniform(-1.2, 1.2, N).astype(np.float32))
    te, je = _both3(rng.uniform(0.1, 3.0, (N, 3)))
    tk, jk = _both3(rng.uniform(0.0, 5.0, (N, 3)))
    _close(TS.fresnel_conductor(tc, te, tk), JS.fresnel_conductor(jc, je, jk))
    tb, jb = _both(rng.uniform(1.0, 2.5, N).astype(np.float32))
    ta = torch.ones(N)
    _close(TS.fresnel_dielectric(tc, ta, tb),
           JS.fresnel_dielectric(jc, jnp.ones(N), jb))
    tfk, jfk = _both(rng.integers(0, 3, N).astype(np.int32))
    _close(TS.fresnel_eval(tfk, tc, ta, tb, te, tk),
           JS.fresnel_eval(jfk, jc, jnp.ones(N), jb, je, jk))


def test_roughness_to_alpha_matches_jax():
    r = np.concatenate([np.float32([0.0, 1e-4, 1e-3, 0.05, 0.5, 1.0]),
                        np.random.default_rng(2).uniform(0, 1, 1000)
                        .astype(np.float32)])
    _close(TS.roughness_to_alpha(torch.from_numpy(r)),
           JGGX.roughness_to_alpha(jnp.asarray(r)))


class _Hit:
    """The fields compute_scattering / from_hit read."""

    def __init__(self, V3, asarr, valid, mat, n, ss):
        self.valid = asarr(valid)
        self.material_id = asarr(mat)
        self.t = asarr(np.ones(valid.shape[0], np.float32))
        self.n = self.ns = V3(*[asarr(n[:, i].copy()) for i in range(3)])
        self.s_dpdu = V3(*[asarr(ss[:, i].copy()) for i in range(3)])


def _materials(pkg, table: str):
    M = pkg
    if table == "one_slot":
        return [M.MatteMaterial(Kd=(0.7, 0.5, 0.3)),
                M.MatteMaterial(Kd=(0.2, 0.6, 0.4), sigma=20.0),
                M.MirrorMaterial(Kr=(0.9, 0.8, 0.7)), M.MetalMaterial()]
    return [M.MatteMaterial(Kd=(0.7, 0.5, 0.3)),
            M.MirrorMaterial(Kr=(1.0, 1.0, 1.0)),
            M.GlassMaterial(index=1.5),
            M.PlasticMaterial(Kd=(0.1, 0.1, 0.4), Ks=(0.7, 0.7, 0.7),
                              roughness=0.05),
            M.MetalMaterial(roughness=0.2, remap_roughness=False),
            M.GlassMaterial(Kr=(0.9, 0.9, 1.0), Kt=(0.8, 1.0, 0.9),
                            u_roughness=0.3, v_roughness=0.1, index=1.33),
            M.GlassMaterial(Kr=(0.0, 0.0, 0.0), Kt=(1.0, 1.0, 1.0),
                            index=1.7)]


def _lobes(table: str, multi: bool, seed: int = 5):
    rng = np.random.default_rng(seed)
    n = _unit(rng, N)
    v = _unit(rng, N)
    ss = v - (v * n).sum(1, keepdims=True) * n
    ss = (ss / np.linalg.norm(ss, axis=1, keepdims=True)).astype(np.float32)
    mats = len(_materials(TM, table))
    mat = rng.integers(0, mats, N).astype(np.int32)
    valid = rng.uniform(size=N) < 0.95
    th = _Hit(TV3, torch.from_numpy, valid, mat, n, ss)
    jh = _Hit(JV3, jnp.asarray, valid, mat, n, ss)
    tl = TWM.compute_scattering(_materials(TM, table), th,
                                allow_multiple_lobes=multi)
    jl = JWM.compute_scattering(_materials(JM, table), jh,
                                allow_multiple_lobes=multi)
    return tl, jl, rng


TABLES = [("one_slot", False), ("two_slot", False), ("two_slot", True)]


@pytest.mark.parametrize("table,multi", TABLES)
def test_compute_scattering_matches_jax(table, multi):
    tl, jl, _ = _lobes(table, multi)
    assert len(tl.slots) == len(jl.slots) == (1 if table == "one_slot" else 2)
    for i, (ts, js) in enumerate(zip(tl.slots, jl.slots)):
        for name in TS.LobeSlotP._fields:
            t, j = getattr(ts, name), getattr(js, name)
            if name in ("kind", "fr_kind"):
                _exact(t, j, f"slot {i} {name}")
            else:
                _close(t, j, f"slot {i} {name}")
    for name in ("ng", "ns", "ss", "ts", "eta"):
        _close(getattr(tl, name), getattr(jl, name), name)
    kinds = set(int(k) for s in tl.slots for k in s.kind.unique())
    assert len(kinds) >= 3, kinds


FLAGS = [TS.BSDF_ALL, TS.BSDF_ALL & ~TS.BSDF_SPECULAR,
         TS.BSDF_SPECULAR | TS.BSDF_REFLECTION,
         TS.BSDF_SPECULAR | TS.BSDF_TRANSMISSION]


@pytest.mark.parametrize("mode", [TS.RADIANCE, TS.IMPORTANCE])
@pytest.mark.parametrize("table,multi", TABLES)
def test_aggregate_f_pdf_sample_match_jax(table, multi, mode):
    tl, jl, rng = _lobes(table, multi)
    two, jwo = _both3(_unit(rng, N))
    twi, jwi = _both3(_unit(rng, N))
    tu0, ju0 = _both(rng.uniform(0, 1, N).astype(np.float32))
    tu1, ju1 = _both(rng.uniform(0, 1, N).astype(np.float32))
    for flags in FLAGS:
        msg = f"flags {flags}"
        _close(TS.f(tl, two, twi, flags, mode),
               JS.f(jl, jwo, jwi, flags, mode), "f " + msg)
        _close(TS.compute_pdf(tl, two, twi, flags),
               JS.compute_pdf(jl, jwo, jwi, flags), "pdf " + msg)
        ts = TS.sample_f(tl, two, tu0, tu1, flags, mode)
        js = JS.sample_f(jl, jwo, ju0, ju1, flags, mode)
        _exact(ts.sampled_flags, js.sampled_flags, "sampled_flags " + msg)
        _exact(ts.pdf > 0, js.pdf > 0, "pdf > 0 " + msg)
        _close(ts.wi, js.wi, "wi " + msg, where=ts.pdf.numpy() > 0)
        _close(ts.f, js.f, "sample f " + msg)
        _close(ts.pdf, js.pdf, "sample pdf " + msg)


def _same(a, b, msg):
    a = a.arr() if isinstance(a, TV3) else a
    b = b.arr() if isinstance(b, TV3) else b
    assert torch.equal(a, b), msg


@pytest.mark.parametrize("table,multi", TABLES)
def test_slot_kinds_cover_the_tables_and_change_no_value(table, multi):
    """The host's per-slot kinds hold every code the tables carry, and the
    aggregates with branches skipped by them equal, bit for bit, the ones
    that run every kind's branch."""
    tl, _, rng = _lobes(table, multi)
    assert len(tl.kinds) == len(tl.slots)
    for s, kk in zip(tl.slots, tl.kinds):
        assert set(s.kind.unique().tolist()) <= kk.lobes
        assert set(s.fr_kind.unique().tolist()) <= kk.fresnels
    assert any(kk != TS.ANY_KINDS for kk in tl.kinds)
    every = tl._replace(kinds=())
    wo, _ = _both3(_unit(rng, N))
    wi, _ = _both3(_unit(rng, N))
    u0, _ = _both(rng.uniform(0, 1, N).astype(np.float32))
    u1, _ = _both(rng.uniform(0, 1, N).astype(np.float32))
    for flags in FLAGS:
        for mode in (TS.RADIANCE, TS.IMPORTANCE):
            msg = f"flags {flags} mode {mode}"
            _same(TS.f(tl, wo, wi, flags, mode),
                  TS.f(every, wo, wi, flags, mode), "f " + msg)
            _same(TS.compute_pdf(tl, wo, wi, flags),
                  TS.compute_pdf(every, wo, wi, flags), "pdf " + msg)
            a = TS.sample_f(tl, wo, u0, u1, flags, mode)
            b = TS.sample_f(every, wo, u0, u1, flags, mode)
            for name in TS.BSDFSampleP._fields:
                _same(getattr(a, name), getattr(b, name),
                      f"sample {name} " + msg)


def test_materials_refuse_what_is_not_ported():
    from trace_tpu_torch.materials.textures import Texture

    class Checker(Texture):
        pass

    with pytest.raises(NotImplementedError):
        TWM.check_materials([TM.MatteMaterial(Kd=Checker())])
    with pytest.raises(NotImplementedError):
        TWM.check_materials([object()])
    TWM.check_materials(_materials(TM, "two_slot"))
