"""The port's textures (materials/textures.py, io/png.py, the texture facade
of wavefront/materials.py and convert.py's texture trees) against the JAX
package's, on the same numpy inputs made from a seed.

JAX runs op by op (no jit). Tolerances: MipMap tables equal as arrays;
PNGs read equal; texture values within 1e-6 (relative, absolute floor
1e-6) on every lane but at most 1 in 1000, the lanes where XLA's and
torch's f32 log2 differ in the last bit at an integer level, or floor()
takes the neighbouring texel (counted); lobes as in test_torch_lobes.py
(rtol 1e-5, atol 1e-6, at most 1 lane in 1000 outside, kinds exact).
"""
import struct
import zlib
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from torch_jax_arrays import port_scene
from trace_tpu.core import transform as JT
from trace_tpu.core.vec import V3 as JV3
from trace_tpu.io import png as JPNG
from trace_tpu.materials import materials as JM
from trace_tpu.materials import textures as JX
from trace_tpu.scene import SceneBuilder as JSceneBuilder
from trace_tpu.lights import lights as JL
from trace_tpu.wavefront import geom as JG
from trace_tpu.wavefront import materials as JWM
from trace_tpu_torch.core import transform as TT
from trace_tpu_torch.core.vec import V3 as TV3
from trace_tpu_torch.io import png as TPNG
from trace_tpu_torch.materials import materials as TM
from trace_tpu_torch.materials import textures as TX
from trace_tpu_torch.wavefront import geom as TG
from trace_tpu_torch.wavefront import materials as TWM
from trace_tpu_torch.wavefront import shade as TS

N = 4096
TOL = 1e-6
FLIPS = N // 1000
LOBE_RTOL, LOBE_ATOL = 1e-5, 1e-6

IMAGES = {
    "rgb_u8": (lambda r: r.integers(0, 256, (16, 16, 3), np.uint8), False),
    "npot_gamma": (lambda r: r.integers(0, 256, (12, 20, 3), np.uint8),
                   True),
    "rgba": (lambda r: r.integers(0, 256, (8, 8, 4), np.uint8), False),
    "scalar_f32": (lambda r: r.random((10, 6)).astype(np.float32), False),
    "scalar_gamma": (lambda r: r.integers(0, 256, (16, 16), np.uint8),
                     True),
}


def _image(name, seed=3):
    make, gamma = IMAGES[name]
    return make(np.random.default_rng(seed)), gamma


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_mipmap_tables_equal_jax(name):
    img, gamma = _image(name)
    j = JX.MipMap(img, wrap="clamp", gamma=gamma)
    t = TX.MipMap(img, wrap="clamp", gamma=gamma)
    for f in ("dims", "offsets", "texels"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
    assert (t.n_levels, t.is_spectral) == (j.n_levels, j.is_spectral)
    assert t.texels.shape[1] == (1 if img.ndim == 2 else 3)


def _footprints(rng, n=N):
    st = rng.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    # Footprints over every level, some exactly at a power of two (an
    # integer level).
    scale = 2.0 ** rng.integers(-8, 1, (n, 1)).astype(np.float32)
    jitter = np.where(rng.uniform(size=(n, 1)) < 0.2, 1.0,
                      rng.uniform(0.3, 1.0, (n, 1)))
    dx = (rng.choice([-1.0, 1.0], (n, 2)) * scale * jitter).astype(np.float32)
    dy = (dx * rng.uniform(0.0, 1.0, (n, 2))).astype(np.float32)
    return st, dx, dy


def _jax_level(mip, dx, dy):
    width = jnp.maximum(jnp.max(jnp.abs(dx), axis=-1),
                        jnp.max(jnp.abs(dy), axis=-1))
    lvl = (mip.n_levels - 1) + jnp.log2(jnp.maximum(width, 1e-8))
    return np.asarray(jnp.clip(lvl, 0.0, float(mip.n_levels - 1)))


def _off(t, j):
    """Lanes outside TOL (relative, absolute floor TOL)."""
    t, j = np.asarray(t), np.asarray(j)
    off = ~np.isclose(t, j, rtol=TOL, atol=TOL)
    return off.any(-1) if off.ndim > 1 else off


@pytest.mark.parametrize("wrap", ["repeat", "clamp", "black"])
@pytest.mark.parametrize("name", ["rgb_u8", "scalar_f32"])
def test_mipmap_lookup_matches_jax(wrap, name):
    img, gamma = _image(name)
    j = JX.MipMap(img, wrap=wrap, gamma=gamma)
    t = TX.MipMap(img, wrap=wrap, gamma=gamma)
    st, dx, dy = _footprints(np.random.default_rng(11))
    with jax.disable_jit():
        vj = np.asarray(j.lookup(*[jnp.asarray(a) for a in (st, dx, dy)]))
        lj = _jax_level(j, jnp.asarray(dx), jnp.asarray(dy))
    tt = [torch.from_numpy(a) for a in (st, dx, dy)]
    vt = t.lookup(*tt).numpy()
    lt = t.level(tt[1], tt[2]).numpy()
    assert vt.shape == vj.shape
    level_flips = int((np.floor(lt) != np.floor(lj)).sum())
    off = _off(vt, vj)
    print(f"{wrap} {name}: level flips {level_flips}, lanes off "
          f"{int(off.sum())} of {N}")
    assert level_flips <= FLIPS and off.sum() <= FLIPS
    assert len(np.unique(np.floor(lt))) == t.n_levels


def _png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit PNG whose row y uses filter y % 5 (the readers must undo
    all five)."""
    h, w, c = img.shape
    a = img.astype(np.int32).reshape(h, w * c)
    rows = []
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        f = y % 5
        cur = a[y]
        left = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        rows.append(bytes([f]) + ((cur - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = cur
    color = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_matches_jax(tmp_path, channels):
    img = np.random.default_rng(channels).integers(
        0, 256, (11, 7, channels), np.uint8)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png_bytes(img))
    got = TPNG.read_png(path)
    np.testing.assert_array_equal(got, JPNG.read_png(path))
    np.testing.assert_array_equal(got, img)
    # The writer round-trips through both readers.
    out = str(tmp_path / "w.png")
    TPNG.write_png(out, img[..., :3] if channels >= 3 else img[..., 0])
    np.testing.assert_array_equal(TPNG.read_png(out), JPNG.read_png(out))


def _facades(seed=2, n=N):
    """The same texture-facade inputs for both packages (uv, p, dpdx,
    dpdy, dudx ... dvdy)."""
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    a = dict(t=np.ones(n, np.float32), uv=f32(rng.uniform(-0.5, 1.5, (n, 2))),
             p=f32(rng.uniform(-4, 4, (n, 3))),
             dpdx=f32(rng.normal(size=(n, 3)) * 0.05),
             dpdy=f32(rng.normal(size=(n, 3)) * 0.05),
             **{k: f32(rng.normal(size=n) * 10 ** rng.uniform(-4, -1, n))
                for k in ("dudx", "dudy", "dvdx", "dvdy")})
    return (SimpleNamespace(**{k: torch.from_numpy(v) for k, v in a.items()}),
            SimpleNamespace(**{k: jnp.asarray(v) for k, v in a.items()}))


def _textures(X, T, img):
    """Every texture class and both mappings, in one package."""
    rot = T.compose(T.rotate_y(30.0), T.scale(0.25, 0.5, 0.25))
    m3 = X.TransformMapping3D(rot)
    c_rgb = X.ConstantTexture((0.2, 0.5, 0.9))
    c_s = X.ConstantTexture(0.4)
    ramp = X.BilerpTexture(X.UVMapping2D(2.0, 0.5, 0.1, -0.2), 0.0, 0.3,
                           0.8, 1.0)
    corners = X.BilerpTexture(m3, (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1))
    image = X.ImageTexture(X.UVMapping2D(3.0, 3.0),
                           X.MipMap(img, wrap="repeat", gamma=True))
    image3 = X.ImageTexture(m3, X.MipMap(img, wrap="black"), scale=1.5)
    gray = X.ImageTexture(X.UVMapping2D(), X.MipMap(img[..., 0],
                                                    wrap="clamp"))
    return {
        "constant_rgb": c_rgb, "constant_scalar": c_s,
        "scale_rgb_by_scalar": X.ScaleTexture(c_rgb, ramp),
        "scale_scalar_by_rgb": X.ScaleTexture(ramp, c_rgb),
        "mix_scalar_amount": X.MixTexture(c_rgb, corners, ramp),
        "bilerp_scalar_uv": ramp, "bilerp_rgb_3d": corners,
        "image_uv": image, "image_3d": image3, "image_scalar": gray,
        "mix_of_images": X.MixTexture(image, image3, gray),
    }


TEX_NAMES = sorted(_textures(TX, TT, np.zeros((4, 4, 3), np.uint8)))


@pytest.mark.parametrize("name", TEX_NAMES)
def test_texture_matches_jax(name):
    img = np.random.default_rng(5).integers(0, 256, (16, 16, 3), np.uint8)
    t = _textures(TX, TT, img)[name]
    j = _textures(JX, JT, img)[name]
    th, jh = _facades()
    with jax.disable_jit():
        vj = np.asarray(j(jh))
    vt = t(th).numpy()
    assert vt.shape == vj.shape and np.isfinite(vt).all()
    off = _off(vt, vj)
    print(f"{name}: lanes off {int(off.sum())} of {N}")
    assert off.sum() <= FLIPS
    assert np.ptp(vt) > 0 or name.startswith("constant")


def test_clamp_texture_matches_jax():
    v = np.random.default_rng(1).normal(size=(N, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TX.clamp_texture(torch.from_numpy(v)).numpy(),
        np.asarray(JX.clamp_texture(jnp.asarray(v))))
    np.testing.assert_array_equal(
        TX.clamp_texture(torch.from_numpy(v), -0.5, 0.5).numpy(),
        np.asarray(JX.clamp_texture(jnp.asarray(v), -0.5, 0.5)))


def _hit_arrays(seed, n, n_mat):
    rng = np.random.default_rng(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm = f32(nrm / np.linalg.norm(nrm, axis=1, keepdims=True))
    v = rng.normal(size=(n, 3))
    ss = v - (v * nrm).sum(1, keepdims=True) * nrm
    ss = f32(ss / np.linalg.norm(ss, axis=1, keepdims=True))
    a = {f: f32(rng.normal(size=(n, 3))) for f in (
        "p", "wo", "dpdu", "dpdv", "s_dpdv", "s_dndu", "s_dndv")}
    a["p"] = f32(rng.uniform(-4, 4, (n, 3)))
    a.update(n=nrm, ns=nrm, s_dpdu=ss,
             dpdx=f32(rng.normal(size=(n, 3)) * 0.05),
             dpdy=f32(rng.normal(size=(n, 3)) * 0.05),
             valid=rng.uniform(size=n) < 0.95, t=np.ones(n, np.float32),
             time=np.zeros(n, np.float32),
             u=f32(rng.uniform(0, 1, n)), v=f32(rng.uniform(0, 1, n)),
             prim_id=np.zeros(n, np.int32),
             material_id=rng.integers(0, n_mat, n).astype(np.int32),
             **{k: f32(rng.normal(size=n) * 10 ** rng.uniform(-4, -1, n))
                for k in ("dudx", "dudy", "dvdx", "dvdy")})
    return a


def _hitp(HitP, V3, asarr, a):
    return HitP(**{f: V3(*[asarr(a[f][:, i].copy()) for i in range(3)])
                   if a[f].ndim == 2 else asarr(a[f]) for f in HitP._fields})


def _textured_materials(M, X, T, img):
    tex = _textures(X, T, img)
    rough = X.ScaleTexture(tex["bilerp_scalar_uv"], X.ConstantTexture(0.3))
    return [M.MatteMaterial(Kd=tex["image_uv"], sigma=X.ScaleTexture(
                tex["image_scalar"], X.ConstantTexture(40.0))),
            M.PlasticMaterial(Kd=tex["mix_scalar_amount"],
                              Ks=tex["image_3d"], roughness=rough),
            M.MetalMaterial(roughness=rough),
            M.GlassMaterial(Kr=tex["bilerp_rgb_3d"], Kt=tex["image_uv"],
                            u_roughness=rough, v_roughness=rough),
            M.GlassMaterial(Kt=tex["scale_rgb_by_scalar"], index=1.4)]


def _lobe_close(t, j, msg):
    if isinstance(t, TV3):
        t, j = t.arr(), j.arr()
    t, j = t.numpy(), np.asarray(j)
    off = ~np.isclose(t, j, rtol=LOBE_RTOL, atol=LOBE_ATOL)
    if off.ndim > 1:
        off = off.any(-1)
    assert off.sum() <= FLIPS, (msg, int(off.sum()))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("mode", [TS.RADIANCE, TS.IMPORTANCE])
def test_textured_compute_scattering_matches_jax(mode, multi):
    img = np.random.default_rng(6).integers(0, 256, (16, 16, 3), np.uint8)
    tm = _textured_materials(TM, TX, TT, img)
    jm = _textured_materials(JM, JX, JT, img)
    TWM.check_materials(tm)
    a = _hit_arrays(8, N, len(tm))
    th = _hitp(TG.HitP, TV3, torch.from_numpy, a)
    jh = _hitp(JG.HitP, JV3, jnp.asarray, a)
    tl = TWM.compute_scattering(tm, th, allow_multiple_lobes=multi,
                                mode=mode)
    with jax.disable_jit():
        jl = JWM.compute_scattering(jm, jh, allow_multiple_lobes=multi,
                                    mode=mode)
    kinds = set()
    for i, (ts, js) in enumerate(zip(tl.slots, jl.slots)):
        for name in TS.LobeSlotP._fields:
            t, j = getattr(ts, name), getattr(js, name)
            if name in ("kind", "fr_kind"):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            else:
                _lobe_close(t, j, f"slot {i} {name}")
        kinds |= set(int(k) for k in ts.kind.unique())
    _lobe_close(tl.eta, jl.eta, "eta")
    assert {TS.OREN_NAYAR, TS.MICROFACET_REFLECTION,
            TS.MICROFACET_TRANSMISSION} <= kinds


def test_check_materials_takes_ported_textures_and_refuses_others():
    img = np.zeros((4, 4, 3), np.uint8)
    TWM.check_materials(_textured_materials(TM, TX, TT, img))

    class Mapping:
        def __call__(self, hit):
            raise AssertionError

    with pytest.raises(NotImplementedError):
        TWM.check_materials([TM.MatteMaterial(
            Kd=TX.BilerpTexture(Mapping(), 0, 0, 1, 1))])
    with pytest.raises(NotImplementedError):
        TWM.check_materials([TM.MatteMaterial(Kd=TX.MixTexture(
            TX.ConstantTexture(0.1), TX.Texture(), TX.ConstantTexture(0.5)))])
    with pytest.raises(ValueError):
        TX.MipMap(img, wrap="mirror")


def test_convert_carries_a_textured_scene():
    """A JAX scene whose materials hold every texture kind, carried across
    by convert.py: the port's textures give the JAX values on the same
    facade, and the scene put the mip tables on its device."""
    img = np.random.default_rng(9).integers(0, 256, (8, 8, 3), np.uint8)
    b = JSceneBuilder()
    ids = [b.material(m) for m in _textured_materials(JM, JX, JT, img)]
    for k, mid in enumerate(ids):
        b.sphere(JT.translate([1.5 * k, 0.0, 0.0]), 0.5, mid)
    b.light(JL.point_light(JT.translate([0.0, 4.0, 0.0]), (5.0, 5.0, 5.0)))
    js = b.build()
    ts = port_scene(js)
    th, jh = _facades(seed=4)
    n_tex = 0
    for tmat, jmat in zip(ts.materials, js.materials):
        assert type(tmat).__name__ == type(jmat).__name__
        for name, jt in vars(jmat).items():
            if not isinstance(jt, JX.Texture):
                continue
            tt = getattr(tmat, name)
            assert type(tt).__name__ == type(jt).__name__, name
            with jax.disable_jit():
                vj = np.asarray(jt(jh))
            assert _off(tt(th).numpy(), vj).sum() <= FLIPS, name
            n_tex += not isinstance(jt, JX.ConstantTexture)
            for sub in TX.walk(tt):
                if isinstance(sub, TX.ImageTexture):
                    assert "cpu" in sub.mip._device_tables
    assert n_tex >= 8
