"""Textures (port of trace_tpu/materials/textures.py).

A texture is a small host object whose ``__call__(hit)`` evaluates it on
every lane of a hit facade (wavefront/materials.py: ``t``, ``uv`` [N, 2],
``p``, ``dpdx``, ``dpdy`` [N, 3], ``dudx`` ... ``dvdy`` [N]): spectral
textures give [N, 3], scalar ones [N]. Constant, Scale, Mix and Bilerp
textures, the UV and 3D mappings, and ``ImageTexture`` over a ``MipMap``.

A MipMap's pyramid is built on the host in numpy, as the JAX package
builds it (power-of-two resample, sRGB decode, alpha dropped), and packed
into one flat texel table with per-level ``dims`` and ``offsets``. The
tables go to a device once (``MipMap.tables``; a Scene uploads them when
it is built) and every lookup gathers from that copy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import transform as T
from ..core.sync import device_constant

F32 = torch.float32
WRAPS = ("repeat", "clamp", "black")


# ---------------------------------------------------------------------------
# Mappings
# ---------------------------------------------------------------------------


class UVMapping2D:
    """(u, v) -> (su u + du, sv v + dv), with the screen-space
    differentials."""

    def __init__(self, su=1.0, sv=1.0, du=0.0, dv=0.0):
        self.su, self.sv, self.du, self.dv = map(float, (su, sv, du, dv))

    def __call__(self, hit):
        st = torch.stack([self.su * hit.uv[..., 0] + self.du,
                          self.sv * hit.uv[..., 1] + self.dv], dim=-1)
        dstdx = torch.stack([self.su * hit.dudx, self.sv * hit.dvdx], dim=-1)
        dstdy = torch.stack([self.su * hit.dudy, self.sv * hit.dvdy], dim=-1)
        return st, dstdx, dstdy


class TransformMapping3D:
    """World point -> texture space through ``world_to_texture`` (a
    core.transform Transform); the first two coordinates address a 2D
    texture."""

    def __init__(self, world_to_texture: T.Transform):
        self.w2t = world_to_texture

    def __call__(self, hit):
        return (T.apply_point(self.w2t, hit.p),
                T.apply_vec(self.w2t, hit.dpdx),
                T.apply_vec(self.w2t, hit.dpdy))


# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------


def _constant(v: np.ndarray, device) -> torch.Tensor:
    """A host float32 value (scalar or RGB) on ``device``, made once."""
    x = v.tolist()
    return device_constant(tuple(x) if isinstance(x, list) else x,
                           torch.float32, device)


class Texture:
    def __call__(self, hit):
        raise NotImplementedError

    def children(self) -> list:
        """The textures this one evaluates (a tree's edges)."""
        return []


class ConstantTexture(Texture):
    """A constant scalar or RGB value, held as host float32."""

    def __init__(self, value):
        v = np.asarray(value, np.float32)
        self.value = v
        self.is_spectral = v.ndim > 0

    def __call__(self, hit):
        n = hit.t.shape[0]
        v = _constant(self.value, hit.t.device)
        return v.expand((n, 3) if self.is_spectral else (n,))


def _lift(a, b):
    """Broadcast a scalar [N] texture value against a spectral [N, 3]
    one, whichever side it is on."""
    if a.ndim > b.ndim:
        b = b[..., None]
    elif b.ndim > a.ndim:
        a = a[..., None]
    return a, b


class ScaleTexture(Texture):
    """value * scale; a scalar side broadcasts against a spectral one,
    either way."""

    def __init__(self, value: Texture, scale: Texture):
        self.value, self.scale = value, scale

    def children(self):
        return [self.value, self.scale]

    def __call__(self, hit):
        v, s = _lift(self.value(hit), self.scale(hit))
        return v * s


class MixTexture(Texture):
    """(1 - amount) t1 + amount t2; a scalar amount (or value) broadcasts
    against spectral values (or amount)."""

    def __init__(self, t1: Texture, t2: Texture, amount: Texture):
        self.t1, self.t2, self.amount = t1, t2, amount

    def children(self):
        return [self.t1, self.t2, self.amount]

    def __call__(self, hit):
        a = self.amount(hit)
        v1, v2 = _lift(self.t1(hit), self.t2(hit))
        a, v1 = _lift(a, v1)
        a, v2 = _lift(a, v2)
        return (1.0 - a) * v1 + a * v2


class BilerpTexture(Texture):
    """Bilinear blend of four corner values over the mapped (s, t)."""

    def __init__(self, mapping, v00, v01, v10, v11):
        self.mapping = mapping
        vs = [np.asarray(v, np.float32) for v in (v00, v01, v10, v11)]
        self.v00, self.v01, self.v10, self.v11 = vs
        self.is_spectral = vs[0].ndim > 0

    def __call__(self, hit):
        st, _, _ = self.mapping(hit)
        s, t = st[..., 0], st[..., 1]
        dev = st.device
        c = [_constant(v, dev)
             for v in (self.v00, self.v01, self.v10, self.v11)]
        if self.is_spectral:
            s, t = s[..., None], t[..., None]
        return ((1 - s) * (1 - t) * c[0] + (1 - s) * t * c[1]
                + s * (1 - t) * c[2] + s * t * c[3])


def clamp_texture(v, low=0.0, high=float("inf")):
    """Clamp an evaluated texture (the reference clamps every one)."""
    return v.clamp(low, high)


# ---------------------------------------------------------------------------
# Image textures with mip-mapping
# ---------------------------------------------------------------------------


def _bilinear_resize(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """Host bilinear resample of [H, W, C] to [nh, nw, C] (texel
    centres), in float64, rounded to float32 once."""
    h, w = img.shape[:2]
    ys = (np.arange(nh, dtype=np.float64) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw, dtype=np.float64) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
    a = img[y0][:, x0] * (1 - fy) * (1 - fx) + img[y0][:, x1] * (1 - fy) * fx
    b = img[y1][:, x0] * fy * (1 - fx) + img[y1][:, x1] * fy * fx
    return (a + b).astype(np.float32)


class MipMap:
    """Image pyramid with trilinear lookups: the footprint of the
    screen-space differentials picks the level.

    Every level lies in one flat [T, C] table (``texels``) with per-level
    ``dims`` [L, 2] (height, width) and ``offsets`` [L], host numpy.
    ``wrap``: "repeat", "clamp" or "black". ``gamma=True`` decodes sRGB
    to linear. An image whose sides are not powers of two is resampled up
    to them first."""

    def __init__(self, image, wrap: str = "repeat", gamma: bool = False):
        if wrap not in WRAPS:
            raise ValueError(f"wrap {wrap!r} is not one of {WRAPS}")
        img = np.asarray(image)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if gamma:
            img = np.where(img <= 0.04045, img / 12.92,
                           ((img + 0.055) / 1.055) ** 2.4).astype(np.float32)
        is_spectral = img.ndim == 3
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 4:   # drop alpha
            img = img[..., :3]
        h, w = img.shape[:2]
        ph = 1 << max(h - 1, 0).bit_length()
        pw = 1 << max(w - 1, 0).bit_length()
        if (ph, pw) != (h, w):
            img = _bilinear_resize(img, ph, pw)
        levels = [img]
        while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
            prev = levels[-1]
            hh = max(prev.shape[0] // 2, 1)
            ww = max(prev.shape[1] // 2, 1)
            r = prev.reshape(hh, prev.shape[0] // hh, ww,
                             prev.shape[1] // ww, -1)
            levels.append(r.mean(axis=(1, 3), dtype=np.float32))
        sizes = [lv.shape[0] * lv.shape[1] for lv in levels]
        self._init_tables(
            np.array([[lv.shape[0], lv.shape[1]] for lv in levels],
                     np.int32),
            np.cumsum([0] + sizes[:-1]).astype(np.int32),
            np.concatenate([lv.reshape(-1, lv.shape[-1]) for lv in levels],
                           axis=0),
            wrap, is_spectral)

    def _init_tables(self, dims, offsets, texels, wrap, is_spectral):
        self.dims = np.asarray(dims, np.int32)
        self.offsets = np.asarray(offsets, np.int32)
        self.texels = np.ascontiguousarray(texels, np.float32)
        self.wrap = wrap
        self.is_spectral = bool(is_spectral)
        self.n_levels = int(self.dims.shape[0])
        self._device_tables = {}

    @classmethod
    def from_tables(cls, dims, offsets, texels, wrap: str,
                    is_spectral: bool) -> "MipMap":
        """A MipMap over pyramid tables built elsewhere (convert.py)."""
        if wrap not in WRAPS:
            raise ValueError(f"wrap {wrap!r} is not one of {WRAPS}")
        mip = cls.__new__(cls)
        mip._init_tables(dims, offsets, texels, wrap, is_spectral)
        return mip

    def tables(self, device):
        """(dims as f32 [L, 2], offsets int64 [L], texels [T, C]) on
        ``device``, uploaded on the first call for that device."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = str(dev)
        if key not in self._device_tables:
            self._device_tables[key] = (
                torch.from_numpy(self.dims.astype(np.float32)).to(dev),
                torch.from_numpy(self.offsets.astype(np.int64)).to(dev),
                torch.from_numpy(self.texels).to(dev))
        return self._device_tables[key]

    def _bilerp_level(self, lvl, s, t):
        """Bilinear lookup of (s, t) [N] at per-lane levels ``lvl`` [N]
        -> [N, C]. The texel coordinates divide by the lane's level width
        and height as tensors (the ``repeat`` wrap)."""
        dims, offs, texels = self.tables(s.device)
        hw = dims[lvl]
        h, w = hw[:, 0], hw[:, 1]
        off = offs[lvl]
        x = s * w - 0.5
        y = t * h - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0

        def texel(xi, yi):
            valid = None
            if self.wrap == "repeat":
                xi = xi - torch.floor(xi / w) * w
                yi = yi - torch.floor(yi / h) * h
            elif self.wrap == "black":
                valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            xi = torch.minimum(xi.clamp_min(0.0), w - 1.0)
            yi = torch.minimum(yi.clamp_min(0.0), h - 1.0)
            # A NaN coordinate (a masked lane) reads the level's first
            # texel, not an index that would trap on the card.
            flat = off + torch.nan_to_num(yi * w + xi).to(torch.int32)
            v = texels[flat.long()]
            if valid is not None:
                v = v * valid[:, None].to(F32)
            return v

        return (((1 - fx) * (1 - fy))[:, None] * texel(x0, y0)
                + (fx * (1 - fy))[:, None] * texel(x0 + 1, y0)
                + ((1 - fx) * fy)[:, None] * texel(x0, y0 + 1)
                + (fx * fy)[:, None] * texel(x0 + 1, y0 + 1))

    def level(self, dstdx, dstdy):
        """The continuous mip level [N] of the footprint of the
        differentials [N, 2]."""
        width = torch.maximum(dstdx.abs().amax(-1), dstdy.abs().amax(-1))
        lvl = (self.n_levels - 1) + torch.log2(width.clamp_min(1e-8))
        return lvl.clamp(0.0, float(self.n_levels - 1))

    def lookup(self, st, dstdx, dstdy):
        """Trilinear lookup: st [N, 2] and its screen-space differentials
        -> [N, 3] (spectral) or [N] (scalar)."""
        s, t = st[..., 0], st[..., 1]
        lvl = self.level(dstdx, dstdy)
        l0 = torch.floor(lvl).to(torch.int32)
        l1 = (l0 + 1).clamp_max(self.n_levels - 1)
        f = (lvl - l0.to(F32))[:, None]
        v = (1.0 - f) * self._bilerp_level(l0.long(), s, t)
        v = v + f * self._bilerp_level(l1.long(), s, t)
        return v if self.is_spectral else v[:, 0]


class ImageTexture(Texture):
    """A mip-mapped image looked up through a 2D mapping."""

    def __init__(self, mapping, mipmap, scale: float = 1.0):
        self.mapping = mapping
        self.mip = mipmap if isinstance(mipmap, MipMap) else MipMap(mipmap)
        self.scale = float(scale)
        self.is_spectral = self.mip.is_spectral

    def __call__(self, hit):
        st, dstdx, dstdy = self.mapping(hit)
        v = self.mip.lookup(st, dstdx, dstdy)
        return v * self.scale if self.scale != 1.0 else v


def image_texture(path: str, mapping=None, wrap: str = "repeat",
                  gamma: bool = True, scale: float = 1.0) -> ImageTexture:
    """A PNG as a mip-mapped ImageTexture (8-bit PNGs are sRGB-decoded to
    linear by default)."""
    from ..io.png import read_png

    return ImageTexture(mapping if mapping is not None else UVMapping2D(),
                        MipMap(read_png(path), wrap=wrap, gamma=gamma),
                        scale=scale)


def as_texture(value_or_texture) -> Texture:
    if isinstance(value_or_texture, Texture):
        return value_or_texture
    return ConstantTexture(value_or_texture)


def walk(tex):
    """Every texture of the tree under ``tex``, ``tex`` first."""
    out = [tex]
    for c in tex.children():
        out += walk(c)
    return out


def upload(materials, device) -> None:
    """Move every MipMap under the materials' textures to ``device`` once
    (a Scene calls this when it is built or moved)."""
    for m in materials:
        for tex in m.textures():
            for t in walk(tex):
                if isinstance(t, ImageTexture):
                    t.mip.tables(device)
