"""Material dispatch: textures -> static-width lobe slots (port of
trace_tpu/wavefront/materials.py).

Constant textures broadcast host scalars. Every other texture evaluates
through a facade over the hit (``TexHit``: ``uv``, ``p``, ``dpdx``,
``dpdy``, ``dudx`` ... ``dvdy``), as in the JAX twin, and is clamped as
the materials clamp it. Whitted's hits carry ray differentials, so its
image lookups pick mip levels above 0; the path tracer's and SPPM's hits
carry zeros there, as the JAX package's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import vec as V
from ..core.vec import V3
from ..materials import materials as M
from ..materials import textures as TX
from . import shade as S
from .geom import HitP

F32 = torch.float32
DEG2RAD = float(np.float32(np.pi / 180.0))
MATERIALS = (M.MatteMaterial, M.MirrorMaterial, M.GlassMaterial,
             M.PlasticMaterial, M.MetalMaterial)
TEXTURES = (TX.ConstantTexture, TX.ScaleTexture, TX.MixTexture,
            TX.BilerpTexture, TX.ImageTexture)
MAPPINGS = (TX.UVMapping2D, TX.TransformMapping3D)


def _check_texture(mat, tex) -> None:
    for t in TX.walk(tex):
        if not isinstance(t, TEXTURES):
            raise NotImplementedError(
                f"{type(mat).__name__}: texture {type(t).__name__} is not "
                f"ported")
        mapping = getattr(t, "mapping", None)
        if mapping is not None and not isinstance(mapping, MAPPINGS):
            raise NotImplementedError(
                f"{type(mat).__name__}: mapping {type(mapping).__name__} "
                f"is not ported")


def check_materials(materials) -> None:
    """Raise for what the dispatch below cannot shade."""
    for m in materials:
        if not isinstance(m, MATERIALS):
            raise NotImplementedError(
                f"material {type(m).__name__} is not ported")
        for tex in m.textures():
            _check_texture(m, tex)


class TexHit:
    """The hit as a texture reads it: [N] and [N, 3] tensors."""

    def __init__(self, hp: HitP):
        self._hp = hp
        self.t = hp.t
        self.dudx, self.dudy = hp.dudx, hp.dudy
        self.dvdx, self.dvdy = hp.dvdx, hp.dvdy

    @property
    def uv(self):
        return torch.stack([self._hp.u, self._hp.v], dim=-1)

    @property
    def p(self):
        return self._hp.p.arr()

    @property
    def dpdx(self):
        return self._hp.dpdx.arr()

    @property
    def dpdy(self):
        return self._hp.dpdy.arr()


def _tex_rgb(tex, hit: HitP, cache) -> V3:
    if isinstance(tex, TX.ConstantTexture):
        v = np.broadcast_to(tex.value, (3,))
        return V3.full(hit.t.shape, v[0], v[1], v[2], hit.t.device)
    if cache[0] is None:
        cache[0] = TexHit(hit)
    return V3.of(tex(cache[0]))


def _tex_scalar(tex, hit: HitP, cache) -> torch.Tensor:
    if isinstance(tex, TX.ConstantTexture):
        return torch.full(hit.t.shape, float(tex.value), dtype=F32,
                          device=hit.t.device)
    if cache[0] is None:
        cache[0] = TexHit(hit)
    return tex(cache[0])


def _set_slot(slots, i, mask, **fields):
    """Write ``fields`` into slot ``i`` where ``mask`` holds."""
    s = slots[i]
    upd = {}
    for name, val in fields.items():
        cur = getattr(s, name)
        if isinstance(cur, V3):
            upd[name] = V.where(mask, val, cur)
        else:
            if not torch.is_tensor(val):
                val = torch.full_like(cur, val)
            upd[name] = torch.where(mask, val.to(cur.dtype), cur)
    slots = list(slots)
    slots[i] = s._replace(**upd)
    return tuple(slots)


def material_slots(mat: M.Material) -> int:
    return 2 if isinstance(mat, (M.GlassMaterial, M.PlasticMaterial)) else 1


def scene_slot_count(materials) -> int:
    return max((material_slots(m) for m in materials), default=1)


def _is_zero(tex) -> bool:
    return (isinstance(tex, TX.ConstantTexture)
            and bool(np.all(np.asarray(tex.value) == 0)))


def lobe_kinds(materials, allow_multiple_lobes=False) -> tuple:
    """Per slot, the lobe and Fresnel kinds compute_scattering can write
    for these materials (S.SlotKinds). A superset: a parameter is read only
    where it is exactly zero (a matte sigma, a glass roughness)."""
    n_slots = scene_slot_count(materials)
    lobes = [{S.NONE} for _ in range(n_slots)]
    fresnels = [{S.FRESNEL_NOOP} for _ in range(n_slots)]
    for mat in materials:
        if isinstance(mat, M.MatteMaterial):
            lobes[0].add(S.LAMBERTIAN_REFLECTION)
            if not _is_zero(mat.sigma):
                lobes[0].add(S.OREN_NAYAR)
        elif isinstance(mat, M.MirrorMaterial):
            lobes[0].add(S.SPECULAR_REFLECTION)
        elif isinstance(mat, M.GlassMaterial):
            smooth = _is_zero(mat.u_roughness) and _is_zero(mat.v_roughness)
            if allow_multiple_lobes:
                lobes[0].add(S.FRESNEL_SPECULAR)
            else:
                lobes[0].add(S.SPECULAR_REFLECTION)
                lobes[1].add(S.SPECULAR_TRANSMISSION)
            if not smooth:
                lobes[0].add(S.MICROFACET_REFLECTION)
                lobes[1].add(S.MICROFACET_TRANSMISSION)
            fresnels[0].add(S.FRESNEL_DIELECTRIC)
            fresnels[1].add(S.FRESNEL_DIELECTRIC)
        elif isinstance(mat, M.PlasticMaterial):
            lobes[0].add(S.LAMBERTIAN_REFLECTION)
            lobes[1].add(S.MICROFACET_REFLECTION)
            fresnels[1].add(S.FRESNEL_DIELECTRIC)
        elif isinstance(mat, M.MetalMaterial):
            lobes[0].add(S.MICROFACET_REFLECTION)
            fresnels[0].add(S.FRESNEL_CONDUCTOR)
        else:  # a material this table does not know: run every kind
            return (S.ANY_KINDS,) * n_slots
    return tuple(S.SlotKinds(frozenset(lk), frozenset(fk))
                 for lk, fk in zip(lobes, fresnels))


def compute_scattering(materials, hit: HitP, allow_multiple_lobes=False,
                       mode=S.RADIANCE) -> S.LobesP:
    """Lobes for every lane. ``allow_multiple_lobes``: smooth glass is one
    Fresnel-specular slot (the path tracer) instead of separate
    reflection and transmission slots (Whitted's two branches)."""
    n_slots = scene_slot_count(materials)
    lo = S.from_hit(hit, n_slots)
    slots = lo.slots
    eta = lo.eta
    cache = [None]
    for mat_id, mat in enumerate(materials):
        mask = hit.valid & (hit.material_id == mat_id)
        if isinstance(mat, M.MatteMaterial):
            r = V.maximum(_tex_rgb(mat.Kd, hit, cache), 0.0)
            sig = _tex_scalar(mat.sigma, hit, cache).clamp(0.0, 90.0)
            use_on = ~(sig.abs() < 1e-6)
            sig_rad = sig * DEG2RAD
            s2 = sig_rad * sig_rad
            a = 1.0 - s2 / (2.0 * (s2 + 0.33))
            b = 0.45 * s2 / (s2 + 0.09)
            kind = torch.where(use_on, S.OREN_NAYAR, S.LAMBERTIAN_REFLECTION)
            slots = _set_slot(slots, 0, mask & ~r.is_black(), kind=kind,
                              c0=r, a=torch.where(use_on, a, 0.0),
                              b=torch.where(use_on, b, 0.0))
        elif isinstance(mat, M.MirrorMaterial):
            # The no-op Fresnel term, as the reference's mirror has.
            r = V.maximum(_tex_rgb(mat.Kr, hit, cache), 0.0)
            slots = _set_slot(slots, 0, mask & ~r.is_black(),
                              kind=S.SPECULAR_REFLECTION, c0=r,
                              fr_kind=S.FRESNEL_NOOP)
        elif isinstance(mat, M.GlassMaterial):
            eta_m = _tex_scalar(mat.index, hit, cache)
            u_rough = _tex_scalar(mat.u_roughness, hit, cache)
            v_rough = _tex_scalar(mat.v_roughness, hit, cache)
            r = V.maximum(_tex_rgb(mat.Kr, hit, cache), 0.0)
            t = V.maximum(_tex_rgb(mat.Kt, hit, cache), 0.0)
            r_black, t_black = r.is_black(), t.is_black()
            all_black = r_black & t_black
            is_specular = (u_rough.abs() < 1e-6) & (v_rough.abs() < 1e-6)
            if mat.remap_roughness:
                u_rough = S.roughness_to_alpha(u_rough)
                v_rough = S.roughness_to_alpha(v_rough)
            eta = torch.where(mask, eta_m, eta)
            ones = torch.ones_like(eta_m)
            if allow_multiple_lobes:
                slots = _set_slot(slots, 0, mask & ~all_black & is_specular,
                                  kind=S.FRESNEL_SPECULAR, c0=r, c1=t,
                                  eta_a=ones, eta_b=eta_m,
                                  fr_kind=S.FRESNEL_DIELECTRIC)
                sep_specular = torch.zeros_like(is_specular)
            else:
                sep_specular = is_specular
            sep = mask & ~all_black & (~is_specular | sep_specular)
            kind_r = torch.where(sep_specular, S.SPECULAR_REFLECTION,
                                 S.MICROFACET_REFLECTION)
            slots = _set_slot(slots, 0, sep & ~r_black, kind=kind_r, c0=r,
                              eta_a=ones, eta_b=eta_m, a=u_rough, b=v_rough,
                              fr_kind=S.FRESNEL_DIELECTRIC)
            kind_t = torch.where(sep_specular, S.SPECULAR_TRANSMISSION,
                                 S.MICROFACET_TRANSMISSION)
            slots = _set_slot(slots, 1, sep & ~t_black, kind=kind_t, c0=t,
                              eta_a=ones, eta_b=eta_m, a=u_rough, b=v_rough,
                              fr_kind=S.FRESNEL_DIELECTRIC)
        elif isinstance(mat, M.PlasticMaterial):
            kd = V.maximum(_tex_rgb(mat.Kd, hit, cache), 0.0)
            slots = _set_slot(slots, 0, mask & ~kd.is_black(),
                              kind=S.LAMBERTIAN_REFLECTION, c0=kd)
            ks = V.maximum(_tex_rgb(mat.Ks, hit, cache), 0.0)
            rough = _tex_scalar(mat.roughness, hit, cache)
            if mat.remap_roughness:
                rough = S.roughness_to_alpha(rough)
            # The coat's dielectric Fresnel with eta_a 1.5, eta_b 1: the
            # reference swaps "above" and "below" here, and so do we.
            slots = _set_slot(slots, 1, mask & ~ks.is_black(),
                              kind=S.MICROFACET_REFLECTION, c0=ks,
                              eta_a=torch.full_like(rough, 1.5),
                              eta_b=torch.ones_like(rough), a=rough, b=rough,
                              fr_kind=S.FRESNEL_DIELECTRIC)
        elif isinstance(mat, M.MetalMaterial):
            rough = _tex_scalar(mat.roughness, hit, cache)
            if mat.remap_roughness:
                rough = S.roughness_to_alpha(rough)
            slots = _set_slot(slots, 0, mask, kind=S.MICROFACET_REFLECTION,
                              c0=V3.full(hit.t.shape, 1.0, 1.0, 1.0,
                                         hit.t.device),
                              a=rough, b=rough, fr_kind=S.FRESNEL_CONDUCTOR,
                              fr_eta=_tex_rgb(mat.eta, hit, cache),
                              fr_k=_tex_rgb(mat.k, hit, cache))
        else:
            raise NotImplementedError(
                f"material {type(mat).__name__} is not ported")
    return lo._replace(slots=slots, eta=eta,
                       kinds=lobe_kinds(materials, allow_multiple_lobes))
