"""Planar BSDF lobes: Fresnel, lobe f/pdf/sample and the per-hit
aggregate (port of trace_tpu/wavefront/shade.py).

The slice carries the lobe kinds of matte and smooth glass: Lambertian
and Oren-Nayar reflection, and specular reflection/transmission with the
dielectric Fresnel term. A lane's lobe table is a static tuple of slots
sized by the scene's materials. Microfacet and Fresnel-specular lobes
are not ported yet; the materials that would create them raise first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vec as V
from ..core.vec import V3

F32 = torch.float32

# Lobe flags and kinds (trace_tpu/bxdf/lobes.py).
BSDF_REFLECTION = 1 << 0
BSDF_TRANSMISSION = 1 << 1
BSDF_DIFFUSE = 1 << 2
BSDF_GLOSSY = 1 << 3
BSDF_SPECULAR = 1 << 4
BSDF_ALL = (BSDF_REFLECTION | BSDF_TRANSMISSION | BSDF_DIFFUSE
            | BSDF_GLOSSY | BSDF_SPECULAR)

# Kind codes of the JAX package (2, 5, 7 and 8 are lobes not ported yet).
NONE = 0
LAMBERTIAN_REFLECTION = 1
SPECULAR_REFLECTION = 3
SPECULAR_TRANSMISSION = 4
OREN_NAYAR = 6

# Flags by kind code, 0..6.
_FLAGS = (0, BSDF_REFLECTION | BSDF_DIFFUSE, BSDF_TRANSMISSION | BSDF_DIFFUSE,
          BSDF_REFLECTION | BSDF_SPECULAR, BSDF_TRANSMISSION | BSDF_SPECULAR,
          BSDF_REFLECTION | BSDF_TRANSMISSION | BSDF_SPECULAR,
          BSDF_REFLECTION | BSDF_DIFFUSE)

FRESNEL_DIELECTRIC = 1  # 0 is the no-op Fresnel term


def lobe_flags(kind: torch.Tensor) -> torch.Tensor:
    table = torch.tensor(_FLAGS, dtype=torch.int32, device=kind.device)
    return table[kind.long()]


def matches_flags(kind: torch.Tensor, type_flags: int) -> torch.Tensor:
    f = lobe_flags(kind)
    return (f & type_flags) == f


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel reflectance; a negative cosine
    swaps the media."""
    cos_i = cos_theta_i.clamp(-1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    cos_i = cos_i.abs()
    sin_i = torch.sqrt((1.0 - cos_i * cos_i).clamp_min(0.0))
    sin_t = ei / et * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt((1.0 - sin_t * sin_t).clamp_min(0.0))
    den_par = et * cos_i + ei * cos_t
    den_perp = ei * cos_i + et * cos_t
    r_parl = (et * cos_i - ei * cos_t) / torch.where(den_par == 0.0, 1.0,
                                                     den_par)
    r_perp = (ei * cos_i - et * cos_t) / torch.where(den_perp == 0.0, 1.0,
                                                     den_perp)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fresnel_eval(fr_kind, cos_theta_i, eta_a, eta_b) -> V3:
    """No-op or dielectric Fresnel -> RGB V3."""
    diel = fresnel_dielectric(cos_theta_i, eta_a, eta_b)
    return V.where(fr_kind == FRESNEL_DIELECTRIC, V3(diel, diel, diel), 1.0)


class LobeSlotP(NamedTuple):
    kind: torch.Tensor    # [N] i32
    c0: V3
    eta_a: torch.Tensor
    eta_b: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    fr_kind: torch.Tensor


def empty_slot(n, device) -> LobeSlotP:
    z = torch.zeros((n,), dtype=F32, device=device)
    zi = torch.zeros((n,), dtype=torch.int32, device=device)
    z3 = V3.zeros((n,), device)
    return LobeSlotP(zi, z3, z + 1.0, z + 1.0, z, z, zi)


class LobesP(NamedTuple):
    slots: tuple
    ng: V3
    ns: V3
    ss: V3
    ts: V3
    eta: torch.Tensor


def _safe_div(a, b, eps=1e-12):
    return a / torch.where(b.abs() < eps, 1.0, b)


def _f_oren_nayar(p: LobeSlotP, wo: V3, wi: V3) -> V3:
    sin_i = V.sin_theta(wi)
    sin_o = V.sin_theta(wo)
    d_cos = V.cos_phi(wi) * V.cos_phi(wo) + V.sin_phi(wi) * V.sin_phi(wo)
    max_cos = torch.where((sin_i > 1e-4) & (sin_o > 1e-4),
                          d_cos.clamp_min(0.0), 0.0)
    abs_ci = V.cos_theta(wi).abs()
    abs_co = V.cos_theta(wo).abs()
    i_bigger = abs_ci > abs_co
    sin_alpha = torch.where(i_bigger, sin_o, sin_i)
    tan_beta = torch.where(i_bigger, _safe_div(sin_i, abs_ci),
                           _safe_div(sin_o, abs_co))
    scale = V.INV_PI * (p.a + p.b * max_cos * sin_alpha * tan_beta)
    return p.c0 * scale


def lobe_f(p: LobeSlotP, wo: V3, wi: V3) -> V3:
    """One slot's f(wo, wi); delta lobes give 0."""
    k = p.kind
    out = V3.zeros(k.shape, k.device)
    out = V.where(k == LAMBERTIAN_REFLECTION, p.c0 * V.INV_PI, out)
    return V.where(k == OREN_NAYAR, _f_oren_nayar(p, wo, wi), out)


def lobe_pdf(p: LobeSlotP, wo: V3, wi: V3):
    k = p.kind
    same = V.same_hemisphere(wo, wi)
    cos_pdf = V.cos_theta(wi).abs() * V.INV_PI
    out = torch.zeros(k.shape, dtype=F32, device=k.device)
    diffuse_r = (k == LAMBERTIAN_REFLECTION) | (k == OREN_NAYAR)
    return torch.where(diffuse_r & same, cos_pdf, out)


class LobeSampleP(NamedTuple):
    wi: V3
    f: V3
    pdf: torch.Tensor
    sampled_flags: torch.Tensor


def lobe_sample(p: LobeSlotP, wo: V3, u0, u1) -> LobeSampleP:
    """Sample one slot per lane (radiance transport)."""
    k = p.kind
    zf = torch.zeros(k.shape, dtype=F32, device=k.device)
    flags = lobe_flags(k)

    wi_cos = V.cosine_sample_hemisphere(u0, u1)
    neg = V.cos_theta(wo) < 0.0
    wi_refl = V3(wi_cos.x, wi_cos.y, torch.where(neg, -wi_cos.z, wi_cos.z))

    wi_sr = V3(-wo.x, -wo.y, wo.z)
    cos_sr = V.cos_theta(wi_sr)
    f_sr = (fresnel_eval(p.fr_kind, cos_sr, p.eta_a, p.eta_b)
            * p.c0 * (1.0 / cos_sr.abs().clamp_min(1e-12)))

    entering = V.cos_theta(wo) > 0.0
    eta_i = torch.where(entering, p.eta_a, p.eta_b)
    eta_t = torch.where(entering, p.eta_b, p.eta_a)
    sgn = torch.where(entering, 1.0, -1.0)
    refr_ok, wi_st = V.refract(wo, V3(zf, zf, sgn), eta_i / eta_t)
    cos_st = V.cos_theta(wi_st)
    fr_st = fresnel_dielectric(cos_st, p.eta_a, p.eta_b)
    eta_scale = (eta_i / eta_t) ** 2
    f_st = p.c0 * ((1.0 - fr_st) * eta_scale / cos_st.abs().clamp_min(1e-12))
    f_st = V.where(refr_ok, f_st, 0.0)

    wi = V3(zf, zf, zf + 1.0)
    for kk, vv in ((LAMBERTIAN_REFLECTION, wi_refl), (OREN_NAYAR, wi_refl),
                   (SPECULAR_REFLECTION, wi_sr),
                   (SPECULAR_TRANSMISSION, wi_st)):
        wi = V.where(k == kk, vv, wi)

    f_out = lobe_f(p, wo, wi)
    for kk, vv in ((SPECULAR_REFLECTION, f_sr), (SPECULAR_TRANSMISSION, f_st)):
        f_out = V.where(k == kk, vv, f_out)
    pdf_out = lobe_pdf(p, wo, wi)
    pdf_out = torch.where(k == SPECULAR_REFLECTION, 1.0, pdf_out)
    pdf_out = torch.where(k == SPECULAR_TRANSMISSION,
                          torch.where(refr_ok, 1.0, 0.0), pdf_out)

    fail = ((k == SPECULAR_TRANSMISSION) & ~refr_ok) | (k == NONE)
    f_out = V.where(fail, 0.0, f_out)
    pdf_out = torch.where(fail, 0.0, pdf_out)
    return LobeSampleP(wi, f_out, pdf_out, flags)


def from_hit(hit, n_slots: int) -> LobesP:
    """Empty static-width lobe table with the hit's shading frame."""
    n = hit.t.shape[0]
    dev = hit.t.device
    ss = hit.s_dpdu.normalize()
    return LobesP(slots=tuple(empty_slot(n, dev) for _ in range(n_slots)),
                  ng=hit.n, ns=hit.ns, ss=ss, ts=hit.ns.cross(ss),
                  eta=torch.ones((n,), dtype=F32, device=dev))


def world_to_local(lo: LobesP, v: V3) -> V3:
    return V3(v.dot(lo.ss), v.dot(lo.ts), v.dot(lo.ns))


def local_to_world(lo: LobesP, v: V3) -> V3:
    return lo.ss * v.x + lo.ts * v.y + lo.ns * v.z


def _matching(lo: LobesP, flags: int):
    return [matches_flags(s.kind, flags) & (s.kind != NONE) for s in lo.slots]


def _refl_trans_mask(lo: LobesP, slot: LobeSlotP, wo_w: V3, wi_w: V3):
    reflect = (wi_w.dot(lo.ng) * wo_w.dot(lo.ng)) > 0.0
    fl = lobe_flags(slot.kind)
    return torch.where(reflect, (fl & BSDF_REFLECTION) != 0,
                       (fl & BSDF_TRANSMISSION) != 0)


def f(lo: LobesP, wo_w: V3, wi_w: V3, flags: int = BSDF_ALL) -> V3:
    """Sum of f over the matching lobes."""
    wo = world_to_local(lo, wo_w)
    wi = world_to_local(lo, wi_w)
    degenerate = wo.z.abs() < 1e-12
    total = V3.zeros(wo.z.shape, wo.z.device)
    for s, ms in zip(lo.slots, _matching(lo, flags)):
        msk = ms & _refl_trans_mask(lo, s, wo_w, wi_w)
        total = total + V.where(msk, lobe_f(s, wo, wi), 0.0)
    return V.where(degenerate, 0.0, total)


class BSDFSampleP(NamedTuple):
    wi: V3
    f: V3
    pdf: torch.Tensor
    sampled_flags: torch.Tensor


def _select_slot(slots, is_chosen) -> LobeSlotP:
    out = slots[0]
    for s, ch in zip(slots[1:], is_chosen[1:]):
        out = LobeSlotP(*[V.where(ch, a, b) if isinstance(a, V3)
                          else torch.where(ch, a, b) for a, b in zip(s, out)])
    return out


def sample_f(lo: LobesP, wo_w: V3, u0, u1, flags: int = BSDF_ALL
             ) -> BSDFSampleP:
    """Uniform pick among matching lobes; pdf averaging and f summing
    across matching non-specular lobes."""
    match = _matching(lo, flags)
    count = torch.zeros(u0.shape, dtype=torch.int32, device=u0.device)
    for ms in match:
        count = count + ms.to(torch.int32)
    any_match = count > 0
    comp = torch.minimum(torch.floor(u0 * count.to(F32)).to(torch.int32),
                         (count - 1).clamp_min(0))
    is_chosen = []
    rank = torch.zeros(u0.shape, dtype=torch.int32, device=u0.device) - 1
    for ms in match:
        rank = rank + ms.to(torch.int32)
        is_chosen.append(ms & (rank == comp))
    seen = torch.zeros(u0.shape, dtype=torch.bool, device=u0.device)
    for i in range(len(is_chosen)):
        is_chosen[i] = is_chosen[i] & ~seen
        seen = seen | is_chosen[i]

    u0r = torch.minimum(u0 * count.to(F32) - comp.to(F32),
                        torch.tensor(1.0 - 1e-6, dtype=F32, device=u0.device))
    wo = world_to_local(lo, wo_w)
    degenerate = wo.z.abs() < 1e-12
    chosen = _select_slot(list(lo.slots), is_chosen)
    ls = lobe_sample(chosen, wo, u0r, u1)
    wi = ls.wi
    wi_w = local_to_world(lo, wi)

    specular = (ls.sampled_flags & BSDF_SPECULAR) != 0
    multi = count > 1
    pdf_others = torch.zeros(u0.shape, dtype=F32, device=u0.device)
    for s, ms, ch in zip(lo.slots, match, is_chosen):
        pdf_others = pdf_others + torch.where(ms & ~ch, lobe_pdf(s, wo, wi),
                                              0.0)
    pdf = ls.pdf + torch.where(~specular & multi, pdf_others, 0.0)
    pdf = torch.where(multi, pdf / count.clamp_min(1), pdf)

    f_sum = V3.zeros(u0.shape, u0.device)
    for s, ms in zip(lo.slots, match):
        msk = ms & _refl_trans_mask(lo, s, wo_w, wi_w)
        f_sum = f_sum + V.where(msk, lobe_f(s, wo, wi), 0.0)
    f_out = V.where(specular, ls.f, f_sum)

    ok = any_match & ~degenerate & (pdf > 0.0)
    return BSDFSampleP(wi=wi_w, f=V.where(ok, f_out, 0.0),
                       pdf=torch.where(ok, pdf, 0.0),
                       sampled_flags=torch.where(ok, ls.sampled_flags, 0))
