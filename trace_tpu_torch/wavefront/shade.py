"""Planar BSDF lobes: Fresnel, GGX, lobe f/pdf/sample and the per-hit
aggregate (port of trace_tpu/wavefront/shade.py, with roughness_to_alpha
from trace_tpu/bxdf/ggx.py).

Every lobe kind of the JAX package is here: Lambertian reflection and
transmission, Oren-Nayar, specular reflection/transmission, Fresnel
specular, and GGX microfacet reflection/transmission, with the no-op,
dielectric and conductor Fresnel terms, in radiance or importance mode.
A lane's lobe table is a static tuple of slots sized by the scene's
materials (matte/mirror/metal 1, glass/plastic 2). The formula of every
kind a slot can hold runs on every lane and the kind code selects;
divisions are guarded so the unselected branches stay finite. Which
kinds a slot can hold is known on the host from the scene's materials
(``SlotKinds``, filled by ``materials.compute_scattering``): the JAX twin
runs every kind's branch, which XLA fuses, while here each branch costs
tensor launches, so branches no lane can select are skipped. That gives
the same values with fewer launches.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vec as V
from ..core.sync import device_constant
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

NONE = 0
LAMBERTIAN_REFLECTION = 1
LAMBERTIAN_TRANSMISSION = 2
SPECULAR_REFLECTION = 3
SPECULAR_TRANSMISSION = 4
FRESNEL_SPECULAR = 5
OREN_NAYAR = 6
MICROFACET_REFLECTION = 7
MICROFACET_TRANSMISSION = 8

# Flags by kind code, 0..8.
_FLAGS = (0, BSDF_REFLECTION | BSDF_DIFFUSE, BSDF_TRANSMISSION | BSDF_DIFFUSE,
          BSDF_REFLECTION | BSDF_SPECULAR, BSDF_TRANSMISSION | BSDF_SPECULAR,
          BSDF_REFLECTION | BSDF_TRANSMISSION | BSDF_SPECULAR,
          BSDF_REFLECTION | BSDF_DIFFUSE, BSDF_REFLECTION | BSDF_GLOSSY,
          BSDF_TRANSMISSION | BSDF_GLOSSY)

# Fresnel kinds (trace_tpu/bxdf/fresnel.py) and transport modes.
FRESNEL_NOOP = 0
FRESNEL_DIELECTRIC = 1
FRESNEL_CONDUCTOR = 2
RADIANCE = 0
IMPORTANCE = 1


class SlotKinds(NamedTuple):
    """The lobe kinds and Fresnel kinds one slot can hold (a superset of
    the codes in its tensors). The default is every kind."""
    lobes: frozenset = frozenset(range(len(_FLAGS)))
    fresnels: frozenset = frozenset((FRESNEL_NOOP, FRESNEL_DIELECTRIC,
                                     FRESNEL_CONDUCTOR))


ANY_KINDS = SlotKinds()


def union_kinds(kinds) -> SlotKinds:
    return SlotKinds(frozenset().union(*(k.lobes for k in kinds)),
                     frozenset().union(*(k.fresnels for k in kinds)))


def can_match(kinds: SlotKinds, type_flags: int) -> bool:
    """Whether any non-empty kind of ``kinds`` matches ``type_flags``."""
    return any(k != NONE and (_FLAGS[k] & type_flags) == _FLAGS[k]
               for k in kinds.lobes)


def lobe_flags(kind: torch.Tensor) -> torch.Tensor:
    # One table per device: building it per call would copy from the
    # host, and a host copy waits for the device to drain.
    return device_constant(_FLAGS, torch.int32, kind.device)[kind.long()]


def matches_flags(kind: torch.Tensor, type_flags: int) -> torch.Tensor:
    f = lobe_flags(kind)
    return (f & type_flags) == f


def roughness_to_alpha(roughness: torch.Tensor) -> torch.Tensor:
    """PBRT's roughness -> GGX alpha remap."""
    x = torch.log(roughness.clamp_min(1e-3))
    x2 = x * x
    return (1.62142 + 0.819955 * x + 0.1734 * x2 + 0.0171201 * (x2 * x)
            + 0.000640711 * (x2 * x2))


# ---------------------------------------------------------------------------
# Fresnel
# ---------------------------------------------------------------------------


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


def fresnel_conductor(cos_theta_i, eta: V3, k: V3) -> V3:
    """Conductor Fresnel reflectance with incident IOR 1, per channel."""
    cos_i = cos_theta_i.abs().clamp(-1.0, 1.0)
    cos2 = cos_i * cos_i
    sin2 = 1.0 - cos2

    def chan(e, kk):
        eta2 = e * e
        eta_k2 = kk * kk
        t0 = eta2 - eta_k2 - sin2
        a2b2 = torch.sqrt((t0 * t0 + 4.0 * eta2 * eta_k2).clamp_min(0.0))
        t1 = a2b2 + cos2
        a = torch.sqrt((0.5 * (a2b2 + t0)).clamp_min(0.0))
        t2 = 2.0 * a * cos_i
        rs = (t1 - t2) / torch.where(t1 + t2 == 0.0, 1.0, t1 + t2)
        t3 = cos2 * a2b2 + sin2 * sin2
        t4 = t2 * sin2
        rp = rs * (t3 - t4) / torch.where(t3 + t4 == 0.0, 1.0, t3 + t4)
        return 0.5 * (rp + rs)

    return V3(chan(eta.x, k.x), chan(eta.y, k.y), chan(eta.z, k.z))


def fresnel_eval(fr_kind, cos_theta_i, eta_a, eta_b, fr_eta: V3,
                 fr_k: V3, fresnels=ANY_KINDS.fresnels) -> V3:
    """No-op, dielectric or conductor Fresnel -> RGB V3 (``fresnels``:
    the kinds ``fr_kind`` can hold)."""
    one = torch.ones_like(cos_theta_i)
    out = V3(one, one, one)
    if FRESNEL_DIELECTRIC in fresnels:
        diel = fresnel_dielectric(cos_theta_i, eta_a, eta_b)
        out = V.where(fr_kind == FRESNEL_DIELECTRIC, V3(diel, diel, diel),
                      out)
    if FRESNEL_CONDUCTOR in fresnels:
        cond = fresnel_conductor(cos_theta_i, fr_eta, fr_k)
        out = V.where(fr_kind == FRESNEL_CONDUCTOR, cond, out)
    return out


# ---------------------------------------------------------------------------
# GGX (local-frame directions)
# ---------------------------------------------------------------------------


def _cos2_theta(w: V3):
    return w.z * w.z


def _tan2_theta(w: V3):
    return V.sin2_theta(w) / _cos2_theta(w)


def ggx_distribution(wh: V3, alpha_x, alpha_y):
    tan2 = _tan2_theta(wh)
    c2 = _cos2_theta(wh)
    cos4 = c2 * c2
    cp, sp = V.cos_phi(wh), V.sin_phi(wh)
    e = (cp * cp / (alpha_x * alpha_x).clamp_min(1e-12)
         + sp * sp / (alpha_y * alpha_y).clamp_min(1e-12)) * tan2
    e1 = 1.0 + e
    d = 1.0 / (V.PI * alpha_x * alpha_y * cos4 * (e1 * e1))
    return torch.where(torch.isfinite(tan2) & (cos4 > 1e-16), d, 0.0)


def _ggx_lambda(w: V3, alpha_x, alpha_y):
    abs_tan = (V.sin_theta(w) / V.cos_theta(w)).abs()
    cp, sp = V.cos_phi(w), V.sin_phi(w)
    alpha = torch.sqrt(cp * cp * (alpha_x * alpha_x)
                       + sp * sp * (alpha_y * alpha_y))
    at = alpha * abs_tan
    lam = (-1.0 + torch.sqrt(1.0 + at * at)) / 2.0
    return torch.where(torch.isfinite(abs_tan), lam, 0.0)


def ggx_g1(w: V3, alpha_x, alpha_y):
    return 1.0 / (1.0 + _ggx_lambda(w, alpha_x, alpha_y))


def ggx_g(wo: V3, wi: V3, alpha_x, alpha_y):
    return 1.0 / (1.0 + _ggx_lambda(wo, alpha_x, alpha_y)
                  + _ggx_lambda(wi, alpha_x, alpha_y))


def _sample11(cos_theta, u1, u2):
    """Slope-space visible-normal sample for alpha 1. Both branches run
    on every lane; the clamps (cos at 0.9998, tmp at 1e10) keep the
    general branch finite where the normal-incidence one is selected."""
    r_ni = torch.sqrt(u1 / (1.0 - u1).clamp_min(1e-12))
    phi_ni = 2.0 * V.PI * u2
    sx_ni = r_ni * torch.cos(phi_ni)
    sy_ni = r_ni * torch.sin(phi_ni)

    cos_t = cos_theta.clamp_max(0.9998)
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
    tan_t = sin_t / cos_t
    a = 1.0 / tan_t
    g1_ = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / (a * a)))

    A = 2.0 * u1 / g1_ - 1.0
    aa1 = A * A - 1.0
    tmp = (1.0 / torch.where(aa1 == 0.0, 1e-10, aa1)).clamp_max(1e10)
    B = tan_t
    D = torch.sqrt((B * B * tmp * tmp - (A * A - B * B) * tmp).clamp_min(0.0))
    sx1 = B * tmp - D
    sx2 = B * tmp + D
    slope_x = torch.where((A < 0.0) | (sx2 > 1.0 / tan_t), sx1, sx2)

    upper = u2 > 0.5
    s = torch.where(upper, 1.0, -1.0)
    u2r = torch.where(upper, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = (u2r * (u2r * (u2r * 0.27385 - 0.73369) + 0.46341)) / (
        u2r * (u2r * (u2r * 0.093073 + 0.309420) - 1.0) + 0.597999)
    slope_y = s * z * torch.sqrt(1.0 + slope_x * slope_x)

    ni = cos_theta > 0.9999
    return torch.where(ni, sx_ni, slope_x), torch.where(ni, sy_ni, slope_y)


def ggx_sample_wh(wo: V3, u0, u1, alpha_x, alpha_y) -> V3:
    """Visible microfacet normal for ``wo``."""
    flip = V.cos_theta(wo) < 0.0
    w = V.where(flip, -wo, wo)
    wi_s = V3(alpha_x * w.x, alpha_y * w.y, w.z).normalize()
    sx, sy = _sample11(V.cos_theta(wi_s), u0, u1)
    cp, sp = V.cos_phi(wi_s), V.sin_phi(wi_s)
    tmp = cp * sx - sp * sy
    sy = sp * sx + cp * sy
    sx = alpha_x * tmp
    sy = alpha_y * sy
    wh = V3(-sx, -sy, torch.ones_like(sx)).normalize()
    return V.where(flip, -wh, wh)


def ggx_pdf_wh(wo: V3, wh: V3, alpha_x, alpha_y):
    return (ggx_distribution(wh, alpha_x, alpha_y)
            * ggx_g1(wo, alpha_x, alpha_y) * wo.dot(wh).abs()
            / V.cos_theta(wo).abs().clamp_min(1e-12))


# ---------------------------------------------------------------------------
# Per-slot lobes
# ---------------------------------------------------------------------------


class LobeSlotP(NamedTuple):
    kind: torch.Tensor    # [N] i32
    c0: V3                # primary colour (R, or T for transmitters)
    c1: V3                # Fresnel-specular transmission colour
    eta_a: torch.Tensor
    eta_b: torch.Tensor
    a: torch.Tensor       # GGX alpha_x | Oren-Nayar A
    b: torch.Tensor       # GGX alpha_y | Oren-Nayar B
    fr_kind: torch.Tensor
    fr_eta: V3            # conductor Fresnel
    fr_k: V3


def empty_slot(n, device) -> LobeSlotP:
    z = torch.zeros((n,), dtype=F32, device=device)
    zi = torch.zeros((n,), dtype=torch.int32, device=device)
    z3 = V3.zeros((n,), device)
    return LobeSlotP(zi, z3, z3, z + 1.0, z + 1.0, z, z, zi, z3, z3)


class LobesP(NamedTuple):
    slots: tuple
    ng: V3
    ns: V3
    ss: V3
    ts: V3
    eta: torch.Tensor
    kinds: tuple = ()     # SlotKinds per slot; () means any kind


def slot_kinds(lo: LobesP) -> tuple:
    return lo.kinds or (ANY_KINDS,) * len(lo.slots)


def _safe_div(a, b, eps=1e-12):
    return a / torch.where(b.abs() < eps, 1.0, b)


def _z_up(like: torch.Tensor) -> V3:
    return V3.full(like.shape, 0.0, 0.0, 1.0, like.device)


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


def _f_microfacet_reflection(p: LobeSlotP, wo: V3, wi: V3,
                             fresnels) -> V3:
    cos_o = V.cos_theta(wo).abs()
    cos_i = V.cos_theta(wi).abs()
    wh = wi + wo
    degen = (cos_i < 1e-12) | (cos_o < 1e-12) | (wh.length_squared() < 1e-16)
    z_up = _z_up(wh.x)
    wh = V.where(degen, z_up, wh).normalize()
    wh_ff = V.face_forward(wh, z_up)
    f_val = fresnel_eval(p.fr_kind, wi.dot(wh_ff), p.eta_a, p.eta_b,
                         p.fr_eta, p.fr_k, fresnels)
    d = ggx_distribution(wh, p.a, p.b)
    g = ggx_g(wo, wi, p.a, p.b)
    spec = p.c0 * f_val * _safe_div(d * g, 4.0 * cos_i * cos_o)
    return V.where(degen, 0.0, spec)


def _f_microfacet_transmission(p: LobeSlotP, wo: V3, wi: V3, mode) -> V3:
    same = V.same_hemisphere(wo, wi)
    cos_o = V.cos_theta(wo)
    cos_i = V.cos_theta(wi)
    eta = torch.where(cos_o > 0.0, p.eta_b / p.eta_a, p.eta_a / p.eta_b)
    wh = wo + wi * eta
    degen = ((cos_i.abs() < 1e-12) | (cos_o.abs() < 1e-12)
             | (wh.length_squared() < 1e-16))
    wh = V.where(degen, _z_up(wh.x), wh).normalize()
    wh = V.where(V.cos_theta(wh) < 0.0, -wh, wh)
    same_side = wo.dot(wh) * wi.dot(wh) > 0.0
    f_diel = fresnel_dielectric(wo.dot(wh), p.eta_a, p.eta_b)
    sqrt_denom = wo.dot(wh) + eta * wi.dot(wh)
    factor = (1.0 / eta) if mode == RADIANCE else torch.ones_like(eta)
    d = ggx_distribution(wh, p.a, p.b)
    g = ggx_g(wo, wi, p.a, p.b)
    val = (1.0 - f_diel) * _safe_div(
        d * g * eta * eta * wi.dot(wh).abs() * wo.dot(wh).abs()
        * factor * factor,
        cos_i * cos_o * sqrt_denom * sqrt_denom).abs()
    return V.where(same | degen | same_side, 0.0, p.c0 * val)


def lobe_f(p: LobeSlotP, wo: V3, wi: V3, mode=RADIANCE,
           kinds: SlotKinds = ANY_KINDS) -> V3:
    """One slot's f(wo, wi); delta lobes give 0."""
    k = p.kind
    has = kinds.lobes
    out = V3.zeros(k.shape, k.device)
    if has & {LAMBERTIAN_REFLECTION, LAMBERTIAN_TRANSMISSION}:
        out = V.where((k == LAMBERTIAN_REFLECTION)
                      | (k == LAMBERTIAN_TRANSMISSION), p.c0 * V.INV_PI, out)
    if OREN_NAYAR in has:
        out = V.where(k == OREN_NAYAR, _f_oren_nayar(p, wo, wi), out)
    if MICROFACET_REFLECTION in has:
        out = V.where(k == MICROFACET_REFLECTION,
                      _f_microfacet_reflection(p, wo, wi, kinds.fresnels),
                      out)
    if MICROFACET_TRANSMISSION in has:
        out = V.where(k == MICROFACET_TRANSMISSION,
                      _f_microfacet_transmission(p, wo, wi, mode), out)
    return out


def lobe_pdf(p: LobeSlotP, wo: V3, wi: V3, kinds: SlotKinds = ANY_KINDS):
    k = p.kind
    has = kinds.lobes
    same = V.same_hemisphere(wo, wi)
    out = torch.zeros(k.shape, dtype=F32, device=k.device)
    if has & {LAMBERTIAN_REFLECTION, OREN_NAYAR, LAMBERTIAN_TRANSMISSION}:
        cos_pdf = V.cos_theta(wi).abs() * V.INV_PI
        diffuse_r = (k == LAMBERTIAN_REFLECTION) | (k == OREN_NAYAR)
        out = torch.where(diffuse_r & same, cos_pdf, out)
        out = torch.where((k == LAMBERTIAN_TRANSMISSION) & ~same, cos_pdf,
                          out)
    if not has & {MICROFACET_REFLECTION, MICROFACET_TRANSMISSION}:
        return out

    z_up = _z_up(k)
    if MICROFACET_REFLECTION in has:
        wh_r = wo + wi
        wh_r_ok = wh_r.length_squared() > 1e-16
        wh_rn = V.where(wh_r_ok, wh_r, z_up).normalize()
        pdf_mr = _safe_div(ggx_pdf_wh(wo, wh_rn, p.a, p.b),
                           4.0 * wo.dot(wh_rn))
        out = torch.where((k == MICROFACET_REFLECTION) & same & wh_r_ok,
                          pdf_mr, out)
    if MICROFACET_TRANSMISSION not in has:
        return out

    eta = torch.where(V.cos_theta(wo) > 0.0, p.eta_b / p.eta_a,
                      p.eta_a / p.eta_b)
    wh_t = wo + wi * eta
    wh_t_ok = wh_t.length_squared() > 1e-16
    wh_tn = V.where(wh_t_ok, wh_t, z_up).normalize()
    same_side = wo.dot(wh_tn) * wi.dot(wh_tn) > 0.0
    sqrt_denom = wo.dot(wh_tn) + eta * wi.dot(wh_tn)
    dwh_dwi = _safe_div(eta * eta * wi.dot(wh_tn),
                        sqrt_denom * sqrt_denom).abs()
    pdf_mt = ggx_pdf_wh(wo, wh_tn, p.a, p.b) * dwh_dwi
    return torch.where(
        (k == MICROFACET_TRANSMISSION) & ~same & wh_t_ok & ~same_side,
        pdf_mt, out)


class LobeSampleP(NamedTuple):
    wi: V3
    f: V3
    pdf: torch.Tensor
    sampled_flags: torch.Tensor


def lobe_sample(p: LobeSlotP, wo: V3, u0, u1, mode=RADIANCE,
                kinds: SlotKinds = ANY_KINDS) -> LobeSampleP:
    """Sample one slot per lane."""
    k = p.kind
    has = kinds.lobes
    zf = torch.zeros(k.shape, dtype=F32, device=k.device)
    sampled = lobe_flags(k)
    # (kind, value) of each branch that runs; the kinds are disjoint, so
    # the order of the selects does not matter.
    wi_of, f_of, pdf_of = [], [], []
    fail = k == NONE
    entering = V.cos_theta(wo) > 0.0

    if has & {LAMBERTIAN_REFLECTION, OREN_NAYAR, LAMBERTIAN_TRANSMISSION}:
        wi_cos = V.cosine_sample_hemisphere(u0, u1)
        neg = V.cos_theta(wo) < 0.0
        wi_refl = V3(wi_cos.x, wi_cos.y,
                     torch.where(neg, -wi_cos.z, wi_cos.z))
        wi_of += [(LAMBERTIAN_REFLECTION, wi_refl), (OREN_NAYAR, wi_refl),
                  (LAMBERTIAN_TRANSMISSION, -wi_refl)]

    wi_sr = V3(-wo.x, -wo.y, wo.z)
    cos_sr = V.cos_theta(wi_sr)
    if SPECULAR_REFLECTION in has:
        f_sr = (fresnel_eval(p.fr_kind, cos_sr, p.eta_a, p.eta_b, p.fr_eta,
                             p.fr_k, kinds.fresnels)
                * p.c0 * (1.0 / cos_sr.abs().clamp_min(1e-12)))
        wi_of.append((SPECULAR_REFLECTION, wi_sr))
        f_of.append((SPECULAR_REFLECTION, f_sr))
        pdf_of.append((SPECULAR_REFLECTION, torch.ones_like(zf)))

    if has & {SPECULAR_TRANSMISSION, FRESNEL_SPECULAR}:
        eta_i = torch.where(entering, p.eta_a, p.eta_b)
        eta_t = torch.where(entering, p.eta_b, p.eta_a)
        sgn = torch.where(entering, 1.0, -1.0)
        refr_ok, wi_st = V.refract(wo, V3(zf, zf, sgn), eta_i / eta_t)
        cos_st = V.cos_theta(wi_st)
        if mode == RADIANCE:
            r = eta_i / eta_t
            eta_scale = r * r
        else:
            eta_scale = torch.ones_like(eta_i)
    if SPECULAR_TRANSMISSION in has:
        fr_st = fresnel_dielectric(cos_st, p.eta_a, p.eta_b)
        f_st = p.c0 * ((1.0 - fr_st) * eta_scale
                       / cos_st.abs().clamp_min(1e-12))
        wi_of.append((SPECULAR_TRANSMISSION, wi_st))
        f_of.append((SPECULAR_TRANSMISSION, V.where(refr_ok, f_st, 0.0)))
        pdf_of.append((SPECULAR_TRANSMISSION,
                       torch.where(refr_ok, 1.0, 0.0)))
        fail = fail | ((k == SPECULAR_TRANSMISSION) & ~refr_ok)
    if FRESNEL_SPECULAR in has:
        fr_coin = fresnel_dielectric(V.cos_theta(wo), p.eta_a, p.eta_b)
        take_refl = u0 < fr_coin
        f_fs_r = p.c0 * (fr_coin / cos_sr.abs().clamp_min(1e-12))
        f_fs_t = p.c1 * ((1.0 - fr_coin) * eta_scale
                         / cos_st.abs().clamp_min(1e-12))
        f_fs_t = V.where(refr_ok, f_fs_t, 0.0)
        wi_of.append((FRESNEL_SPECULAR, V.where(take_refl, wi_sr, wi_st)))
        f_of.append((FRESNEL_SPECULAR, V.where(take_refl, f_fs_r, f_fs_t)))
        pdf_of.append((FRESNEL_SPECULAR,
                       torch.where(take_refl, fr_coin, 1.0 - fr_coin)))
        flags_fs = torch.where(take_refl, BSDF_SPECULAR | BSDF_REFLECTION,
                               BSDF_SPECULAR | BSDF_TRANSMISSION
                               ).to(torch.int32)
        sampled = torch.where(k == FRESNEL_SPECULAR, flags_fs, sampled)

    if has & {MICROFACET_REFLECTION, MICROFACET_TRANSMISSION}:
        wh = ggx_sample_wh(wo, u0, u1, p.a, p.b)
        wo_dot_wh = wo.dot(wh)
        wo_ok = V.cos_theta(wo).abs() > 1e-12
    if MICROFACET_REFLECTION in has:
        wi_mr = -wo + wh * (2.0 * wo_dot_wh)
        mr_ok = (wo_dot_wh > 0.0) & V.same_hemisphere(wo, wi_mr) & wo_ok
        pdf_mr = _safe_div(ggx_pdf_wh(wo, wh, p.a, p.b), 4.0 * wo_dot_wh)
        wi_of.append((MICROFACET_REFLECTION, wi_mr))
        pdf_of.append((MICROFACET_REFLECTION, torch.where(mr_ok, pdf_mr, 0.0)))
        fail = fail | ((k == MICROFACET_REFLECTION) & ~mr_ok)
    if MICROFACET_TRANSMISSION in has:
        eta_refr = torch.where(entering, p.eta_a / p.eta_b,
                               p.eta_b / p.eta_a)
        mt_ok0, wi_mt = V.refract(wo, V.face_forward(wh, wo), eta_refr)
        mt_ok = (mt_ok0 & (wo_dot_wh > 0.0) & ~V.same_hemisphere(wo, wi_mt)
                 & wo_ok)
        wi_of.append((MICROFACET_TRANSMISSION, wi_mt))
        fail = fail | ((k == MICROFACET_TRANSMISSION) & ~mt_ok)

    wi = V3(zf, zf, zf + 1.0)
    for kk, vv in wi_of:
        wi = V.where(k == kk, vv, wi)
    f_out = lobe_f(p, wo, wi, mode, kinds)
    for kk, vv in f_of:
        f_out = V.where(k == kk, vv, f_out)
    pdf_out = lobe_pdf(p, wo, wi, kinds)
    for kk, vv in pdf_of:
        pdf_out = torch.where(k == kk, vv, pdf_out)

    f_out = V.where(fail, 0.0, f_out)
    pdf_out = torch.where(fail, 0.0, pdf_out)
    return LobeSampleP(wi, f_out, pdf_out, sampled)


# ---------------------------------------------------------------------------
# BSDF aggregate (static slot loop)
# ---------------------------------------------------------------------------


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
    """Per slot: (index, slot, lanes whose lobe matches ``flags``, its
    kinds), for the slots that hold a kind that can match."""
    return [(i, s, matches_flags(s.kind, flags) & (s.kind != NONE), kk)
            for i, (s, kk) in enumerate(zip(lo.slots, slot_kinds(lo)))
            if can_match(kk, flags)]


def _refl_trans_mask(lo: LobesP, slot: LobeSlotP, wo_w: V3, wi_w: V3):
    reflect = (wi_w.dot(lo.ng) * wo_w.dot(lo.ng)) > 0.0
    fl = lobe_flags(slot.kind)
    return torch.where(reflect, (fl & BSDF_REFLECTION) != 0,
                       (fl & BSDF_TRANSMISSION) != 0)


def f(lo: LobesP, wo_w: V3, wi_w: V3, flags: int = BSDF_ALL,
      mode=RADIANCE) -> V3:
    """Sum of f over the matching lobes."""
    wo = world_to_local(lo, wo_w)
    wi = world_to_local(lo, wi_w)
    degenerate = wo.z.abs() < 1e-12
    total = V3.zeros(wo.z.shape, wo.z.device)
    for _, s, ms, kk in _matching(lo, flags):
        msk = ms & _refl_trans_mask(lo, s, wo_w, wi_w)
        total = total + V.where(msk, lobe_f(s, wo, wi, mode, kk), 0.0)
    return V.where(degenerate, 0.0, total)


def compute_pdf(lo: LobesP, wo_w: V3, wi_w: V3, flags: int = BSDF_ALL):
    """Mean pdf over the matching lobes."""
    wo = world_to_local(lo, wo_w)
    wi = world_to_local(lo, wi_w)
    total = torch.zeros(wo.z.shape, dtype=F32, device=wo.z.device)
    count = torch.zeros(wo.z.shape, dtype=torch.int32, device=wo.z.device)
    for _, s, ms, kk in _matching(lo, flags):
        total = total + torch.where(ms, lobe_pdf(s, wo, wi, kk), 0.0)
        count = count + ms.to(torch.int32)
    pdf = torch.where(count > 0, total / count.clamp_min(1), 0.0)
    return torch.where(wo.z.abs() < 1e-12, 0.0, pdf)


class BSDFSampleP(NamedTuple):
    wi: V3
    f: V3
    pdf: torch.Tensor
    sampled_flags: torch.Tensor


def sample_f(lo: LobesP, wo_w: V3, u0, u1, flags: int = BSDF_ALL,
             mode=RADIANCE) -> BSDFSampleP:
    """Uniform pick among matching lobes (``u0`` remapped within the
    pick); pdf averaging and f summing across matching non-specular
    lobes."""
    match = _matching(lo, flags)
    count = torch.zeros(u0.shape, dtype=torch.int32, device=u0.device)
    for _, _, ms, _ in match:
        count = count + ms.to(torch.int32)
    any_match = count > 0
    comp = torch.minimum(torch.floor(u0 * count.to(F32)).to(torch.int32),
                         (count - 1).clamp_min(0))
    is_chosen = []
    rank = torch.zeros(u0.shape, dtype=torch.int32, device=u0.device) - 1
    seen = torch.zeros(u0.shape, dtype=torch.bool, device=u0.device)
    for _, _, ms, _ in match:
        rank = rank + ms.to(torch.int32)
        ch = ms & (rank == comp) & ~seen
        is_chosen.append(ch)
        seen = seen | ch

    u0r = (u0 * count.to(F32) - comp.to(F32)).clamp_max(1.0 - 1e-6)
    wo = world_to_local(lo, wo_w)
    degenerate = wo.z.abs() < 1e-12
    # Lanes that choose no slot take slot 0's lobe.
    chosen = lo.slots[0]
    for (i, s, _, _), ch in zip(match, is_chosen):
        if i > 0:
            chosen = LobeSlotP(*[V.where(ch, a, b) if isinstance(a, V3)
                                 else torch.where(ch, a, b)
                                 for a, b in zip(s, chosen)])
    kinds = union_kinds([slot_kinds(lo)[0]] + [kk for *_, kk in match])
    ls = lobe_sample(chosen, wo, u0r, u1, mode, kinds)
    wi = ls.wi
    wi_w = local_to_world(lo, wi)

    specular = (ls.sampled_flags & BSDF_SPECULAR) != 0
    multi = count > 1
    pdf_others = torch.zeros(u0.shape, dtype=F32, device=u0.device)
    for (_, s, ms, kk), ch in zip(match, is_chosen):
        pdf_others = pdf_others + torch.where(ms & ~ch,
                                              lobe_pdf(s, wo, wi, kk), 0.0)
    pdf = ls.pdf + torch.where(~specular & multi, pdf_others, 0.0)
    pdf = torch.where(multi, pdf / count.clamp_min(1), pdf)

    f_sum = V3.zeros(u0.shape, u0.device)
    for _, s, ms, kk in match:
        msk = ms & _refl_trans_mask(lo, s, wo_w, wi_w)
        f_sum = f_sum + V.where(msk, lobe_f(s, wo, wi, mode, kk), 0.0)
    f_out = V.where(specular, ls.f, f_sum)

    ok = any_match & ~degenerate & (pdf > 0.0)
    return BSDFSampleP(wi=wi_w, f=V.where(ok, f_out, 0.0),
                       pdf=torch.where(ok, pdf, 0.0),
                       sampled_flags=torch.where(ok, ls.sampled_flags, 0))
