"""Path-traced frame of the Cornell box, from its description and the seed
alone: pbrt-v3's PathIntegrator (§14.5) with next-event estimation, one
light picked uniformly, both legs weighted by Veach's power heuristic
(§13.10), Russian roulette after ``rr_depth`` bounces with the 1 / (1 - q)
reweight, Lambertian walls and plastic as Lambertian plus a
Trowbridge-Reitz microfacet coat (Trace.jl's ``microfacet.jl``:
``roughness_to_α``, visible-normal sampling), whose dielectric Fresnel
term takes the indices in pbrt-v3's and Trace.jl's order (1.5, 1); area
lights sampled by area through their triangles' CDF (§12.5, §14.2); the
film's splat of film.py. Lanes are shaded in float64 (box.py's hits).

The draws are the program's: per sample pass s, the lane key is the
pixel folded into fold(key(seed), s); fold 0 of it gives the camera
sample (5 uniforms) and fold 1 the path's key, into which each bounce
folds its number; under that, fold 0 gives next-event estimation's row
(light pick, the light's 2, the BSDF's 2), fold 1 the continuation's 2
and fold 2 roulette's 1. So a path takes the program's random decisions
and the comparison measures the arithmetic, not the noise.

Departures from pbrt-v3 and Trace.jl, each the program's rule:

- a BSDF of two lobes picks one by the first uniform and reuses it,
  rescaled and capped at 1 - 1e-6; a failed microfacet sample keeps its
  direction, with the other lobe's pdf (pbrt returns no sample);
- roulette's q is max(1 - Y(beta), 0.05), with Y the luminance of the
  throughput after the bounce's BSDF sample (pbrt-v3 uses the max
  component);
- a shadow ray leaves p + 1e-6 (p_light - p) nudged along the normal by
  1e-4 max(max|p|, 1) to the light's side, and ends at t = 1 - 1e-4; the
  BSDF-sampling leg's ray leaves p + 1e-6 wi nudged the same way;
- a continuation leaves p nudged along the geometric normal to wi's side
  by 2^-18 max(max|p|, 1) (pbrt's OffsetRayOrigin, sized for float32);
- emission is counted where a camera ray hits a light: the box has no
  specular lobe, so every later light is the estimators'.

One difference is not the program's arithmetic but where it is read: a
camera ray within float32's resolution of the light's outline may see
the light in one renderer and the ceiling in the other, one lane off by
the light's radiance. ``render`` marks the pixels such lanes splat into
(``ambiguous``), and ``checks`` compares the rest.
"""
from __future__ import annotations

import numpy as np
import torch

from . import camera as C
from . import compare
from . import film as FILM
from . import rng
from .box import F64, Box

SPAWN_EPS = float(np.float32(1e-6))
SHADOW_T_MAX = float(np.float32(1.0 - 1e-4))
SPAWN_OFFSET = 2.0 ** -18
U_MAX = float(np.float32(1.0 - 1e-6))     # a lobe pick's rescaled uniform
# The program's float32 camera ray leaves within 1.6e-7 radians of the
# float64 one (per component at most 9.1e-8, every lane of a 512² pass;
# the origins are equal); four turns of 3e-7 along two axes cover that.
CAMERA_EPS = 3e-7
PI = np.pi


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(v):
    n = v.norm(dim=-1, keepdim=True)
    return v / torch.where(n == 0, 1.0, n)


def to_y(c):
    return 0.212671 * c[:, 0] + 0.715160 * c[:, 1] + 0.072169 * c[:, 2]


def power_heuristic(f, g):
    f2, g2 = f * f, g * g
    return torch.where(f2 + g2 > 0, f2 / (f2 + g2), 0.0)


def roughness_to_alpha(r: float) -> float:
    """pbrt-v3's (and Trace.jl's) roughness -> Trowbridge-Reitz alpha."""
    x = np.log(max(r, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x ** 2 + 0.0171201 * x ** 3
            + 0.000640711 * x ** 4)


# -- the lobes, in the shading frame (z the normal) ----------------------

def concentric_disk(u0, u1):
    ox, oy = 2.0 * u0 - 1.0, 2.0 * u1 - 1.0
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    th = torch.where(use_x, (oy / torch.where(ox == 0, 1.0, ox)) * PI / 4,
                     PI / 2 - (ox / torch.where(oy == 0, 1.0, oy)) * PI / 4)
    zero = (ox == 0) & (oy == 0)
    return (torch.where(zero, 0.0, r * th.cos()),
            torch.where(zero, 0.0, r * th.sin()))


def tan2(w):
    c2 = w[:, 2] ** 2
    return (1.0 - c2).clamp_min(0.0) / c2


def ggx_d(wh, a):
    t2 = tan2(wh)
    c4 = wh[:, 2] ** 4
    e = 1.0 + t2 / (a * a)
    d = 1.0 / (PI * a * a * c4 * e * e)
    return torch.where(torch.isfinite(t2) & (c4 > 1e-16), d, 0.0)


def ggx_lambda(w, a):
    at2 = a * a * tan2(w)
    return torch.where(torch.isfinite(at2),
                       (-1.0 + (1.0 + at2).sqrt()) / 2.0, 0.0)


def fresnel_dielectric(cos_i, eta_i: float, eta_t: float):
    cos_i = cos_i.clamp(-1.0, 1.0)
    ent = cos_i > 0
    ei = torch.where(ent, eta_i, eta_t)
    et = torch.where(ent, eta_t, eta_i)
    cos_i = cos_i.abs()
    sin_t = ei / et * (1.0 - cos_i * cos_i).clamp_min(0.0).sqrt()
    cos_t = (1.0 - sin_t * sin_t).clamp_min(0.0).sqrt()
    r_par = (et * cos_i - ei * cos_t) / (et * cos_i + ei * cos_t)
    r_perp = (ei * cos_i - et * cos_t) / (ei * cos_i + et * cos_t)
    return torch.where(sin_t >= 1.0, 1.0,
                       0.5 * (r_par * r_par + r_perp * r_perp))


def microfacet_f(ks, a, wo, wi):
    """Trace.jl's MicrofacetReflection with the coat's Fresnel term."""
    co, ci = wo[:, 2].abs(), wi[:, 2].abs()
    wh = wi + wo
    degen = (ci < 1e-12) | (co < 1e-12) | (_dot(wh, wh) < 1e-16)
    wh = _unit(wh)
    wh_up = torch.where((wh[:, 2] < 0)[:, None], -wh, wh)
    fr = fresnel_dielectric(_dot(wi, wh_up), 1.5, 1.0)
    g = 1.0 / (1.0 + ggx_lambda(wo, a) + ggx_lambda(wi, a))
    v = fr * ggx_d(wh, a) * g / (4.0 * ci * co)
    return torch.where(degen[:, None], 0.0, ks * v[:, None])


def microfacet_pdf_wh(wo, wh, a):
    g1 = 1.0 / (1.0 + ggx_lambda(wo, a))
    return (ggx_d(wh, a) * g1 * _dot(wo, wh).abs()
            / wo[:, 2].abs().clamp_min(1e-12))


def microfacet_pdf(wo, wi, a):
    wh = wo + wi
    ok = (wo[:, 2] * wi[:, 2] > 0) & (_dot(wh, wh) > 1e-16)
    wh = _unit(wh)
    den = 4.0 * _dot(wo, wh)
    den = torch.where(den.abs() < 1e-12, 1.0, den)
    return torch.where(ok, microfacet_pdf_wh(wo, wh, a) / den, 0.0)


def sample11(cos_t, u1, u2):
    """pbrt-v3's TrowbridgeReitzSample11: a slope of the visible normals
    for alpha 1 seen at cos_t."""
    r = (u1 / (1.0 - u1).clamp_min(1e-12)).sqrt()
    phi = 2.0 * PI * u2
    ni = (r * phi.cos(), r * phi.sin())
    c = cos_t.clamp_max(0.9998)
    tan_t = (1.0 - c * c).clamp_min(0.0).sqrt() / c
    g1 = 2.0 / (1.0 + (1.0 + tan_t * tan_t).sqrt())
    A = 2.0 * u1 / g1 - 1.0
    aa1 = A * A - 1.0
    tmp = (1.0 / torch.where(aa1 == 0, 1e-10, aa1)).clamp_max(1e10)
    B = tan_t
    D = (B * B * tmp * tmp - (A * A - B * B) * tmp).clamp_min(0.0).sqrt()
    sx1, sx2 = B * tmp - D, B * tmp + D
    sx = torch.where((A < 0) | (sx2 > 1.0 / tan_t), sx1, sx2)
    up = u2 > 0.5
    s = torch.where(up, 1.0, -1.0)
    u = torch.where(up, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = ((u * (u * (u * 0.27385 - 0.73369) + 0.46341))
         / (u * (u * (u * 0.093073 + 0.309420) - 1.0) + 0.597999))
    sy = s * z * (1.0 + sx * sx).sqrt()
    use_ni = cos_t > 0.9999
    return torch.where(use_ni, ni[0], sx), torch.where(use_ni, ni[1], sy)


def sample_wh(wo, u0, u1, a):
    """A visible microfacet normal for wo (pbrt-v3 §8.4.3)."""
    flip = wo[:, 2] < 0
    w = torch.where(flip[:, None], -wo, wo)
    ws = _unit(torch.stack([a * w[:, 0], a * w[:, 1], w[:, 2]], 1))
    sx, sy = sample11(ws[:, 2], u0, u1)
    st = (1.0 - ws[:, 2] ** 2).clamp_min(0.0).sqrt()
    small = st == 0
    cp = torch.where(small, 1.0, (ws[:, 0] / torch.where(small, 1.0, st))
                     .clamp(-1.0, 1.0))
    sp = torch.where(small, 0.0, (ws[:, 1] / torch.where(small, 1.0, st))
                     .clamp(-1.0, 1.0))
    sx, sy = a * (cp * sx - sp * sy), a * (sp * sx + cp * sy)
    wh = _unit(torch.stack([-sx, -sy, torch.ones_like(sx)], 1))
    return torch.where(flip[:, None], -wh, wh)


class Bsdf:
    """The lobes at each lane's hit: a Lambertian lobe (Kd) and, on
    plastic, the microfacet coat (Ks, alpha); each present where its
    colour is not black. ``n``, ``s``, ``t``: the shading frame."""

    def __init__(self, box: Box, prim, n, s, t):
        dev = box.dev
        mats = box.materials
        kd = torch.tensor([m["Kd"] for m in mats], dtype=torch.float32)
        ks = torch.tensor([m.get("Ks", [0.0] * 3) for m in mats],
                          dtype=torch.float32)
        al = torch.tensor([roughness_to_alpha(float(np.float32(
            m.get("roughness", 1.0)))) for m in mats], dtype=F64)
        mat = box.mat[prim]
        self.kd = kd.to(F64).to(dev)[mat]
        self.ks = ks.to(F64).to(dev)[mat]
        self.a = al.to(dev)[mat]
        self.has_d = (self.kd != 0).any(1)
        self.has_g = (self.ks != 0).any(1)
        self.count = self.has_d.to(F64) + self.has_g.to(F64)
        self.n, self.s, self.t = n, s, t

    def local(self, w):
        return torch.stack([_dot(w, self.s), _dot(w, self.t),
                            _dot(w, self.n)], 1)

    def world(self, w):
        return (self.s * w[:, :1] + self.t * w[:, 1:2] + self.n * w[:, 2:])

    def _pdfs(self, wo, wi):
        pd = torch.where(wo[:, 2] * wi[:, 2] > 0, wi[:, 2].abs() / PI, 0.0)
        return (torch.where(self.has_d, pd, 0.0),
                torch.where(self.has_g, microfacet_pdf(wo, wi, self.a), 0.0))

    def f(self, wo_w, wi_w):
        """Sum of the lobes' f, each where wo and wi lie on one side of the
        geometric normal (the lobes reflect)."""
        wo, wi = self.local(wo_w), self.local(wi_w)
        refl = (_dot(wi_w, self.n) * _dot(wo_w, self.n) > 0)[:, None]
        f = (torch.where(self.has_d[:, None], self.kd / PI, 0.0)
             + torch.where(self.has_g[:, None],
                           microfacet_f(self.ks, self.a, wo, wi), 0.0))
        return torch.where(refl & (wo[:, 2].abs() >= 1e-12)[:, None], f, 0.0)

    def pdf(self, wo_w, wi_w):
        """Mean of the lobes' pdfs."""
        wo, wi = self.local(wo_w), self.local(wi_w)
        pd, pg = self._pdfs(wo, wi)
        p = (pd + pg) / self.count.clamp_min(1.0)
        return torch.where((self.count > 0) & (wo[:, 2].abs() >= 1e-12), p,
                           0.0)

    def sample(self, wo_w, u0, u1):
        """-> (wi world, f [N, 3], pdf [N]): one lobe picked by u0."""
        wo = self.local(wo_w)
        cnt = self.count
        comp = torch.minimum((u0 * cnt).floor(), (cnt - 1).clamp_min(0))
        u0r = (u0 * cnt - comp).clamp_max(U_MAX)
        use_g = self.has_g & ~(self.has_d & (comp == 0))
        dx, dy = concentric_disk(u0r, u1)
        dz = (1.0 - dx * dx - dy * dy).clamp_min(0.0).sqrt()
        wi_d = torch.stack([dx, dy, torch.where(wo[:, 2] < 0, -dz, dz)], 1)
        wh = sample_wh(wo, u0r, u1, self.a)
        wo_wh = _dot(wo, wh)
        wi_g = -wo + wh * (2.0 * wo_wh)[:, None]
        g_ok = (wo_wh > 0) & (wo[:, 2] * wi_g[:, 2] > 0) & \
            (wo[:, 2].abs() > 1e-12)
        wi = torch.where(use_g[:, None], wi_g, wi_d)
        pd, pg = self._pdfs(wo, wi)
        # The picked lobe's pdf; a failed microfacet sample has none.
        pg_own = torch.where(g_ok, pg, 0.0)
        pdf = torch.where(use_g, pg_own + pd, pd + pg) / cnt.clamp_min(1.0)
        wi_w = self.world(wi)
        f = self.f(wo_w, wi_w)
        ok = (cnt > 0) & (wo[:, 2].abs() >= 1e-12) & (pdf > 0)
        return (wi_w, torch.where(ok[:, None], f, 0.0),
                torch.where(ok, pdf, 0.0))


# -- the estimators ------------------------------------------------------

def _nudge(p, n, d, scale):
    side = torch.sign(_dot(n, d))
    return p + n * (scale * side)[:, None]


def _scale(p, k):
    return k * p.abs().amax(-1).clamp_min(1.0)


def direct(box: Box, p, n, wo, bsdf: Bsdf, u):
    """Next-event estimation at hits p (normal n, toward the eye wo) with
    the uniform row u [N, 5]: one light picked uniformly, its sample and
    the BSDF's, each weighted by the power heuristic; over the pick's
    probability."""
    nl = len(box.lights)
    pick = (u[:, 0] * nl).floor().clamp_max(nl - 1).long()
    ld = torch.zeros_like(p)
    wi_b, f_b, pdf_b = bsdf.sample(wo, u[:, 3], u[:, 4])
    f_b = f_b * _dot(wi_b, n).abs()[:, None]
    for j in range(nl):
        sel = pick == j
        le, wi, pdf_l, pa = box.sample_light(j, p, u[:, 1], u[:, 2])
        f = bsdf.f(wo, wi) * _dot(wi, n).abs()[:, None]
        pdf_s = bsdf.pdf(wo, wi)
        ok = (sel & (pdf_l > 0) & (le != 0).any(1) & (f != 0).any(1))
        ds = pa - p
        o_s = _nudge(p + ds * SPAWN_EPS, n, ds, _scale(p, 1e-4))
        t_max = torch.full_like(pdf_l, SHADOW_T_MAX)
        vis = ok.clone()
        if ok.any():
            vis[ok] = ~box.occluded(o_s[ok], ds[ok], t_max[ok])
        w = power_heuristic(pdf_l, pdf_s)
        ld = ld + torch.where(vis[:, None], f * le * (w / pdf_l.clamp_min(
            1e-300))[:, None], 0.0)

        # The BSDF-sampling leg: counts where it meets light j.
        go = sel & (pdf_b > 0) & (f_b != 0).any(1)
        if not go.any():
            continue
        g = go.nonzero()[:, 0]
        o2 = _nudge(p[g] + wi_b[g] * SPAWN_EPS, n[g], wi_b[g],
                    _scale(p[g], 1e-4))
        t2, prim2 = box.closest(o2, wi_b[g])
        on = box.light_of(prim2) == j
        n2 = box.tri_n[prim2.clamp(0, box.n_tris - 1)]
        cos_l = -_dot(n2, wi_b[g])
        lt = box.lights[j]
        li_pdf = torch.where(cos_l.abs() > 1e-9, t2 * t2 / (
            cos_l.abs() * lt["area"]).clamp_min(1e-20), 0.0)
        li_pdf = torch.where(on, li_pdf, 0.0)
        le_b = torch.where((on & (cos_l > 0))[:, None], lt["le"][None], 0.0)
        w_b = power_heuristic(pdf_b[g], li_pdf)
        ld[g] = ld[g] + f_b[g] * le_b * (w_b / pdf_b[g])[:, None]
    return ld * nl


def _uniforms(keys, cols: int, dev):
    return torch.from_numpy(rng.uniforms(keys, cols)).to(dev)


def radiance(box: Box, o, d, keys, max_depth: int, rr_depth: int):
    """[N, 3] float64 radiance of camera rays o, d [N, 3] with the paths'
    keys (two uint32 arrays [N])."""
    dev = box.dev
    n = o.shape[0]
    L = torch.zeros((n, 3), dtype=F64, device=dev)
    beta = torch.ones((n, 3), dtype=F64, device=dev)
    lane = np.arange(n)
    for bounce in range(max_depth):
        kb = rng.fold_in((keys[0][lane], keys[1][lane]), bounce)
        t, prim = box.closest(o, d)
        hit = (prim >= 0).cpu().numpy()
        o, d, beta, t, prim = o[hit], d[hit], beta[hit], t[hit], prim[hit]
        lane, kb = lane[hit], (kb[0][hit], kb[1][hit])
        if not lane.size:
            break
        li = torch.from_numpy(lane).to(dev)
        p = o + d * t[:, None]
        nrm, s, tt = box.frame(prim, p)
        wo = -d
        if bounce == 0:
            light = box.light_of(prim)
            emits = (light >= 0) & (_dot(nrm, wo) > 0)
            for j, lt in enumerate(box.lights):
                L[li] += torch.where((emits & (light == j))[:, None],
                                     beta * lt["le"][None], 0.0)
        bsdf = Bsdf(box, prim, nrm, s, tt)
        u = _uniforms(rng.fold_in(kb, 0), 5, dev)
        L[li] += beta * direct(box, p, nrm, wo, bsdf, u)
        if bounce == max_depth - 1:
            break
        u = _uniforms(rng.fold_in(kb, 1), 2, dev)
        wi, f, pdf = bsdf.sample(wo, u[:, 0], u[:, 1])
        ok = (pdf > 0) & (f != 0).any(1)
        beta = beta * f * (_dot(wi, nrm).abs() / pdf.clamp_min(1e-300))[:,
                                                                          None]
        if bounce >= rr_depth:
            q = (1.0 - to_y(beta)).clamp_min(0.05)
            u_rr = _uniforms(rng.fold_in(kb, 2), 1, dev)[:, 0]
            ok = ok & (u_rr >= q)
            beta = beta / (1.0 - q).clamp_min(1e-6)[:, None]
        keep = ok.cpu().numpy()
        side = torch.where(_dot(nrm, wi) < 0, -1.0, 1.0)
        o = p + nrm * (_scale(p, SPAWN_OFFSET) * side)[:, None]
        o, d, beta, lane = o[keep], wi[keep], beta[keep], lane[keep]
        if not lane.size:
            break
    return torch.where(torch.isfinite(L), L, 0.0).clamp_min(0.0)


def emitting(box: Box, o, d):
    """Whether each ray's first hit is a light's emitting side."""
    _, prim = box.closest(o, d)
    n = box.tri_n[prim.clamp(0, box.n_tris - 1)]
    return (box.light_of(prim) >= 0) & (_dot(n, d) < 0)


def ambiguous(box: Box, o, d, eps: float = CAMERA_EPS):
    """Camera rays [N] that see a light's emitting side and lose it, or
    gain it, when their direction turns by ``eps`` radians along either
    of two axes normal to it: the program's float32 ray may fall on
    either side, and the lane's radiance jumps by the light's (17)."""
    axis = torch.zeros_like(d)
    axis[:, 0] = torch.where(d[:, 0].abs() < 0.9, 1.0, 0.0)
    axis[:, 1] = 1.0 - axis[:, 0]
    u1 = _unit(torch.linalg.cross(d, axis, dim=-1))
    u2 = torch.linalg.cross(d, u1, dim=-1)
    e0 = emitting(box, o, d)
    out = torch.zeros_like(e0)
    for u in (u1, -u1, u2, -u2):
        out |= emitting(box, o, _unit(d + eps * u)) != e0
    return out


def footprint_mask(p_film, resolution: int, radius):
    """[H, W] bool: the pixels that film points ``p_film`` [K, 2] splat
    into (film.py's footprint)."""
    mask = np.zeros((resolution, resolution), bool)
    d = np.asarray(p_film, np.float32).astype(np.float64) - 0.5
    p0x, p0y, p1x, p1y = FILM._footprint(d, float(radius[0]),
                                         float(radius[1]), resolution,
                                         resolution)
    for x0, y0, x1, y1 in zip(p0x, p0y, p1x, p1y):
        mask[int(y0) - 1:int(y1), int(x0) - 1:int(x1)] = True
    return mask


def film_grid(resolution: int, radius):
    """(px, py) int64 of the film's sample bounds, x fastest."""
    lo = [int(np.floor(1 + 0.5 - r)) for r in radius]
    hi = [int(np.ceil(resolution - 0.5 + r)) for r in radius]
    gx, gy = np.meshgrid(np.arange(lo[0], hi[0] + 1),
                         np.arange(lo[1], hi[1] + 1), indexing="xy")
    return gx.reshape(-1), gy.reshape(-1)


def render(desc: dict, resolution: int, seed: int, args: dict, device,
           block: int = 1 << 17):
    """((xyz sums [H, W, 3], weight sums [H, W]) float64 of the frame,
    [H, W] bool: the pixels of ``ambiguous`` camera lanes); ``args`` the
    integrator's (spp, max_depth, rr_depth)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cam = desc["camera"]
    radius = cam["filter"]["radius"]
    box = Box(desc, device)
    px, py = film_grid(resolution, radius)
    ids = rng.pixel_ids(px, py)
    pix = np.stack([px, py], 1).astype(np.float32)
    p_all, l_all, p_amb = [], [], []
    for s in range(int(args["spp"])):
        lane = rng.fold_in(rng.fold_in(rng.key(seed), s), ids)
        u = rng.uniforms(rng.fold_in(lane, 0), 5)
        p_film = pix + u[:, :2].astype(np.float32)
        keys = rng.fold_in(lane, 1)
        o, d = C.generate_rays(cam, (resolution, resolution), p_film)
        for a in range(0, o.shape[0], block):
            b = slice(a, a + block)
            ob = torch.from_numpy(o[b]).to(box.dev)
            db = torch.from_numpy(d[b]).to(box.dev)
            l_all.append(radiance(
                box, ob, db, (keys[0][b], keys[1][b]),
                int(args["max_depth"]), int(args["rr_depth"])).cpu().numpy())
            p_amb.append(p_film[b][ambiguous(box, ob, db).cpu().numpy()])
        p_all.append(p_film)
    res = (resolution, resolution)
    film = FILM.splat(np.concatenate(p_all), np.concatenate(l_all), res,
                      radius, cam["filter"]["tau"])
    return film, footprint_mask(np.concatenate(p_amb), resolution, radius)


def checks(got, want, mask, limits: dict) -> list:
    """compare.film_checks with the pixels of ``mask`` (``render``'s)
    taken from the reference on both sides."""
    xyz = np.where(mask[..., None], want[0], got[0])
    wsum = np.where(mask, want[1], got[1])
    return compare.film_checks((xyz, wsum), want, limits)
