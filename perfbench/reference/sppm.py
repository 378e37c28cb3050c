"""One SPPM iteration of the heightfield scene from the state before it,
for a sample of pixels drawn from the seed: the camera pass (Threefry
keys of the seed, the iteration and the pixel; specular bounces on the
glass sphere chosen by its Fresnel coin, Russian roulette; a visible
point and the unweighted direct light at the first terrain hit), every
photon of the iteration (the iteration's Halton indices; emission from
the point light, bounces on the terrain by cosine sampling and on the
sphere by its Fresnel coin, roulette against the photon's initial
luminance, a record at each hit after the first), the pairs of records
and sampled visible points within the pixel's radius, found through a
uniform grid of the reference's own, and the pixel update.

Float64 throughout; the state before the iteration is the program's (the
reference follows the program step by step), and every sampled pixel is
compared: the direct light, tau, the radius and the photon count after
the iteration, each against the reference's update of the same state."""
from __future__ import annotations

import numpy as np
import torch

from . import camera as C
from . import rng
from .scene import SPAWN_EPS, Scene

F64 = torch.float64
GAMMA = float(np.float32(2.0 / 3.0))
Y = (0.212671, 0.715160, 0.072169)
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59,
          61, 67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113)
ONE_MINUS = 1.0 - 1e-6


def lum(c):
    return c[..., 0] * Y[0] + c[..., 1] * Y[1] + c[..., 2] * Y[2]


def radical_inverse(dim: int, a: np.ndarray) -> np.ndarray:
    """The radical inverse of uint32 indices ``a`` in base PRIMES[dim]."""
    base = PRIMES[dim]
    a = a.astype(np.int64)
    out = np.zeros(a.shape, np.float64)
    scale = 1.0 / base
    while (a > 0).any():
        out += (a % base) * scale
        a //= base
        scale /= base
    return out


def _u(keys, cols):
    return torch.from_numpy(rng.uniforms(keys, cols))


def _take(keys, idx):
    return keys[0][idx], keys[1][idx]


def glass_bounce(scene, p, d, u0, importance: bool):
    """The sphere's Fresnel-coin bounce -> (wi, throughput factor)."""
    ns = (p - scene.center) / scene.radius
    ns = ns / ns.norm(dim=-1, keepdim=True)
    wo = -d
    cos = (wo * ns).sum(-1)
    fr = scene.fresnel(cos)
    refl = torch.minimum(u0, torch.full_like(u0, ONE_MINUS)) < fr
    w_r = 2.0 * cos[:, None] * ns - wo
    entering = cos > 0.0
    eta = torch.where(entering, 1.0 / scene.eta, scene.eta)
    n = torch.where(entering[:, None], ns, -ns)
    cos_i = cos.abs()
    sin2_t = eta * eta * (1.0 - cos_i * cos_i).clamp_min(0.0)
    cos_t = (1.0 - sin2_t).clamp_min(0.0).sqrt()
    w_t = -eta[:, None] * wo + n * (eta * cos_i - cos_t)[:, None]
    wi = torch.where(refl[:, None], w_r, w_t)
    factor = torch.where(refl | importance, 1.0, eta * eta)
    return wi, factor


def camera_pass(scene, o, d, ks, max_depth: int):
    """-> (direct light [N, 3], visible point p, wo, normal [N, 3], valid
    [N])."""
    n = o.shape[0]
    dev = scene.dev
    o = torch.from_numpy(o).to(dev)
    d = torch.from_numpy(d).to(dev)
    beta = torch.ones((n, 3), dtype=F64, device=dev)
    ld = torch.zeros((n, 3), dtype=F64, device=dev)
    vp_p = torch.zeros((n, 3), dtype=F64, device=dev)
    vp_wo = torch.zeros_like(vp_p)
    vp_n = torch.zeros_like(vp_p)
    vp_ok = torch.zeros(n, dtype=torch.bool, device=dev)
    act = torch.arange(n, device=dev)
    for depth in range(1, max_depth + 1):
        if act.numel() == 0:
            break
        t, kind, tri = scene.closest(o[act], d[act])
        p = o[act] + d[act] * t[:, None]
        ter = kind == 1
        a = act[ter]
        if a.numel():
            nrm = scene.normal(tri[ter])
            ld[a] = scene.direct(p[ter], nrm, -d[a])
            vp_p[a], vp_wo[a], vp_n[a] = p[ter], -d[a], nrm
            vp_ok[a] = True
        sph = kind == 2
        a = act[sph]
        if depth == max_depth or a.numel() == 0:
            break
        kd = rng.fold_in(_take(ks, a.cpu().numpy()), depth)
        u = _u(rng.fold_in(kd, 1), 2).to(dev)
        u_rr = _u(rng.fold_in(kd, 2), 1)[:, 0].to(dev)
        wi, factor = glass_bounce(scene, p[sph], d[a], u[:, 0], False)
        b = beta[a] * factor[:, None]
        by = lum(b)
        rr = by < 0.25
        cp = by.clamp_max(1.0)
        killed = rr & (u_rr > cp)
        beta[a] = torch.where((rr & ~killed)[:, None], b / cp[:, None], b)
        o[a] = p[sph] + wi * SPAWN_EPS
        d[a] = wi
        act = a[~killed]
    return ld, vp_p, vp_wo, vp_n, vp_ok


def photon_pass(scene, it: int, n_photons: int, max_depth: int):
    """-> splat records (p, d, beta [R, 3], photon [R], depth [R]) of
    every photon's hits after its first."""
    dev = scene.dev
    a = (((it - 1) * n_photons + np.arange(n_photons, dtype=np.int64))
         & 0xFFFFFFFF)
    ri = lambda dim: torch.from_numpy(radical_inverse(dim, a)).to(dev)
    u1, u2 = ri(1), ri(2)
    z = 1.0 - 2.0 * u1
    r = (1.0 - z * z).clamp_min(0.0).sqrt()
    phi = 2.0 * np.pi * u2
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
    o = scene.light_p.expand_as(d).clone()
    beta = (scene.light_i * 4.0 * np.pi).expand_as(d)
    beta_y0 = lum(beta[:1])[0]
    act = torch.arange(n_photons, device=dev)
    recs = []
    for depth in range(1, max_depth + 1):
        if act.numel() == 0:
            break
        t, kind, tri = scene.closest(o[act], d[act])
        live = kind > 0
        act, t, kind, tri = act[live], t[live], kind[live], tri[live]
        p = o[act] + d[act] * t[:, None]
        if depth > 1:
            recs.append((p, d[act], beta[act], act,
                         torch.full_like(act, depth)))
        if depth == max_depth:
            break
        dim = 6 + 3 * (depth - 1)
        uu0, uu1, uu2 = (ri(dim + k)[act] for k in range(3))
        wi = torch.zeros_like(p)
        go = torch.zeros(act.shape[0], dtype=torch.bool, device=dev)
        ter = kind == 1
        if ter.any():
            v = scene.grid.triangle_vertices(tri[ter])
            ns = torch.linalg.cross(v[:, 0] - v[:, 2], v[:, 1] - v[:, 2])
            ns = ns / ns.norm(dim=-1, keepdim=True)
            ss = v[:, 1] - v[:, 0]
            ss = ss / ss.norm(dim=-1, keepdim=True)
            ts = torch.linalg.cross(ns, ss)
            wo = -d[act[ter]]
            woz = (wo * ns).sum(-1)
            dx, dy = concentric(uu0[ter].clamp_max(ONE_MINUS), uu1[ter])
            wz = (1.0 - dx * dx - dy * dy).clamp_min(0.0).sqrt()
            wz = torch.where(woz < 0.0, -wz, wz)
            w = ss * dx[:, None] + ts * dy[:, None] + ns * wz[:, None]
            f = scene.oren_nayar(wo, w, ns)
            pdf = wz.abs() / np.pi
            ok = (pdf > 0) & (f > 0).any(-1) & (woz.abs() >= 1e-12)
            b_new = beta[act[ter]] * f * ((w * ns).sum(-1).abs()
                                          / pdf.clamp_min(1e-300))[:, None]
            q = (1.0 - lum(b_new) / beta_y0).clamp_min(0.0)
            wi[ter] = w
            go[ter] = ok & (uu2[ter] >= q)
        sph = kind == 2
        if sph.any():
            w, _ = glass_bounce(scene, p[sph], d[act[sph]], uu0[sph], True)
            wi[sph] = w
            go[sph] = True
        o[act] = p + wi * SPAWN_EPS
        d[act] = wi
        act = act[go]
    if not recs:
        z3 = torch.zeros((0, 3), dtype=F64, device=dev)
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return z3, z3, z3, z, z
    return tuple(torch.cat([r_[k] for r_ in recs]) for k in range(5))


def concentric(u1, u2):
    ox, oy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    degenerate = (ox.abs() < 1e-8) & (oy.abs() < 1e-8)
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    theta = torch.where(
        use_x, (oy / torch.where(ox.abs() < 1e-8, 1.0, ox)) * (np.pi / 4),
        np.pi / 2 - (ox / torch.where(oy.abs() < 1e-8, 1.0, oy)) * (np.pi / 4))
    return (torch.where(degenerate, 0.0, r * torch.cos(theta)),
            torch.where(degenerate, 0.0, r * torch.sin(theta)))


def pairs(scene, vp_p, vp_wo, vp_n, vp_ok, radius, rec, chunk: int = 1 << 22):
    """(phi [N, 3], M [N]) of the visible points from the records within
    each point's radius: one uniform grid cell per point (edge twice the
    largest radius), each record looked up in its 27 neighbouring cells."""
    dev = scene.dev
    n = vp_p.shape[0]
    phi = torch.zeros((n, 3), dtype=F64, device=dev)
    m = torch.zeros(n, dtype=torch.int64, device=dev)
    idx = torch.nonzero(vp_ok)[:, 0]
    if idx.numel() == 0 or rec[0].shape[0] == 0:
        return phi, m
    h = 2.0 * float(radius[idx].max())
    lo = vp_p[idx].amin(0) - 2 * h
    cell = lambda p: torch.floor((p - lo) / h).to(torch.int64)
    s = 1 << 20
    key = lambda c: (c[:, 0] * s + c[:, 1]) * s + c[:, 2]
    vkey = key(cell(vp_p[idx]))
    vkey, order = torch.sort(vkey)
    vsorted = idx[order]
    rc = cell(rec[0])
    offs = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                         for c in (-1, 0, 1)], device=dev)
    for off in offs:
        k = key(rc + off)
        start = torch.searchsorted(vkey, k)
        cnt = torch.searchsorted(vkey, k, right=True) - start
        rid = torch.nonzero(cnt)[:, 0]
        if rid.numel() == 0:
            continue
        c = cnt[rid]
        pair_rec = torch.repeat_interleave(rid, c)
        first = torch.repeat_interleave(start[rid], c)
        run = (torch.arange(pair_rec.shape[0], device=dev)
               - torch.repeat_interleave(torch.cumsum(c, 0) - c, c))
        vp = vsorted[first + run]
        for s0 in range(0, vp.shape[0], chunk):
            j, v = pair_rec[s0:s0 + chunk], vp[s0:s0 + chunk]
            dd = vp_p[v] - rec[0][j]
            near = (dd * dd).sum(-1) <= radius[v] ** 2
            j, v = j[near], v[near]
            f = scene.oren_nayar(vp_wo[v], -rec[1][j], vp_n[v])
            phi.index_add_(0, v, rec[2][j] * f)
            m.index_add_(0, v, torch.ones_like(v))
    return phi, m


def iteration(desc, verts, n, resolution: int, seed: int, it: int, prev,
              args: dict, limits: dict, device):
    """The reference's iteration ``it`` from the program's state ``prev``
    (host arrays ld, tau [P, 3], radius, n [P]) at a sample of pixels ->
    dict of the sample's flat pixel ids, the direct light added, the
    updated tau, radius and n, and the iteration's contribution to tau."""
    n_pix = resolution * resolution
    pick = np.random.default_rng(seed).choice(
        n_pix, min(int(limits["sample_pixels"]), n_pix), replace=False)
    pick.sort()
    px, py = pick % resolution + 1, pick // resolution + 1
    ks = rng.fold_in(rng.fold_in(rng.key(seed), it), rng.pixel_ids(px, py))
    u = rng.uniforms(rng.fold_in(ks, 0), 5)
    p_film = np.stack([px, py], 1).astype(np.float32) + u[:, :2].astype(
        np.float32)
    cam = desc["camera"]
    o, d = C.generate_rays(cam, (resolution, resolution), p_film)

    scene = Scene(desc, verts, n, device)
    dev = scene.dev
    ld_add, vp_p, vp_wo, vp_n, vp_ok = camera_pass(
        scene, o, d, ks, int(args["max_depth"]))
    rec = photon_pass(scene, it, int(args["photons_per_iteration"]),
                      int(args["max_depth"]))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    r_prev = t(prev["radius"][pick])
    phi, m = pairs(scene, vp_p, vp_wo, vp_n, vp_ok, r_prev, rec)
    n_prev = t(prev["n"][pick])
    tau_prev = t(prev["tau"][pick])
    mf = m.to(F64)
    has = m > 0
    n_new = n_prev + GAMMA * mf
    r_new = r_prev * torch.sqrt(n_new / (n_prev + mf).clamp_min(1e-20))
    q2 = ((r_new / r_prev.clamp_min(1e-20)) ** 2)[:, None]
    # The iteration's own contribution to tau: phi times the shrink.
    contrib = torch.where(has[:, None], phi * q2, 0.0)
    tau = torch.where(has[:, None], (tau_prev + phi) * q2, tau_prev)
    host = lambda x: x.cpu().numpy()
    return {"pick": pick, "ld_add": host(ld_add), "tau": host(tau),
            "phi_q2": host(contrib), "radius": host(torch.where(has, r_new,
                                                                r_prev)),
            "n": host(n_new)}


def _gap(got, want) -> float:
    """RMS of got - want over the RMS of want (0 where both are 0)."""
    num = float(np.sqrt(np.mean((got - want) ** 2))) if got.size else 0.0
    den = float(np.sqrt(np.mean(want ** 2))) if want.size else 0.0
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def checks(out, want, limits: dict) -> list:
    """The program's states around its last iteration against the
    reference's iteration -> [(name, value, limit)] over the sampled
    pixels, each the gap of what the iteration changed:

    - ``ld_gap``: the direct light added (the program's ld after minus
      before) against the reference's camera pass;
    - ``tau_gap``: the program's tau after the iteration against the
      reference's update, over the reference's own contribution of the
      iteration (phi times the radius shrink squared);
    - ``r_gap``: the radius's change against the reference's update;
    - ``m_gap``: n's change (gamma times the photons gathered, M) against
      the reference's.

    A state left unchanged reads 1 on every number.
    """
    sel = want["pick"]
    prev, st = out["prev"], out["state"]
    ld_add = st["ld"][sel] - prev["ld"][sel]
    # The iteration's contribution to tau: the program's tau after it, less
    # the state before it shrunk as the reference's update shrinks it.
    shrunk = want["tau"] - want["phi_q2"]
    delta = lambda f: (st[f][sel] - prev[f][sel], want[f] - prev[f][sel])
    return [
        ("ld_gap", _gap(ld_add, want["ld_add"]), limits["ld_gap"]),
        ("tau_gap", _gap(st["tau"][sel] - shrunk, want["phi_q2"]),
         limits["tau_gap"]),
        ("r_gap", _gap(*delta("radius")), limits["r_gap"]),
        ("m_gap", _gap(*delta("n")), limits["m_gap"]),
    ]
