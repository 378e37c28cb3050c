"""Whitted frame of the heightfield scene, from its description and the
seed alone: float32 film samples from the seed's Threefry stream, camera
rays, closest and any hits through tiles.TileGrid and the analytic glass
sphere, Oren-Nayar direct light from the point light with shadow rays,
the glass sphere's specular reflection weighted by its dielectric
Fresnel term, and the film's splat (film.py).

At depth 2 a transmitted ray's next hit is the inside of the glass
sphere, which has no non-specular lobe: it adds nothing, so it is not
traced. Lanes are shaded in float64."""
from __future__ import annotations

import numpy as np
import torch

from . import camera as C
from . import film as FILM
from . import rng
from .scene import SPAWN_EPS, Scene


def film_samples(resolution: int, seed: int, radius=(1.0, 1.0)):
    """p_film [N, 2] float32 over the film's sample bounds, x fastest:
    sample 0 of a one-sample-per-pixel sampler."""
    lo = (int(np.floor(1 + 0.5 - radius[0])),
          int(np.floor(1 + 0.5 - radius[1])))
    hi = (int(np.ceil(resolution - 0.5 + radius[0])),
          int(np.ceil(resolution - 0.5 + radius[1])))
    xs = np.arange(lo[0], hi[0] + 1)
    ys = np.arange(lo[1], hi[1] + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    px, py = gx.reshape(-1), gy.reshape(-1)
    k = rng.fold_in(rng.key(seed), 0)                  # sample pass 0
    lane = rng.fold_in(k, rng.pixel_ids(px, py))
    cam = rng.fold_in(lane, 0)                         # the camera draw
    u = rng.uniforms(cam, 5)
    return (np.stack([px, py], 1).astype(np.float32)
            + u[:, :2].astype(np.float32))


def radiance(scene: Scene, o, d):
    """[N, 3] float64 radiance of camera rays o, d at depth 2."""
    t, kind, tri = scene.closest(o, d)
    p = o + d * t[:, None]
    wo = -d
    L = torch.zeros_like(o)
    ter = kind == 1
    if ter.any():
        L[ter] = scene.direct(p[ter], scene.normal(tri[ter]), wo[ter])
    sph = kind == 2
    if sph.any():
        ps, ws = p[sph], wo[sph]
        ns = (ps - scene.center) / scene.radius
        ns = ns / ns.norm(dim=-1, keepdim=True)
        cos = (ws * ns).sum(-1)
        wr = 2.0 * cos[:, None] * ns - ws              # mirror direction
        fr = scene.fresnel(cos)
        o2 = ps + wr * SPAWN_EPS
        t2, k2, tri2 = scene.closest(o2, wr)
        L2 = torch.zeros_like(o2)
        hit2 = k2 == 1
        if hit2.any():
            p2 = o2[hit2] + wr[hit2] * t2[hit2][:, None]
            L2[hit2] = scene.direct(p2, scene.normal(tri2[hit2]), -wr[hit2])
        L[sph] = fr[:, None] * L2
    return torch.where(torch.isfinite(L), L, 0.0).clamp_min(0.0)


def render(desc: dict, verts: np.ndarray, n: int, resolution: int, seed: int,
           device, block: int = 1 << 15):
    """(xyz sums [H, W, 3], weight sums [H, W]) float64 of the frame."""
    cam = desc["camera"]
    radius = cam["filter"]["radius"]
    p_film = film_samples(resolution, seed, radius)
    o, d = C.generate_rays(cam, (resolution, resolution), p_film)
    scene = Scene(desc, verts, n, device)
    out = []
    for s in range(0, o.shape[0], block):
        ob = torch.from_numpy(o[s:s + block]).to(scene.dev)
        db = torch.from_numpy(d[s:s + block]).to(scene.dev)
        out.append(radiance(scene, ob, db).cpu().numpy())
    rgb = np.concatenate(out)
    res = (resolution, resolution)
    return FILM.splat(p_film, rgb, res, radius, cam["filter"]["tau"])
