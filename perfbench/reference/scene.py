"""The heightfield scene of the benchmark's configurations, for the
reference: the terrain through tiles.TileGrid and the analytic glass
sphere, closest and any hits, the terrain's Oren-Nayar reflectance and
direct light from the point light with its shadow ray, and the sphere's
dielectric Fresnel term. Float64 on ``device``."""
from __future__ import annotations

import numpy as np
import torch

from . import tiles as TL
from .tiles import INF

F64 = torch.float64
SPAWN_EPS = 1e-6
SHADOW_T_MAX = 1.0 - 1e-4


class Scene:
    """The scene description's geometry and lights on ``device``."""

    def __init__(self, desc: dict, verts: np.ndarray, n: int, device):
        self.dev = torch.device(device)
        self.grid = TL.TileGrid(verts, n, device)
        g = desc["glass_sphere"]
        self.center = torch.tensor(g["center"], dtype=F64, device=self.dev)
        self.radius = float(g["radius"])
        self.eta = float(g["eta"])
        lt = desc["point_light"]
        self.light_p = torch.tensor(lt["position"], dtype=F64,
                                    device=self.dev)
        self.light_i = torch.tensor(lt["I"], dtype=F64, device=self.dev)
        gr = desc["ground"]
        self.kd = torch.tensor(gr["Kd"], dtype=F64, device=self.dev)
        sig = np.deg2rad(np.float32(gr["sigma"]))
        s2 = sig * sig
        self.on_a = 1.0 - s2 / (2.0 * (s2 + 0.33))
        self.on_b = 0.45 * s2 / (s2 + 0.09)

    def closest(self, o, d, t_max=None):
        """(t, kind: 0 miss, 1 terrain, 2 sphere, triangle id)."""
        if t_max is None:
            t_max = torch.full(o.shape[:1], INF, dtype=F64, device=self.dev)
        ts = TL.sphere_t(o, d, self.center, self.radius, t_max)
        tt, tri = self.grid.intersect(o, d, t_max)
        terrain = torch.isfinite(tt) & (tt < ts)
        kind = torch.where(terrain, 1, torch.where(torch.isfinite(ts), 2, 0))
        return torch.where(terrain, tt, ts), kind, tri

    def occluded(self, o, d, t_max):
        ts = TL.sphere_t(o, d, self.center, self.radius, t_max)
        tt, _ = self.grid.intersect(o, d, t_max)
        return torch.isfinite(ts) | torch.isfinite(tt)

    def normal(self, tri):
        v = self.grid.triangle_vertices(tri.clamp_min(0))
        n = torch.linalg.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
        return n / n.norm(dim=-1, keepdim=True)

    def oren_nayar(self, wo, wi, n):
        """[N, 3] Oren-Nayar reflectance of the ground for unit directions
        wo, wi about the geometric normal n; 0 where they lie on opposite
        sides. Frame-free: the azimuth difference comes from the
        projections on the tangent plane."""
        cos_i = (wi * n).sum(-1)
        cos_o = (wo * n).sum(-1)
        sin_i = (1.0 - cos_i * cos_i).clamp_min(0.0).sqrt()
        sin_o = (1.0 - cos_o * cos_o).clamp_min(0.0).sqrt()
        ti = wi - cos_i[:, None] * n
        to = wo - cos_o[:, None] * n
        den = ti.norm(dim=-1) * to.norm(dim=-1)
        dcos = (ti * to).sum(-1) / torch.where(den > 0, den, 1.0)
        max_cos = torch.where((sin_i > 1e-4) & (sin_o > 1e-4),
                              dcos.clamp_min(0.0), 0.0)
        i_bigger = cos_i.abs() > cos_o.abs()
        sin_a = torch.where(i_bigger, sin_o, sin_i)
        tan_b = torch.where(i_bigger, sin_i / cos_i.abs().clamp_min(1e-300),
                            sin_o / cos_o.abs().clamp_min(1e-300))
        f = self.kd * ((self.on_a + self.on_b * max_cos * sin_a * tan_b)
                       / np.pi)[:, None]
        return torch.where((cos_i * cos_o > 0.0)[:, None], f, 0.0)

    def direct(self, p, n, wo):
        """Oren-Nayar direct light from the point light at terrain points
        p with geometric normal n, seen from wo (unit, toward the eye)."""
        to_l = self.light_p - p
        dist2 = (to_l * to_l).sum(-1)
        wi = to_l / dist2.sqrt()[:, None]
        radiance = self.light_i / dist2[:, None]
        f = self.oren_nayar(wo, wi, n)
        cos_i = (wi * n).sum(-1)
        # The shadow ray: to the light, nudged off the surface along the
        # geometric normal on the light's side, t_max just short of it.
        ds = self.light_p - p
        scale = 1e-4 * p.abs().amax(-1).clamp_min(1.0)
        side = torch.sign((n * ds).sum(-1))
        os_ = p + ds * SPAWN_EPS + n * (scale * side)[:, None]
        t_max = torch.full(p.shape[:1], SHADOW_T_MAX, dtype=F64,
                           device=self.dev)
        lit = ~self.occluded(os_, ds, t_max)
        return torch.where(lit[:, None], f * radiance * cos_i.abs()[:, None],
                           0.0)

    def fresnel(self, cos_i):
        """Unpolarised dielectric reflectance, air outside, eta inside."""
        cos_i = cos_i.clamp(-1.0, 1.0)
        entering = cos_i > 0.0
        ei = torch.where(entering, 1.0, self.eta)
        et = torch.where(entering, self.eta, 1.0)
        cos_i = cos_i.abs()
        sin_t = ei / et * (1.0 - cos_i * cos_i).clamp_min(0.0).sqrt()
        cos_t = (1.0 - sin_t * sin_t).clamp_min(0.0).sqrt()
        r_par = (et * cos_i - ei * cos_t) / (et * cos_i + ei * cos_t)
        r_perp = (ei * cos_i - et * cos_t) / (ei * cos_i + et * cos_t)
        return torch.where(sin_t >= 1.0, 1.0,
                           0.5 * (r_par * r_par + r_perp * r_perp))
