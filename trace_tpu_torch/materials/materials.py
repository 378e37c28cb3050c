"""Material descriptions (port of trace_tpu/materials/materials.py).

Materials are static parameter records; the planar wavefront turns them
into lobe slots (wavefront/materials.py). Matte, mirror, smooth or rough
glass, plastic and metal; any parameter may be a texture
(materials/textures.py).
"""
from __future__ import annotations

from .textures import as_texture


class Material:
    def textures(self):
        return [v for v in vars(self).values()
                if not isinstance(v, (bool, int, float))]


class MatteMaterial(Material):
    """Lambertian, or Oren-Nayar for sigma > 0 (degrees)."""

    def __init__(self, Kd=(0.5, 0.5, 0.5), sigma=0.0):
        self.Kd = as_texture(Kd)
        self.sigma = as_texture(sigma)


class MirrorMaterial(Material):
    """Perfect mirror: specular reflection with the no-op Fresnel term."""

    def __init__(self, Kr=(0.9, 0.9, 0.9)):
        self.Kr = as_texture(Kr)


class GlassMaterial(Material):
    """Smooth dielectric (specular lobes) or, for a roughness above 0,
    GGX microfacet reflection and transmission."""

    def __init__(self, Kr=(1.0, 1.0, 1.0), Kt=(1.0, 1.0, 1.0),
                 u_roughness=0.0, v_roughness=0.0, index=1.5,
                 remap_roughness=True):
        self.Kr, self.Kt = as_texture(Kr), as_texture(Kt)
        self.u_roughness = as_texture(u_roughness)
        self.v_roughness = as_texture(v_roughness)
        self.index = as_texture(index)
        self.remap_roughness = bool(remap_roughness)


class PlasticMaterial(Material):
    """Lambertian base plus a GGX coat."""

    def __init__(self, Kd=(0.25, 0.25, 0.25), Ks=(0.25, 0.25, 0.25),
                 roughness=0.1, remap_roughness=True):
        self.Kd, self.Ks = as_texture(Kd), as_texture(Ks)
        self.roughness = as_texture(roughness)
        self.remap_roughness = bool(remap_roughness)


class MetalMaterial(Material):
    """GGX conductor with per-channel eta and k."""

    def __init__(self, eta=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14),
                 roughness=0.01, remap_roughness=True):
        self.eta = as_texture(eta)
        self.k = as_texture(k)
        self.roughness = as_texture(roughness)
        self.remap_roughness = bool(remap_roughness)
