"""Material descriptions (port of trace_tpu/materials/materials.py).

Materials are static parameter records; the planar wavefront turns them
into lobe slots (wavefront/materials.py). Matte and glass are ported;
mirror, plastic and metal raise until a later slice needs them.
"""
from __future__ import annotations

from .textures import ConstantTexture, as_texture


class Material:
    pass


class MatteMaterial(Material):
    """Lambertian, or Oren-Nayar for sigma > 0 (degrees)."""

    def __init__(self, Kd=(0.5, 0.5, 0.5), sigma=0.0):
        self.Kd = as_texture(Kd)
        self.sigma = as_texture(sigma)


class GlassMaterial(Material):
    """Smooth dielectric (rough glass is not ported yet)."""

    def __init__(self, Kr=(1.0, 1.0, 1.0), Kt=(1.0, 1.0, 1.0),
                 u_roughness=0.0, v_roughness=0.0, index=1.5,
                 remap_roughness=True):
        self.Kr, self.Kt = as_texture(Kr), as_texture(Kt)
        self.u_roughness = as_texture(u_roughness)
        self.v_roughness = as_texture(v_roughness)
        self.index = as_texture(index)
        self.remap_roughness = bool(remap_roughness)
        for tex in (self.u_roughness, self.v_roughness):
            if not (isinstance(tex, ConstantTexture) and float(tex.value) == 0.0):
                raise NotImplementedError("rough glass is not ported yet")


class MirrorMaterial(Material):
    def __init__(self, *args, **kw):
        raise NotImplementedError("MirrorMaterial is not ported yet")


class PlasticMaterial(Material):
    def __init__(self, *args, **kw):
        raise NotImplementedError("PlasticMaterial is not ported yet")


class MetalMaterial(Material):
    def __init__(self, *args, **kw):
        raise NotImplementedError("MetalMaterial is not ported yet")
