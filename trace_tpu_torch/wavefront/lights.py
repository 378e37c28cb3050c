"""Light sampling on planar state (port of trace_tpu/wavefront/lights.py:
point lights, and the area-emission term of scenes without area
lights). Lights are visited at static indices and their parameters read
as host scalars from the scene's light table."""
from __future__ import annotations

import torch

from ..core.vec import V3
from ..lights import lights as L

F32 = torch.float32


def light_count(scene) -> int:
    return L.num_lights(scene.lights)


def sample_li_static(scene, j: int, p_ref: V3, u0, u1):
    """sample_li for static point light ``j`` -> (radiance V3, wi V3,
    pdf [N], p_light V3). ``u0``/``u1`` are unused by point lights."""
    lights = scene.lights
    n = p_ref.x.shape[0]
    dev = p_ref.x.device
    px, py, pz = (float(v) for v in lights.p[j])
    ir, ig, ib = (float(v) for v in lights.i[j])
    p_light = V3.full((n,), px, py, pz, dev)
    to_l = p_light - p_ref
    dist2 = to_l.length_squared().clamp_min(1e-20)
    inv_d = 1.0 / torch.sqrt(dist2)
    wi = to_l * inv_d
    inv2 = 1.0 / dist2
    rad = V3(ir * inv2, ig * inv2, ib * inv2)
    return rad, wi, torch.ones((n,), dtype=F32, device=dev), p_light


def area_light_radiance(scene, hit, wo: V3) -> V3:
    """Emitted radiance at the hit: zero, as the port has no area lights
    yet (pack_lights refuses them)."""
    return V3.zeros(hit.t.shape, hit.t.device)
