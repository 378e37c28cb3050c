"""Material dispatch: textures -> static-width lobe slots (port of
trace_tpu/wavefront/materials.py for matte and smooth glass with
constant textures)."""
from __future__ import annotations

import numpy as np
import torch

from ..core import vec as V
from ..core.vec import V3
from ..materials import materials as M
from ..materials.textures import ConstantTexture
from . import shade as S
from .geom import HitP

F32 = torch.float32
DEG2RAD = float(np.float32(np.pi / 180.0))


def _tex_rgb(tex, hit: HitP) -> V3:
    if not (isinstance(tex, ConstantTexture) and tex.is_spectral):
        raise NotImplementedError("only constant RGB textures are ported")
    v = tex.value
    return V3.full(hit.t.shape, v[0], v[1], v[2], hit.t.device)


def _tex_scalar(tex, hit: HitP) -> torch.Tensor:
    if not (isinstance(tex, ConstantTexture) and not tex.is_spectral):
        raise NotImplementedError("only constant scalar textures are ported")
    return torch.full(hit.t.shape, float(tex.value), dtype=F32,
                      device=hit.t.device)


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
                val = torch.tensor(val, dtype=cur.dtype, device=cur.device)
            upd[name] = torch.where(mask, val.to(cur.dtype), cur)
    slots = list(slots)
    slots[i] = s._replace(**upd)
    return tuple(slots)


def material_slots(mat: M.Material) -> int:
    return 2 if isinstance(mat, M.GlassMaterial) else 1


def compute_scattering(materials, hit: HitP) -> S.LobesP:
    """Lobes for every lane (radiance transport, one lobe per specular
    branch as Whitted samples them)."""
    n_slots = max((material_slots(m) for m in materials), default=1)
    lo = S.from_hit(hit, n_slots)
    slots = lo.slots
    eta = lo.eta
    for mat_id, mat in enumerate(materials):
        mask = hit.valid & (hit.material_id == mat_id)
        if isinstance(mat, M.MatteMaterial):
            r = V.maximum(_tex_rgb(mat.Kd, hit), 0.0)
            sig = _tex_scalar(mat.sigma, hit).clamp(0.0, 90.0)
            use_on = ~(sig.abs() < 1e-6)
            sig_rad = sig * DEG2RAD
            s2 = sig_rad * sig_rad
            a = 1.0 - s2 / (2.0 * (s2 + 0.33))
            b = 0.45 * s2 / (s2 + 0.09)
            kind = torch.where(use_on, S.OREN_NAYAR, S.LAMBERTIAN_REFLECTION)
            slots = _set_slot(slots, 0, mask & ~r.is_black(), kind=kind,
                              c0=r, a=torch.where(use_on, a, 0.0),
                              b=torch.where(use_on, b, 0.0))
        elif isinstance(mat, M.GlassMaterial):
            eta_m = _tex_scalar(mat.index, hit)
            r = V.maximum(_tex_rgb(mat.Kr, hit), 0.0)
            t = V.maximum(_tex_rgb(mat.Kt, hit), 0.0)
            r_black, t_black = r.is_black(), t.is_black()
            eta = torch.where(mask, eta_m, eta)
            ones = torch.ones_like(eta_m)
            sep = mask & ~(r_black & t_black)
            slots = _set_slot(slots, 0, sep & ~r_black,
                              kind=S.SPECULAR_REFLECTION, c0=r, eta_a=ones,
                              eta_b=eta_m, fr_kind=S.FRESNEL_DIELECTRIC)
            slots = _set_slot(slots, 1, sep & ~t_black,
                              kind=S.SPECULAR_TRANSMISSION, c0=t,
                              eta_a=ones, eta_b=eta_m,
                              fr_kind=S.FRESNEL_DIELECTRIC)
        else:
            raise NotImplementedError(
                f"material {type(mat).__name__} is not ported yet")
    return lo._replace(slots=slots, eta=eta)
