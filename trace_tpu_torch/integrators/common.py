"""Integrator helpers shared across integrators (port of the parts of
trace_tpu/integrators/common.py that the port's integrators use)."""
from __future__ import annotations

import numpy as np

from ..lights import lights as light_mod


def _to_y(rgb: np.ndarray) -> np.ndarray:
    return (0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1]
            + 0.072169 * rgb[..., 2])


def light_power_cdf(scene) -> np.ndarray:
    """Power-weighted light distribution -> CDF [L], float32 on the host
    (the light table is host data)."""
    p = _to_y(light_mod.power(scene.lights)).astype(np.float32)
    total = np.maximum(p.sum(dtype=np.float32), np.float32(1e-20))
    return np.cumsum(p / total, dtype=np.float32)


def light_power_pmf(cdf: np.ndarray) -> np.ndarray:
    """The CDF's per-light probabilities [L] (first differences)."""
    return cdf - np.concatenate([np.zeros(1, np.float32), cdf[:-1]])
