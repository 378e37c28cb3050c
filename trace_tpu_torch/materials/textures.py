"""Textures (port of trace_tpu/materials/textures.py: constant textures;
the others are not ported yet)."""
from __future__ import annotations

import numpy as np


class Texture:
    pass


class ConstantTexture(Texture):
    """A constant scalar or RGB value, held as host float32."""

    def __init__(self, value):
        v = np.asarray(value, np.float32)
        self.value = v
        self.is_spectral = v.ndim > 0


def as_texture(value_or_texture) -> Texture:
    if isinstance(value_or_texture, Texture):
        return value_or_texture
    return ConstantTexture(value_or_texture)
