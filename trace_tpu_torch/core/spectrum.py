"""RGB <-> XYZ on [..., 3] float32 tensors (port of
trace_tpu/core/spectrum.py; same coefficients, same sum order)."""
from __future__ import annotations

import numpy as np
import torch

XYZ_TO_RGB_M = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ],
    dtype=np.float32,
)
RGB_TO_XYZ_M = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)


def _apply(M: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    c = [float(x) for x in M.reshape(-1)]
    v0, v1, v2 = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [c[3 * i] * v0 + c[3 * i + 1] * v1 + c[3 * i + 2] * v2
         for i in range(3)], dim=-1)


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
    return _apply(XYZ_TO_RGB_M, xyz)


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return _apply(RGB_TO_XYZ_M, rgb)
