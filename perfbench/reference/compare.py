"""The numbers that decide ``correct``, each beside its limit."""
from __future__ import annotations

import numpy as np


def normalized(xyz, wsum):
    return xyz / np.where(wsum != 0.0, wsum, 1.0)[..., None]


def _rel_rms(diff, ref) -> float:
    if diff.size == 0:
        return 0.0
    return float(np.sqrt(np.mean(diff * diff))
                 / max(np.sqrt(np.mean(ref * ref)), 1e-30))


def film_checks(got, want, limits: dict) -> list:
    """The program's film against the reference's, each (xyz sums, weight
    sums) -> [(name, value, limit)], over the weight-normalised XYZ image,
    every pixel:

    - ``img_rel_rms``: RMS of the difference over the reference's RMS;
    - ``bad_px``: share of pixels off by more than ``bad_px_tol`` of the
      reference's mean Y in a channel.

    The filter weight sums are not compared by themselves: the control
    (the sweep's bf16 panel) leaves them as they are, so they have no
    upper reading; a splat that drops or moves samples shows in both
    numbers above.
    """
    g = normalized(*got)
    w = normalized(*want)
    diff = g - w
    tol = limits["bad_px_tol"] * max(float(w[..., 1].mean()), 1e-30)
    bad = float((np.abs(diff) > tol).any(-1).mean())
    return [
        ("img_rel_rms", _rel_rms(diff, w), limits["img_rel_rms"]),
        ("bad_px", bad, limits["bad_px"]),
    ]
