"""The Moller-Trumbore epilogue of every matmul-factored intersector (port
of the tensor half of trace_tpu/accel/mxu.py).

The determinants factor into per-ray and per-triangle constants:

    det   = -d . n                    n  = e1 x e2
    u*det =  (o x d) . e2  -  d . w   w  = e2 x v0
    v*det = -(o x d) . e1  -  d . q   q  = v0 x e1
    t*det =  o . n        -  (v0 . n)

``mt_epilogue`` turns the four into (ok, t); ``mt_epilogue_certified``
widens every boundary test by a proven bound on its own f32 rounding
error, so a ray whose exact intersection lies on a shared mesh edge is
accepted by at least one of the two triangles (exact_shared_edges). The
CUDA kernels (csrc/sweep.cu, csrc/intersect.cu) compute the same
expressions in the same association order.
"""
from __future__ import annotations

import numpy as np
import torch

# Error-bound multiplier of the certified epilogue (the JAX package's
# derivation): the cross product m = o x d carries <= 2 eps of the
# abs-cross, each 3-term dot and dot difference <= 4 eps of the abs-dot
# sums, and each panel constant one f64 -> f32 rounding (1 eps); 8 covers
# 2 + 4 + 1 with margin. Overestimating only fattens silhouettes.
MT_ERR_EPS = float(np.float32(8.0 * 2.0 ** -24))


def mt_epilogue(det, u_det, v_det, t_det, eps: float = 1e-12):
    """Sign-folded validity + t. Returns (ok, t); callers AND in their own
    t-boundary rule and id masks."""
    sign = torch.where(det < 0.0, -1.0, 1.0)
    adet = det * sign
    u = u_det * sign
    v = v_det * sign
    tn = t_det * sign
    live = adet > eps
    t = tn / torch.where(live, adet, 1.0)
    ok = live & (u >= 0.0) & (v >= 0.0) & (u + v <= adet) & (tn > 0.0)
    return ok, t


def abs_cross(a_abs: torch.Tensor, b_abs: torch.Tensor) -> torch.Tensor:
    """Component-wise upper bound of |a x b| from |a| and |b| ([..., 3]):
    the cross formula with every subtraction replaced by an addition."""
    ax, ay, az = a_abs[..., 0], a_abs[..., 1], a_abs[..., 2]
    bx, by, bz = b_abs[..., 0], b_abs[..., 1], b_abs[..., 2]
    return torch.stack([ay * bz + az * by, az * bx + ax * bz,
                        ax * by + ay * bx], dim=-1)


def mt_epilogue_certified(det, u_det, v_det, t_det, err_det, err_u, err_v,
                          err_t, eps: float = 1e-12):
    """Widened :func:`mt_epilogue`: each boundary test is relaxed by the
    bound on its own rounding error. Grazing rays stay out: below err_det
    the folded sign itself is uncertain. The widened sum keeps the JAX
    package's left-to-right order, ((adet + err_u) + err_v) + err_det."""
    sign = torch.where(det < 0.0, -1.0, 1.0)
    adet = det * sign
    u = u_det * sign
    v = v_det * sign
    tn = t_det * sign
    live = adet > torch.clamp_min(err_det, eps)
    t = tn / torch.where(live, adet, 1.0)
    ok = (live & (u >= -err_u) & (v >= -err_v)
          & (u + v <= adet + err_u + err_v + err_det) & (tn > -err_t))
    return ok, t
