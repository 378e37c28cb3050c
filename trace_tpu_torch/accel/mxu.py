"""Matmul-factored Moller-Trumbore: the epilogue every matmul-factored
intersector shares, and the all-pairs accelerator built on it (port of
trace_tpu/accel/mxu.py).

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

:func:`intersect_grid` is the JAX package's whole [R, T] pair grid as
six [R, 3] @ [3, T] products plus the epilogue, and
:class:`MXUAccelerator` its chunked brute force over a scene's
triangles. The JAX package runs them as XLA matmuls outside any Pallas
kernel; here they are ``torch.matmul`` (cuBLAS on the card, full f32:
construction refuses TF32). On the card the hand-written all-pairs test
is ``csrc/intersect.cu`` (ops/intersect.py); this route is its library
formulation (chip_smoke.py phase 16d times the two on the same rays).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

F32 = torch.float32
INF = float("inf")

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


class TriMatmulConsts(NamedTuple):
    """Per-triangle constants, [3, T] each as a matmul's right-hand side:
    host numpy from :func:`build_consts`, tensors after :func:`consts_to`."""
    n: np.ndarray           # [3, T] e1 x e2
    e1: np.ndarray          # [3, T]
    e2: np.ndarray          # [3, T]
    w: np.ndarray           # [3, T] e2 x v0
    q: np.ndarray           # [3, T] v0 x e1
    v0n: np.ndarray         # [T]    v0 . n
    degenerate: np.ndarray  # [T] bool


def build_consts(tris) -> TriMatmulConsts:
    """A Triangles table -> its constants, computed in f64 and rounded to
    f32 once, as the JAX package's build_consts."""
    v0, v1, v2 = (np.asarray(getattr(tris, k), np.float64)
                  for k in ("v0", "v1", "v2"))
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    w = np.cross(e2, v0)
    q = np.cross(v0, e1)
    v0n = np.einsum("ij,ij->i", v0, n)
    degen = (n * n).sum(-1) < 1e-16
    f = lambda x: np.ascontiguousarray(x.T, dtype=np.float32)
    return TriMatmulConsts(f(n), f(e1), f(e2), f(w), f(q),
                           np.asarray(v0n, np.float32), np.asarray(degen))


def consts_to(consts: TriMatmulConsts, device) -> TriMatmulConsts:
    """The constants as tensors on ``device``."""
    return TriMatmulConsts(*[torch.as_tensor(x).to(device) for x in consts])


def _check_f32_matmul(device) -> None:
    if torch.device(device).type == "cuda" and \
            torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("the matmul-factored test needs full f32 "
                         "products: torch.backends.cuda.matmul.allow_tf32 "
                         "is on")


def intersect_grid(consts: TriMatmulConsts, o, d, t_max):
    """All pairs of R rays (o, d [R, 3], t_max [R]) and T triangles
    (``consts`` as tensors on the rays' device) through six matmuls ->
    (hit [R, T] bool, t [R, T], meaningful where hit). A hit has t <=
    t_max, as in the JAX package."""
    m = torch.stack([o[:, 1] * d[:, 2] - o[:, 2] * d[:, 1],
                     o[:, 2] * d[:, 0] - o[:, 0] * d[:, 2],
                     o[:, 0] * d[:, 1] - o[:, 1] * d[:, 0]], 1)
    mm = torch.matmul
    det = -mm(d, consts.n)
    u_det = mm(m, consts.e2) - mm(d, consts.w)
    v_det = -mm(m, consts.e1) - mm(d, consts.q)
    t_det = mm(o, consts.n) - consts.v0n[None, :]
    ok, t = mt_epilogue(det, u_det, v_det, t_det)
    return ok & ~consts.degenerate[None, :] & (t <= t_max[:, None]), t


class MXUAccelerator:
    """Chunked all-pairs brute force through :func:`intersect_grid`,
    ``tri_chunk`` triangles at a time (the [R, chunk] products bound the
    working set). ``intersect`` is the port's accelerator interface;
    ``closest`` and ``any_hit`` are the JAX package's, over a scene's
    spheres and triangles. ``consts`` may be host arrays: they are moved
    to ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, consts: TriMatmulConsts, n_triangles: int,
                 tri_chunk: int = 8192, device="cuda"):
        _check_f32_matmul(device)
        self.device = torch.device(device)
        self.consts = consts_to(consts, self.device)
        self.n_triangles = int(n_triangles)
        self.tri_chunk = int(tri_chunk)

    def _sweep(self, o, d, t_max, any_hit: bool = False):
        n = o.shape[0]
        chunk = min(self.tri_chunk, max(self.n_triangles, 1))
        best_t = torch.full((n,), INF, dtype=F32, device=o.device)
        best_i = torch.full((n,), -1, dtype=torch.int32, device=o.device)
        for s in range(0, self.n_triangles, chunk):
            e = min(s + chunk, self.n_triangles)
            part = TriMatmulConsts(*[x[..., s:e] for x in self.consts])
            hit, t = intersect_grid(part, o, d, t_max)
            lt, li = torch.where(hit, t, INF).min(dim=-1)
            better = lt < best_t
            best_t = torch.where(better, lt, best_t)
            best_i = torch.where(better, li.to(torch.int32) + s, best_i)
        hit = (best_i >= 0) & (best_t <= t_max)
        return hit, torch.where(hit, best_t, INF), best_i.clamp_min(0)

    def intersect(self, o, d, t_max, any_hit: bool):
        """Rays o, d [N, 3], t_max [N] -> (hit [N], t [N], tri [N] i32);
        any-hit runs the closest-hit test, as in the JAX package."""
        return self._sweep(o, d, t_max, any_hit)

    def closest(self, scene, o, d, t_max):
        """((hit, t, sphere), (hit, t, triangle)) for rays o, d [N, 3]:
        the scene's spheres and this accelerator's triangles."""
        from ..core.vec import V3
        from ..wavefront import geom as G

        n = o.shape[0]
        no_hit = (torch.zeros(n, dtype=torch.bool, device=o.device),
                  torch.full((n,), INF, dtype=F32, device=o.device),
                  torch.zeros(n, dtype=torch.int32, device=o.device))
        hs = (G.spheres_closest(scene.sphere_cols, V3.of(o), V3.of(d),
                                t_max) if scene.n_spheres else no_hit)
        ht = self._sweep(o, d, t_max) if scene.n_triangles else no_hit
        return hs, ht

    def any_hit(self, scene, o, d, t_max):
        """Occlusion [N] bool: a sphere or a triangle hit within t_max."""
        from ..core.vec import V3
        from ..wavefront import geom as G

        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        if scene.n_spheres:
            occ = occ | G.spheres_anyhit(scene.sphere_cols, V3.of(o),
                                         V3.of(d), t_max)
        if scene.n_triangles:
            h, t, _ = self._sweep(o, d, t_max, True)
            occ = occ | (h & (t <= t_max))
        return occ


def attach(scene, tri_chunk: int = 8192):
    """Install the all-pairs matmul accelerator over the scene's
    triangles (constants built on the host) and bump its version."""
    if scene.n_triangles == 0:
        return scene
    from ..shapes import triangle as tri_mod

    consts = build_consts(tri_mod.to_numpy(scene.triangles))
    scene.bump_version()
    scene.accel = MXUAccelerator(consts, scene.n_triangles, tri_chunk,
                                 scene.device)
    return scene
