"""Integrator helpers shared across integrators (port of the parts of
trace_tpu/integrators/common.py that the port's integrators use): the
radiance sanitizer, the lights' power distribution, and the
animated-geometry pair (``prepare_geometry`` / ``apply_geometry``)."""
from __future__ import annotations

import numpy as np
import torch

from ..accel.clusters import ClusterAccel, ClusterAccelerator
from ..accel.morton import build_clusters_device
from ..lights import lights as light_mod
from ..ops.sweep import SweepAccelerator, SweepTables
from ..scene import (BLOCK_RAYS, BRUTE_FORCE_MAX_TRIS, GROUP, LEAF_TRIS,
                     RAY_CHUNK)
from ..shapes import triangle as tri_mod


def sanitize_radiance(l: torch.Tensor) -> torch.Tensor:
    """Radiance with non-finite entries set to 0 and negatives clamped
    to 0."""
    return torch.where(torch.isfinite(l), l, 0.0).clamp_min(0.0)


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


def prepare_geometry(scene, geometry, transform=None, accel=None):
    """One frame's triangles and accelerator tables, on the scene's device.

    ``geometry`` is a Triangles table (host numpy or device tensors) with
    the scene's topology and moved vertices and normals; it goes to the
    scene's device once and stays there if it already lies there.
    ``transform`` (a core.transform.Transform) then moves it on the
    device, and the frame's clusters are rebuilt there (accel/morton.py,
    ``LEAF_TRIS`` triangles a cluster) and grouped into the sweep's supers
    (``GROUP`` clusters each) without a host round trip. Scenes of
    ``BRUTE_FORCE_MAX_TRIS`` or fewer triangles get no tables: they
    intersect the moved triangles by brute force, as a scene built from
    them would. ``accel`` skips the rebuild, for geometry whose tables do
    not move from frame to frame (the JAX package's route of huge static
    scenes): SweepTables or a ClusterAccel (host arrays go to the card at
    the first frame, :func:`apply_geometry`), or a SweepAccelerator or
    ClusterAccelerator, whose device tensors the frame uses as they are.

    Returns None for no geometry, else (Triangles, tables or accelerator,
    or None) for :func:`apply_geometry`. Raises ValueError for a transform
    without geometry, a transform with pre-built tables (they would be
    stale), or a triangle count other than the scene's; TypeError for an
    ``accel`` of another kind."""
    if geometry is None:
        if transform is not None:
            raise ValueError("geometry_transform requires geometry")
        return None
    n = tri_mod.num_triangles(geometry)
    if n != scene.n_triangles:
        raise ValueError(f"animated geometry must keep the scene's topology: "
                         f"{n} triangles, the scene has {scene.n_triangles}")
    tris = tri_mod.to_device(geometry, scene.device)
    if accel is not None:
        if transform is not None:
            raise ValueError("geometry_transform requires a device rebuild; "
                             "omit geometry_accel")
        if not isinstance(accel, GEOMETRY_ACCELS):
            raise TypeError(f"geometry_accel: SweepTables, a ClusterAccel, a "
                            f"SweepAccelerator or a ClusterAccelerator, not "
                            f"{type(accel).__name__}")
        return tris, accel
    if transform is not None:
        tris = tri_mod.transform_triangles(tris, transform)
    if n <= BRUTE_FORCE_MAX_TRIS:
        return tris, None
    return tris, SweepTables(build_clusters_device(tris, LEAF_TRIS), GROUP)


GEOMETRY_ACCELS = (SweepTables, ClusterAccel, SweepAccelerator,
                   ClusterAccelerator)


def geometry_knobs(scene, acc) -> dict:
    """The tiling a frame's accelerator takes from the scene's attributes,
    as in the JAX package: for the sweep ``anim_block_rays`` and
    ``anim_ray_chunk`` (unset: the port's BLOCK_RAYS and RAY_CHUNK; JAX's
    are 128 and 8192, ROADMAP §C); for clusters ``anim_stage_clusters``
    (unset: 128 from 200,000 triangles, else 64) and ``anim_ray_chunk``
    (unset: 16384). Both certify with the scene's ``exact_shared_edges``."""
    cert = bool(scene.exact_edges)
    chunk = getattr(scene, "anim_ray_chunk", None)
    if isinstance(acc, (SweepTables, SweepAccelerator)):
        return dict(block_rays=getattr(scene, "anim_block_rays", None)
                    or BLOCK_RAYS, ray_chunk=chunk or RAY_CHUNK,
                    certified=cert)
    clusters = acc.clusters if isinstance(acc, ClusterAccelerator) else acc
    n_tris = clusters.tri_id.shape[0] * clusters.leaf_tris
    return dict(stage_clusters=getattr(scene, "anim_stage_clusters", None)
                or (128 if n_tris >= 200_000 else 64),
                ray_chunk=chunk or 16384, certified=cert)


def _on_host(tables) -> bool:
    arr = tables.panel if isinstance(tables, SweepTables) else tables.c_lo
    return not torch.is_tensor(arr)


def geometry_accelerator(scene, acc):
    """The frame's accelerator over ``acc`` (a :func:`prepare_geometry`
    pair's second item) with :func:`geometry_knobs`. A caller's
    accelerator gives a view that shares its device tensors. Host tables
    go to the card once: the accelerator built over them is kept on the
    scene (``geometry_cache``, the last one only) and serves every later
    frame with the same tables and knobs."""
    knobs = geometry_knobs(scene, acc)
    if isinstance(acc, (SweepAccelerator, ClusterAccelerator)):
        return acc.view(**knobs)
    if not _on_host(acc):
        return _build_accelerator(scene, acc, knobs)
    cached = scene.geometry_cache
    if cached is not None and cached[0] is acc and cached[1] == knobs:
        return cached[2]
    scene.geometry_cache = None   # free the old tables before the upload
    built = _build_accelerator(scene, acc, knobs)
    scene.geometry_cache = (acc, knobs, built)
    return built


def _build_accelerator(scene, acc, knobs):
    if isinstance(acc, SweepTables):
        return SweepAccelerator(acc, scene.device, **knobs)
    return ClusterAccelerator(acc, scene.device, **knobs)


def apply_geometry(scene, geom):
    """The scene view that :func:`prepare_geometry`'s pair renders: the
    moved triangles and the frame's accelerator
    (:func:`geometry_accelerator`; Scene.with_geometry). None gives the
    scene itself."""
    if geom is None:
        return scene
    tris, acc = geom
    return scene.with_geometry(
        tris, None if acc is None else geometry_accelerator(scene, acc))
