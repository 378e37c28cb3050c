"""Integrator helpers shared across integrators (port of the parts of
trace_tpu/integrators/common.py that the port's integrators use): the
lights' power distribution, and the animated-geometry pair
(``prepare_geometry`` / ``apply_geometry``)."""
from __future__ import annotations

import numpy as np

from ..accel.morton import build_clusters_device
from ..lights import lights as light_mod
from ..ops.sweep import SweepAccelerator, SweepTables
from ..scene import BRUTE_FORCE_MAX_TRIS, GROUP, LEAF_TRIS
from ..shapes import triangle as tri_mod


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
    """One frame's triangles and sweep tables, built on the scene's device.

    ``geometry`` is a Triangles table (host numpy or device tensors) with
    the scene's topology and moved vertices and normals; it goes to the
    scene's device once and stays there if it already lies there.
    ``transform`` (a core.transform.Transform) then moves it on the
    device, and the frame's clusters are rebuilt there (accel/morton.py,
    ``LEAF_TRIS`` triangles a cluster) and grouped into the sweep's supers
    (``GROUP`` clusters each) without a host round trip. Scenes of
    ``BRUTE_FORCE_MAX_TRIS`` or fewer triangles get no tables: they
    intersect the moved triangles by brute force, as a scene built from
    them would. ``accel`` (a SweepTables or a SweepAccelerator, whose
    tables are taken) skips the rebuild: pre-built tables for geometry
    that does not move from frame to frame.

    Returns None for no geometry, else (Triangles, SweepTables or None)
    for :func:`apply_geometry`. Raises ValueError for a transform without
    geometry, a transform with pre-built tables (they would be stale), or
    a triangle count other than the scene's."""
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
        tables = accel.tables if isinstance(accel, SweepAccelerator) \
            else accel
        if not isinstance(tables, SweepTables):
            raise TypeError(f"geometry_accel: a SweepTables or a "
                            f"SweepAccelerator, not {type(accel).__name__}")
        return tris, tables
    if transform is not None:
        tris = tri_mod.transform_triangles(tris, transform)
    if n <= BRUTE_FORCE_MAX_TRIS:
        return tris, None
    return tris, SweepTables(build_clusters_device(tris, LEAF_TRIS), GROUP)


def apply_geometry(scene, geom):
    """The scene view that :func:`prepare_geometry`'s pair renders: the
    moved triangles and a sweep over the frame's tables, with the scene's
    block, chunk and ``exact_shared_edges`` certification
    (Scene.with_geometry). None gives the scene itself."""
    if geom is None:
        return scene
    tris, tables = geom
    return scene.with_geometry(
        tris, None if tables is None else scene.sweep(tables))
