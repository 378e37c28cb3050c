"""Sphere table packing (port of the host half of
trace_tpu/shapes/sphere.py). Intersection lives in wavefront/geom.py."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Spheres(NamedTuple):
    o2w: np.ndarray          # [S, 4, 4] object-to-world
    w2o: np.ndarray          # [S, 4, 4]
    radius: np.ndarray       # [S]
    z_min: np.ndarray
    z_max: np.ndarray
    theta_min: np.ndarray
    theta_max: np.ndarray
    phi_max: np.ndarray      # radians
    material_id: np.ndarray  # [S] int32
    flip_normal: np.ndarray  # [S] bool (reverse_orientation)


def pack_spheres(entries) -> Spheres:
    """Dicts with object_to_world, radius, material_id and optional
    z_min, z_max, phi_max (degrees), reverse_orientation."""
    if not entries:
        return Spheres(*[np.zeros((0, 4, 4), np.float32)] * 2,
                       *[np.zeros((0,), np.float32)] * 6,
                       np.zeros((0,), np.int32), np.zeros((0,), bool))
    cols = {k: [] for k in Spheres._fields}
    for e in entries:
        t = e["object_to_world"]
        r = float(e["radius"])
        zlo, zhi = e.get("z_min", -r), e.get("z_max", r)
        zmin = float(np.clip(min(zlo, zhi), -r, r))
        zmax = float(np.clip(max(zlo, zhi), -r, r))
        cols["o2w"].append(np.asarray(t.m, np.float32))
        cols["w2o"].append(np.asarray(t.inv_m, np.float32))
        cols["radius"].append(r)
        cols["z_min"].append(zmin)
        cols["z_max"].append(zmax)
        cols["theta_min"].append(float(np.arccos(np.clip(zmin / r, -1, 1))))
        cols["theta_max"].append(float(np.arccos(np.clip(zmax / r, -1, 1))))
        cols["phi_max"].append(
            float(np.deg2rad(np.clip(e.get("phi_max", 360.0), 0, 360))))
        cols["material_id"].append(int(e["material_id"]))
        cols["flip_normal"].append(bool(e.get("reverse_orientation", False)))
    return Spheres(
        np.stack(cols["o2w"]), np.stack(cols["w2o"]),
        *[np.asarray(cols[k], np.float32) for k in
          ("radius", "z_min", "z_max", "theta_min", "theta_max", "phi_max")],
        np.asarray(cols["material_id"], np.int32),
        np.asarray(cols["flip_normal"], bool),
    )


def num_spheres(s: Spheres) -> int:
    return s.radius.shape[0]


def area(sph: Spheres) -> np.ndarray:
    """Surface area of each sphere, phi_max r (z_max - z_min)."""
    return sph.phi_max * sph.radius * (sph.z_max - sph.z_min)


def world_bounds_np(s: Spheres) -> np.ndarray:
    """World AABBs [S, 2, 3]."""
    n = num_spheres(s)
    out = np.zeros((n, 2, 3), np.float32)
    for i in range(n):
        r = s.radius[i]
        corners = np.array(
            [[x, y, z] for x in (-r, r) for y in (-r, r)
             for z in (s.z_min[i], s.z_max[i])], np.float32)
        w = corners @ s.o2w[i][:3, :3].T + s.o2w[i][:3, 3]
        out[i, 0] = w.min(0)
        out[i, 1] = w.max(0)
    return out
