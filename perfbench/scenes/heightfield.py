"""Frozen copy of the procedural heightfield of ``models/mesh_heavy.py``.

The benchmark owns its inputs: the program and the reference both take
their triangles from here, so a later change to the program's model
files cannot move the yardstick. Pure numpy, float32 vertices, uint32
indices; ``heightfield_grid`` gives the grid side for a triangle count.
"""
from __future__ import annotations

import numpy as np


def heightfield_grid(target_tris: int) -> int:
    """Vertices per side for about ``target_tris`` triangles: 708 for
    1,000,000 (999,698 triangles)."""
    return int(np.sqrt(target_tris / 2)) + 1


def heightfield(n: int):
    """Wavy terrain: [n, n] vertices over [-10, 10]^2, 2 (n-1)^2 triangles;
    triangle q < (n-1)^2 is (v00, v10, v01) of quad q, triangle
    (n-1)^2 + q is (v01, v10, v11), quads row-major over (i, j)."""
    xs = np.linspace(-10.0, 10.0, n, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = (0.6 * np.sin(0.7 * gx) * np.cos(0.9 * gz)
          + 0.25 * np.sin(2.3 * gx + 1.1) * np.sin(1.7 * gz + 0.3)
          ).astype(np.float32)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (ii * n + jj).reshape(-1)
    v01 = v00 + 1
    v10 = v00 + n
    v11 = v10 + 1
    tris = np.concatenate(
        [np.stack([v00, v10, v01], -1), np.stack([v01, v10, v11], -1)], axis=0)
    return verts, tris.astype(np.uint32)
