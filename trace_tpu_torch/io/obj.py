"""Minimal Wavefront OBJ loader (port of trace_tpu/io/obj.py; numpy
only): v / vn / vt / f, fan triangulation.

Handles 'f v', 'f v/vt', 'f v//vn' and 'f v/vt/vn' face encodings with
positive or negative (relative) indices; per-face-vertex normals and uvs
are re-indexed onto unique (v, vt, vn) triples so indexed meshes stay
indexed.
"""
from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Parse an OBJ file -> dict(vertices [V,3] f32, normals [V,3]|None,
    uv [V,2]|None, indices [F,3] int64)."""
    positions: list[list[float]] = []
    normals: list[list[float]] = []
    uvs: list[list[float]] = []
    corners: list[tuple[int, int, int]] = []  # (v, vt, vn), -1 = absent
    faces: list[list[int]] = []
    corner_index: dict[tuple[int, int, int], int] = {}

    def resolve(idx: int, count: int) -> int:
        return idx - 1 if idx > 0 else count + idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                face = []
                for tok in parts[1:]:
                    comp = tok.split("/")
                    v = resolve(int(comp[0]), len(positions))
                    vt = (
                        resolve(int(comp[1]), len(uvs))
                        if len(comp) > 1 and comp[1] else -1
                    )
                    vn = (
                        resolve(int(comp[2]), len(normals))
                        if len(comp) > 2 and comp[2] else -1
                    )
                    key = (v, vt, vn)
                    if key not in corner_index:
                        corner_index[key] = len(corners)
                        corners.append(key)
                    face.append(corner_index[key])
                for i in range(1, len(face) - 1):  # fan triangulation
                    faces.append([face[0], face[i], face[i + 1]])

    pos = np.asarray(positions, np.float32)
    out_v = np.asarray([pos[c[0]] for c in corners], np.float32)
    out_n = None
    if normals and all(c[2] >= 0 for c in corners):
        nrm = np.asarray(normals, np.float32)
        out_n = np.asarray([nrm[c[2]] for c in corners], np.float32)
    out_uv = None
    if uvs and all(c[1] >= 0 for c in corners):
        uvv = np.asarray(uvs, np.float32)
        out_uv = np.asarray([uvv[c[1]] for c in corners], np.float32)
    return dict(
        vertices=out_v, normals=out_n, uv=out_uv,
        indices=np.asarray(faces, np.int64),
    )


def load_triangle_mesh(path: str, object_to_world, material_id: int = 0):
    """Load an OBJ straight into the port's packed Triangles (host
    arrays), as io/ply.py does for a PLY."""
    from ..shapes.triangle import pack_triangle_mesh

    mesh = load_obj(path)
    return pack_triangle_mesh(
        object_to_world, mesh["indices"], mesh["vertices"],
        normals=mesh["normals"], uv=mesh["uv"], material_id=material_id,
    )
