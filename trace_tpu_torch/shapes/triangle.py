"""Triangle table packing (port of the host half of
trace_tpu/shapes/triangle.py). Vertices are transformed to world space
at build time; intersection lives in ops/sweep.py and wavefront/geom.py.

A scene's table is host numpy. Animated geometry holds the same fields as
device tensors (``to_device``): the base mesh stays resident and each
frame moves it there (``transform_triangles``)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Triangles(NamedTuple):
    """Host numpy arrays, or tensors on one device (``to_device``)."""
    v0: np.ndarray           # [T, 3] world-space vertices
    v1: np.ndarray
    v2: np.ndarray
    n0: np.ndarray           # [T, 3] per-vertex normals (zeros if none)
    n1: np.ndarray
    n2: np.ndarray
    uv0: np.ndarray          # [T, 2]
    uv1: np.ndarray
    uv2: np.ndarray
    has_normals: np.ndarray  # [T] bool
    material_id: np.ndarray  # [T] int32
    flip_normal: np.ndarray  # [T] bool


def pack_triangle_mesh(object_to_world, indices, vertices, normals=None,
                       uv=None, material_id: int = 0,
                       reverse_orientation: bool = False) -> Triangles:
    o2w = np.asarray(object_to_world.m, np.float32)
    inv = np.asarray(object_to_world.inv_m, np.float32)
    verts = np.asarray(vertices, np.float32)
    verts_w = verts @ o2w[:3, :3].T + o2w[:3, 3]
    idx = np.asarray(indices, np.int64).reshape(-1, 3)
    tcount = idx.shape[0]

    def gather(arr, k):
        return np.ascontiguousarray(arr[idx[:, k]], np.float32)

    if normals is not None:
        norms = np.asarray(normals, np.float32) @ inv[:3, :3]
        has_n = np.ones(tcount, bool)
    else:
        norms = np.zeros_like(verts)
        has_n = np.zeros(tcount, bool)

    def uv_at(k):
        if uv is not None:
            return np.ascontiguousarray(np.asarray(uv, np.float32)[idx[:, k]])
        default = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], np.float32)[k]
        return np.broadcast_to(default, (tcount, 2)).copy()

    swaps = bool(np.linalg.det(o2w[:3, :3]) < 0)
    return Triangles(
        gather(verts_w, 0), gather(verts_w, 1), gather(verts_w, 2),
        gather(norms, 0), gather(norms, 1), gather(norms, 2),
        uv_at(0), uv_at(1), uv_at(2),
        has_n, np.full((tcount,), material_id, np.int32),
        np.full(tcount, bool(reverse_orientation) ^ swaps),
    )


def concat_triangles(parts) -> Triangles:
    parts = [p for p in parts if p.v0.shape[0] > 0]
    if not parts:
        z3 = np.zeros((0, 3), np.float32)
        z2 = np.zeros((0, 2), np.float32)
        return Triangles(z3, z3, z3, z3, z3, z3, z2, z2, z2,
                         np.zeros((0,), bool), np.zeros((0,), np.int32),
                         np.zeros((0,), bool))
    if len(parts) == 1:
        return parts[0]
    return Triangles(*[np.concatenate(xs, axis=0) for xs in zip(*parts)])


def num_triangles(t: Triangles) -> int:
    return t.v0.shape[0]


def to_device(t: Triangles, device) -> Triangles:
    """The same table as tensors on ``device`` (a device table moves
    there, or stays)."""
    return Triangles(*[torch.as_tensor(x).to(device) for x in t])


def to_numpy(t: Triangles) -> Triangles:
    """A device table as host numpy arrays."""
    return Triangles(*[x.cpu().numpy() if torch.is_tensor(x)
                       else np.asarray(x) for x in t])


def transform_triangles(t: Triangles, transform) -> Triangles:
    """Move a device table by an affine Transform, on its device: vertices
    through the matrix, normals through the inverse transpose, in the JAX
    package's f32 component order (core/math.py mat3_apply and
    mat3_apply_t, then the translation). The matrix entries ride as host
    scalars, so only the frame's transform leaves the host. A transform
    that swaps handedness (det < 0) flips ``flip_normal``, keeping
    pack_triangle_mesh's invariant (flip = reverse_orientation XOR
    swaps_handedness)."""
    m = np.asarray(transform.m, np.float32)
    inv = np.asarray(transform.inv_m, np.float32)
    r = [[float(m[i, j]) for j in range(3)] for i in range(3)]
    ri = [[float(inv[i, j]) for j in range(3)] for i in range(3)]
    tr = [float(m[i, 3]) for i in range(3)]

    def pt(v):
        x, y, z = v.unbind(-1)
        return torch.stack([r[i][0] * x + r[i][1] * y + r[i][2] * z + tr[i]
                            for i in range(3)], -1)

    def nrm(v):
        x, y, z = v.unbind(-1)
        return torch.stack([ri[0][i] * x + ri[1][i] * y + ri[2][i] * z
                            for i in range(3)], -1)

    swaps = bool(np.linalg.det(m[:3, :3]) < 0)
    return t._replace(v0=pt(t.v0), v1=pt(t.v1), v2=pt(t.v2),
                      n0=nrm(t.n0), n1=nrm(t.n1), n2=nrm(t.n2),
                      flip_normal=t.flip_normal ^ swaps)


def world_bounds_np(t: Triangles) -> np.ndarray:
    """World AABBs [T, 2, 3]."""
    lo = np.minimum(np.minimum(t.v0, t.v1), t.v2)
    hi = np.maximum(np.maximum(t.v0, t.v1), t.v2)
    return np.stack([lo, hi], axis=1)
