"""Scene-as-code construction and the scene's device tables (port of
trace_tpu/scene.py).

``SceneBuilder.build(device)`` packs the spheres, triangles, lights and
materials on the host and moves every table the render reads onto
``device`` once. Above 64 triangles it attaches the sparse sweep
(ops/sweep.py): the CUDA kernel for a CUDA device, its plain PyTorch
version on the CPU. Smaller meshes need the brute-force triangle path,
which is not ported yet. ``exact_shared_edges=True`` makes shared mesh
edges watertight: the sweep runs its certified epilogue, and the winner
detail phase keeps the sweep's mask and recomputes barycentrics with the
double-single edge fallback (wavefront/geom.py).
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.clusters import build_clusters
from .lights import lights as light_mod
from .ops.sweep import SweepAccelerator, SweepTables
from .shapes import sphere as sph_mod
from .shapes import triangle as tri_mod
from .wavefront import geom as G

# Sweep geometry: leaf 64 x group 8 = 512 triangles per super (the JAX
# package's kernel tuning). One CTA of 32 rays per block: on an H100
# (700 W), one call, the kernel took 7.7 ms on a 1M-triangle frame's
# 65536 camera rays at 32 rays a block, 9.8 at 64, 15.0 at 128 and 21.7
# at 256 -- a smaller block enters fewer supers, which outweighs the
# lower occupancy (32 KB of shared memory per CTA). Up to 65536 rays per
# launch; the [chunk, supers] entry table is then ~0.7 GB at 1M triangles.
LEAF_TRIS = 64
GROUP = 8
BLOCK_RAYS = 32
RAY_CHUNK = 65536
MAX_PRIMS_PER_LEAF = 4


class SceneBuilder:
    """materials -> shapes -> lights -> build()."""

    def __init__(self):
        self._materials = []
        self._spheres = []
        self._tri_parts = []
        self._lights = []

    def material(self, mat) -> int:
        self._materials.append(mat)
        return len(self._materials) - 1

    def sphere(self, object_to_world, radius, material: int, **kw) -> None:
        self._spheres.append(dict(object_to_world=object_to_world,
                                  radius=radius, material_id=material, **kw))

    def triangle_mesh(self, object_to_world, indices, vertices,
                      material: int, normals=None, uv=None,
                      reverse_orientation=False) -> None:
        self._tri_parts.append(tri_mod.pack_triangle_mesh(
            object_to_world, indices, vertices, normals=normals, uv=uv,
            material_id=material, reverse_orientation=reverse_orientation))

    def light(self, entry: dict) -> None:
        self._lights.append(entry)

    def build(self, device="cpu", exact_shared_edges: bool = False
              ) -> "Scene":
        spheres = sph_mod.pack_spheres(self._spheres)
        tris = tri_mod.concat_triangles(self._tri_parts)
        lights = light_mod.pack_lights(self._lights)
        tables = None
        if tri_mod.num_triangles(tris):
            tables = SweepTables(
                build_clusters(tris, LEAF_TRIS, MAX_PRIMS_PER_LEAF), GROUP)
        return Scene(spheres, tris, self._materials, lights, device,
                     sweep_tables=tables, exact_edges=exact_shared_edges)


class Scene:
    def __init__(self, spheres, triangles, materials, lights, device,
                 sweep_tables: SweepTables | None = None,
                 exact_edges: bool = False):
        self.device = torch.device(device)
        self.exact_edges = bool(exact_edges)
        self.spheres = spheres
        self.triangles = triangles
        self.materials = list(materials)
        self.n_spheres = sph_mod.num_spheres(spheres)
        self.n_triangles = tri_mod.num_triangles(triangles)
        if 0 < self.n_triangles <= 64 or (self.n_triangles > 0) != (
                sweep_tables is not None):
            raise NotImplementedError(
                "triangles need the sweep tables, and more than 64 of them "
                "(brute-force triangles are not ported yet)")
        dev = self.device
        self.sphere_cols = (G.sphere_cols(spheres, dev)
                            if self.n_spheres else None)
        self.sphere_rows = torch.from_numpy(G.sphere_rows(spheres)).to(dev)
        self.triangle_rows = torch.from_numpy(
            G.triangle_rows(triangles)).to(dev)
        self.accel = (None if sweep_tables is None else SweepAccelerator(
            sweep_tables, dev, block_rays=BLOCK_RAYS, ray_chunk=RAY_CHUNK,
            certified=self.exact_edges))

        bounds = []
        if self.n_spheres:
            bounds.append(sph_mod.world_bounds_np(spheres))
        if self.n_triangles:
            bounds.append(tri_mod.world_bounds_np(triangles))
        if bounds:
            allb = np.concatenate(bounds, axis=0)
            lo, hi = allb[:, 0].min(0), allb[:, 1].max(0)
        else:
            lo = hi = np.zeros(3, np.float32)
        self.world_lo, self.world_hi = lo, hi
        center = (lo + hi) / 2
        self.lights = light_mod.preprocess(
            lights, center, float(np.linalg.norm(hi - center)))
