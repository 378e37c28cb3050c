"""Scene-as-code construction and the scene's device tables (port of
trace_tpu/scene.py).

``SceneBuilder.build(device)`` packs the spheres, triangles, lights and
materials on the host and moves every table the render reads onto
``device`` once: the card unless the caller asks for the CPU. Above 64
triangles (the JAX package's ``use_bvh`` threshold; ``use_bvh`` forces
either side) it attaches the sparse sweep (ops/sweep.py): the CUDA kernel
for a CUDA device, its plain PyTorch version on the CPU. Scenes of 1-64
triangles intersect them by brute force over the [rays, triangles] grid
(wavefront/geom.py, ``chunk_size`` triangles a pass), as the JAX package
does. ``accelerator="wbvh"`` walks an SAH tree per ray instead
(accel/wbvh.py: the CUDA walk kernel on a card), ``"clusters"`` sweeps the
tree's clusters in demand order (accel/clusters.py, tensor code).
``Scene.intersect`` / ``intersect_p`` / ``unoccluded`` /
``transmittance`` / ``area_light_radiance`` are the JAX Scene's ray
queries over the same routes the integrators take; they return the
port's planar hit records (wavefront/geom.py::HitP).
``exact_shared_edges=True`` makes shared mesh edges watertight: the sweep
runs its certified epilogue, the brute-force grid and the winner detail
phase the double-single edge fallback. A mesh given ``emission`` is a
diffuse area light; ``light(infinite_light(...))`` adds the environment
light, whose texel tables go to the device with the light table and whose
disk is the scene's bounding sphere. Image textures' mip tables go to the device
with the scene. ``instanced_mesh`` and ``instanced_spheres``
add many transformed copies of one base (accel/instances.py): the base is
stored once, each copy adds a row of a transform table, and the base's own
sweep tables (a mesh above 64 triangles) go to the device at build.
Primitive ids: spheres [0, S), triangles [S, S + T), then I * n_base ids
per instanced geometry, in the order they were added.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from .accel import clusters as clusters_mod
from .accel import instances as inst_mod
from .accel import wbvh as wbvh_mod
from .core.ray import SPAWN_EPS
from .core.vec import V3
from .lights import lights as light_mod
from .materials import textures
from .ops.sweep import SweepAccelerator, SweepTables
from .shapes import sphere as sph_mod
from .shapes import triangle as tri_mod
from .wavefront import geom as G
from .wavefront import lights as WL
from .wavefront import materials as WM

# Sweep geometry: leaf 64 x group 8 = 512 triangles per super (the JAX
# package's kernel tuning). 32 rays per block: on an H100 (700 W), one
# call, the one-warp kernel took 7.7 ms on a 1M-triangle frame's 65536
# camera rays at 32 rays a block, 9.8 at 64, 15.0 at 128 and 21.7 at 256
# -- a smaller block enters fewer supers. The kernel now runs 16 warps
# per 32 rays (csrc/sweep.cu) and serves that block only: a CTA of 64
# rays would not fit an SM's registers. Up to 65536 rays per launch.
LEAF_TRIS = 64
GROUP = 8
BLOCK_RAYS = 32
RAY_CHUNK = 65536
MAX_PRIMS_PER_LEAF = 4
BRUTE_FORCE_MAX_TRIS = 64
CHUNK_SIZE = 2048
# SceneBuilder.build's accelerators: the JAX package's names. The sweep
# serves "auto" and "pallas_sweep"; "wbvh" and "clusters" attach their own.
SWEEP_ACCELERATORS = ("auto", "pallas_sweep")
ACCELERATORS = SWEEP_ACCELERATORS + ("clusters", "wbvh")
# The cluster traversal's (leaf, stage) sizes switch at this triangle
# count (the JAX package's rule, trace_tpu/scene.py:168-171).
CLUSTERS_LARGE_TRIS = 300_000


def sweep_tables(tris, use_bvh: bool | None = None,
                 max_prims_per_leaf: int = MAX_PRIMS_PER_LEAF
                 ) -> SweepTables | None:
    """The sweep's tables (leaf 64 x group 8) for a triangle table above
    64 triangles, or for any with ``use_bvh=True``; None (the brute-force
    grid serves it) for 64 or fewer, for none, or with ``use_bvh=False``.
    ``max_prims_per_leaf``: the SAH build's leaf size."""
    n = tri_mod.num_triangles(tris)
    if use_bvh is None:
        use_bvh = n > BRUTE_FORCE_MAX_TRIS
    if not use_bvh or n == 0:
        return None
    return SweepTables(clusters_mod.build_clusters(tris, LEAF_TRIS,
                                                   max_prims_per_leaf), GROUP)


def make_sweep(tables: SweepTables, device, certified: bool
               ) -> SweepAccelerator:
    """The sweep over ``tables`` with the scene's block and chunk."""
    return SweepAccelerator(tables, device, block_rays=BLOCK_RAYS,
                            ray_chunk=RAY_CHUNK, certified=certified)


class SceneBuilder:
    """materials -> shapes -> lights -> build()."""

    def __init__(self):
        self._materials = []
        self._spheres = []
        self._tri_parts = []
        self._tri_light = []
        self._tri_count = 0
        self._lights = []
        self._instanced = []

    def material(self, mat) -> int:
        self._materials.append(mat)
        return len(self._materials) - 1

    def sphere(self, object_to_world, radius, material: int, **kw) -> None:
        self._spheres.append(dict(object_to_world=object_to_world,
                                  radius=radius, material_id=material, **kw))

    def triangle_mesh(self, object_to_world, indices, vertices,
                      material: int, normals=None, uv=None,
                      reverse_orientation=False, emission=None,
                      two_sided=False) -> None:
        """Add an indexed mesh; with ``emission`` it is also a diffuse
        area light over its triangles."""
        part = tri_mod.pack_triangle_mesh(
            object_to_world, indices, vertices, normals=normals, uv=uv,
            material_id=material, reverse_orientation=reverse_orientation)
        n = tri_mod.num_triangles(part)
        light_id = -1
        if emission is not None:
            light_id = len(self._lights)
            self._lights.append(light_mod.area_light(
                emission, self._tri_count, n, two_sided))
        self._tri_parts.append(part)
        self._tri_light.append(np.full(n, light_id, np.int32))
        self._tri_count += n

    def instanced_mesh(self, indices, vertices, transforms, material: int,
                       normals=None, uv=None, material_ids=None) -> None:
        """Copies of one mesh under ``transforms`` (core.transform
        Transforms), the mesh stored once; ``material_ids`` [I] overrides
        the material per copy (-1 keeps ``material``). Instanced geometry
        carries no area-light emission."""
        self._instanced.append(inst_mod.build_instances(
            indices, vertices, transforms, material_id=material,
            normals=normals, uv=uv, material_ids=material_ids))

    def instanced_spheres(self, entries, transforms,
                          material_ids=None) -> None:
        """Copies of one sphere array (dicts of ``sphere``'s arguments,
        with ``object_to_world``, ``radius``, ``material_id`` and the
        clipping keys) under ``transforms``."""
        self._instanced.append(inst_mod.build_sphere_instances(
            entries, transforms, material_ids=material_ids))

    def light(self, entry: dict) -> None:
        self._lights.append(entry)

    def build(self, device="cuda", exact_shared_edges: bool = False,
              chunk_size: int = CHUNK_SIZE, use_bvh: bool | None = None,
              max_prims_per_leaf: int = MAX_PRIMS_PER_LEAF,
              accelerator: str = "auto") -> "Scene":
        """The scene on ``device``. ``use_bvh``: None attaches the sweep
        above 64 triangles, True at any count, False never (brute force,
        ``chunk_size`` triangles a pass). ``accelerator``: "auto" or
        "pallas_sweep" (the sweep), "wbvh" (the per-ray BVH walk) or
        "clusters" (the cluster traversal: leaf 32 and stage 64 below
        300k triangles, else leaf 64 and stage 128), wherever ``use_bvh``
        gives the scene an accelerator."""
        if accelerator not in ACCELERATORS:
            raise ValueError(f"unknown accelerator {accelerator!r}")
        spheres = sph_mod.pack_spheres(self._spheres)
        tris = tri_mod.concat_triangles(self._tri_parts)
        tri_light = (np.concatenate(self._tri_light) if self._tri_light
                     else np.zeros(0, np.int32))
        lights = light_mod.pack_lights(self._lights, tris)
        n = tri_mod.num_triangles(tris)
        own = (accelerator not in SWEEP_ACCELERATORS and n > 0
               and (n > BRUTE_FORCE_MAX_TRIS if use_bvh is None else use_bvh))
        scene = Scene(spheres, tris, self._materials, lights, device,
                      sweep_tables=None if own else sweep_tables(
                          tris, use_bvh, max_prims_per_leaf),
                      exact_edges=exact_shared_edges, tri_light_id=tri_light,
                      instanced=self._instanced, chunk_size=chunk_size,
                      brute_force=use_bvh is False or own)
        if own and accelerator == "wbvh":
            wbvh_mod.attach(scene, max_prims_per_leaf=max_prims_per_leaf)
        elif own:
            leaf, stage = (32, 64) if n < CLUSTERS_LARGE_TRIS else (64, 128)
            clusters_mod.attach(scene, leaf_tris=leaf, stage_clusters=stage,
                                max_prims_per_leaf=max_prims_per_leaf)
        return scene


class Scene:
    def __init__(self, spheres, triangles, materials, lights, device,
                 sweep_tables: SweepTables | None = None,
                 exact_edges: bool = False, tri_light_id=None,
                 instanced=(), chunk_size: int = CHUNK_SIZE,
                 brute_force: bool = False):
        self.device = torch.device(device)
        self.exact_edges = bool(exact_edges)
        self.chunk_size = int(chunk_size)
        self.spheres = spheres
        self.materials = list(materials)
        WM.check_materials(self.materials)
        textures.upload(self.materials, self.device)
        self.n_spheres = sph_mod.num_spheres(spheres)
        self.n_triangles = tri_mod.num_triangles(triangles)
        if self.n_triangles > BRUTE_FORCE_MAX_TRIS and sweep_tables is None \
                and not brute_force:
            raise ValueError("more than 64 triangles need the sweep tables "
                             "(or brute_force=True)")
        dev = self.device
        self.sphere_cols = (G.sphere_cols(spheres, dev)
                            if self.n_spheres else None)
        self.sphere_rows = torch.from_numpy(G.sphere_rows(spheres)).to(dev)
        self._set_geometry(triangles, None if sweep_tables is None
                           else self.sweep(sweep_tables))
        self.instanced = [g.to(dev) for g in instanced]
        self.instanced_offsets = []
        off = self.n_spheres + self.n_triangles
        for g in self.instanced:
            self.instanced_offsets.append(off)
            off += g.n_instances * g.n_base

        bounds = []
        if self.n_spheres:
            bounds.append(sph_mod.world_bounds_np(spheres))
        if self.n_triangles:
            bounds.append(tri_mod.world_bounds_np(triangles))
        for g in self.instanced:
            bounds.append(g.world_bounds_np())
        if bounds:
            allb = np.concatenate(bounds, axis=0)
            lo, hi = allb[:, 0].min(0), allb[:, 1].max(0)
        else:
            lo = hi = np.zeros(3, np.float32)
        self.world_lo, self.world_hi = lo, hi
        if tri_light_id is None:
            tri_light_id = np.full(self.n_triangles, -1, np.int32)
        self.tri_light_id = torch.from_numpy(
            np.asarray(tri_light_id, np.int32).reshape(-1)).to(dev)
        self.set_lights(light_mod.preprocess(lights, *self.bounding_sphere()))
        self._version = 0
        # The accelerator over the last host tables a frame was given
        # (integrators/common.py::geometry_accelerator).
        self.geometry_cache = None

    @property
    def triangles_host(self) -> tri_mod.Triangles:
        """The triangle table as host numpy arrays (the JAX Scene's
        ``triangles_host``; a device table is read back)."""
        return tri_mod.to_numpy(self.triangles)

    def bump_version(self) -> None:
        """Call after changing the scene in place (its lights, accelerator
        or geometry): what holds work captured for the scene, a fused SPPM
        block's CUDA graphs (integrators/fused.py), captures it anew."""
        self._version += 1

    def bounding_sphere(self):
        """(center [3], radius) of the scene's world bounds, the sphere a
        light table is preprocessed against."""
        center = (self.world_lo + self.world_hi) / 2
        return center, float(np.linalg.norm(self.world_hi - center))

    def sweep(self, tables: SweepTables) -> SweepAccelerator:
        """The scene's sweep over ``tables``, with its block, chunk and
        certification."""
        return make_sweep(tables, self.device, self.exact_edges)

    def _set_geometry(self, triangles, accel) -> None:
        """Install a triangle table (host or device) and its accelerator,
        with the detail rows and brute-force columns built from it."""
        dev = self.device
        self.triangles = triangles
        self.triangle_rows = G.triangle_rows(triangles, dev)
        self.triangle_cols = (G.triangle_cols(triangles, dev)
                              if self.n_triangles else None)
        self.accel = accel
        self.area_tables = {}   # per area-light window (wavefront/lights.py)

    def set_lights(self, lights: light_mod.Lights) -> None:
        """Install a preprocessed light table in place, with the tables
        derived from it (the emission rows, the environment light's
        texels, the area-light windows)."""
        self.lights = lights
        self.max_area_tris = int(lights.tri_count.max(initial=0))
        self.light_rows = torch.from_numpy(WL.light_rows(lights)).to(
            self.device)
        self.env = WL.device_env(lights, self.device)
        self.area_tables = {}

    def with_lights(self, lights: light_mod.Lights) -> "Scene":
        """A shallow view of this scene with the light table swapped (a
        frame's relight), its environment texels with it; the scene
        itself is unchanged."""
        view = copy.copy(self)
        view.set_lights(lights)
        return view

    def with_geometry(self, triangles, accelerator=None, *,
                      accel=None) -> "Scene":
        """A shallow view with the triangle table (same topology, moved
        vertices, usually device tensors) and its accelerator swapped: one
        frame of animated geometry (integrators/common.py). World bounds,
        materials and the light table stay the base scene's, as in the JAX
        package; the area-light windows are rebuilt from the moved
        triangles. ``accel`` is another name for ``accelerator``."""
        if accel is not None:
            if accelerator is not None:
                raise TypeError("with_geometry: give accelerator or accel")
            accelerator = accel
        view = copy.copy(self)
        view._set_geometry(triangles, accelerator)
        return view

    # -- ray queries (the JAX Scene's, over the integrators' routes) ------

    def intersect(self, o, d, t_max, time=None) -> G.HitP:
        """Closest hit over the scene -> the planar hit record (HitP).
        o, d: [N, 3]; t_max: [N]. Sources are reduced in the JAX order,
        spheres, triangles, then each instanced geometry, and where they
        tie the earlier one wins."""
        from .wavefront import whitted as WF

        if time is None:
            time = torch.zeros(o.shape[0], dtype=torch.float32,
                               device=o.device)
        return WF.closest_hit(self, V3.of(o), V3.of(d), t_max, time)

    def intersect_p(self, o, d, t_max) -> torch.Tensor:
        """Any-hit occlusion [N] bool: some source hits within t_max."""
        from .wavefront import whitted as WF

        return WF.any_hit(self, V3.of(o), V3.of(d), t_max)

    def unoccluded(self, p0, p1, time=None, n_geom=None) -> torch.Tensor:
        """Shadow-ray test p0 -> p1 [N] bool: a ray along the unnormalised
        p1 - p0 with t_max 1 - 1e-4, its origin moved by 1e-6 of it and,
        with ``n_geom`` ([N, 3], the surface's geometric normal), nudged
        along the normal by a scale-aware epsilon (PBRT's spawn)."""
        from .wavefront import whitted as WF

        a, b = V3.of(p0), V3.of(p1)
        if n_geom is not None:
            return WF.unoccluded(self, a, b, V3.of(n_geom))
        d = b - a
        t_max = torch.full(a.x.shape, WF.SHADOW_T_MAX, dtype=torch.float32,
                           device=a.x.device)
        return ~WF.any_hit(self, a + d * SPAWN_EPS, d, t_max)

    def transmittance(self, p0, p1, time=None) -> torch.Tensor:
        """Beam transmittance [N, 3] between two points: every primitive
        carries a material, so the reference's walk over hits reduces to
        1 where unoccluded and 0 elsewhere."""
        vis = self.unoccluded(p0, p1, time)
        return torch.where(vis[:, None], 1.0, 0.0).repeat(1, 3)

    def area_light_radiance(self, hit: G.HitP, wo) -> torch.Tensor:
        """Emitted radiance [N, 3] toward ``wo`` ([N, 3] or V3) at hits on
        emissive triangles, zero elsewhere."""
        if not isinstance(wo, V3):
            wo = V3.of(wo)
        return WL.area_light_radiance(self, hit, wo).arr()
