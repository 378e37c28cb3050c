"""Triangle-mesh-heavy scene (port of trace_tpu/models/mesh_heavy.py): a
procedural heightfield of ~``target_tris`` triangles with a matte
Oren-Nayar ground (sigma 20), one smooth glass sphere and a point light.

    python -m trace_tpu_torch.models.mesh_heavy --resolution 256 --spp 1 \
        --depth 2
"""
from __future__ import annotations

import numpy as np

from ..camera.perspective import PerspectiveCamera
from ..core import transform as T
from ..film.film import Film
from ..film.filters import LanczosSincFilter
from ..lights.lights import point_light
from ..materials.materials import GlassMaterial, MatteMaterial
from ..scene import Scene, SceneBuilder


def heightfield(n: int):
    """Wavy terrain: [n, n] vertices over [-10, 10]^2, 2 (n-1)^2 triangles."""
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


def build_scene(target_tris: int = 1_000_000, device="cuda",
                terrain_to_world=None, **build_kw) -> Scene:
    """``terrain_to_world`` places the heightfield (identity by default);
    ``build_kw`` goes to SceneBuilder.build (``exact_shared_edges``)."""
    n = int(np.sqrt(target_tris / 2)) + 1
    verts, tris = heightfield(n)
    b = SceneBuilder()
    ground = b.material(MatteMaterial(Kd=(0.55, 0.5, 0.4), sigma=20.0))
    glass = b.material(GlassMaterial(index=1.5))
    b.triangle_mesh(terrain_to_world or T.identity(), tris, verts, ground)
    b.sphere(T.translate([0.0, 2.0, 0.0]), 1.0, glass)
    b.light(point_light(T.translate([4.0, 8.0, 4.0]), (400.0, 400.0, 400.0)))
    return b.build(device=device, **build_kw)


def build_camera(resolution: int = 512, filename: str = "terrain.png",
                 convention: str = "reference"):
    film = Film((resolution, resolution),
                filter=LanczosSincFilter((1.0, 1.0), 3.0), filename=filename)
    # Frames the terrain under the reference-faithful telephoto projection.
    return PerspectiveCamera(
        T.look_at([0.0, 400.0, 1100.0], [-11.681, -12.619, 0.0],
                  [0.0, 1.0, 0.0]),
        screen_window=((-1.0, -1.0), (1.0, 1.0)),
        lens_radius=0.0, focal_distance=1e6, fov=90.0, film=film,
        convention=convention)


if __name__ == "__main__":
    from ._run import whitted_main

    whitted_main(__doc__, build_scene, build_camera, resolution=512, spp=4,
                 depth=2, output="terrain.png")
