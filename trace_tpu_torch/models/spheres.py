"""The reference's flagship "shadows" scene (port of
trace_tpu/models/spheres.py): four spheres (glass, matte blue, mirror,
matte red) over a mirror floor and a white back wall, one point light.

    python -m trace_tpu_torch.models.spheres

renders the reference's hero config (SPPM 1024^2, 100 iterations,
initial radius 0.025, depth 5) to shadows.png, as the JAX package's
script does; ``--resolution 32 --iterations 2 --device cpu`` is a quick
run without a card.
"""
from __future__ import annotations

import numpy as np

from ..camera.perspective import PerspectiveCamera
from ..core import transform as T
from ..film.film import Film
from ..film.filters import LanczosSincFilter
from ..lights.lights import point_light
from ..materials.materials import GlassMaterial, MatteMaterial, MirrorMaterial
from ..scene import Scene, SceneBuilder

# Whitted queue capacities of bench config 1 (bench.py:245-312).
LEVEL_CAPS = (0.5, 0.25, 0.1875, 0.125)


def build_scene(device="cuda", **build_kw) -> Scene:
    """``build_kw`` goes to SceneBuilder.build (``exact_shared_edges``)."""
    b = SceneBuilder()
    red = b.material(MatteMaterial(Kd=(0.796, 0.235, 0.2), sigma=0.0))
    blue = b.material(MatteMaterial(Kd=(0.251, 0.388, 0.847), sigma=0.0))
    white = b.material(MatteMaterial(Kd=(1.0, 1.0, 1.0), sigma=0.0))
    mirror = b.material(MirrorMaterial(Kr=(1.0, 1.0, 1.0)))
    glass = b.material(GlassMaterial(
        Kr=(1.0, 1.0, 1.0), Kt=(1.0, 1.0, 1.0), u_roughness=0.0,
        v_roughness=0.0, index=1.5, remap_roughness=True))

    b.sphere(T.translate([0.3, 0.11, -2.2]), 0.1, glass)
    b.sphere(T.translate([0.2, 0.11, -2.6]), 0.1, blue)
    b.sphere(T.translate([0.7, 0.31, -2.8]), 0.3, mirror)
    b.sphere(T.translate([0.7, 0.11, -2.3]), 0.1, red)

    # Floor (mirror) and back wall (white).
    verts = np.array([[0, 0, 0], [0, 0, -1], [1, 0, -1],
                      [1, 0, 0], [0, 1, -1], [1, 1, -1]], np.float32)
    normals = np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0],
                        [0, 1, 0], [0, 0, 1], [0, 0, 1]], np.float32)
    o2w = T.translate([0.0, 0.0, -2.0])
    b.triangle_mesh(o2w, np.array([[0, 1, 2], [0, 3, 2]], np.uint32), verts,
                    mirror, normals=normals)
    b.triangle_mesh(o2w, np.array([[1, 2, 4], [5, 4, 2]], np.uint32), verts,
                    white, normals=normals)

    b.light(point_light(T.translate([-1.0, 1.0, 0.0]), (25.0, 25.0, 25.0)))
    return b.build(device=device, **build_kw)


def build_camera(resolution: int = 1024, filename: str = "shadows.png",
                 convention: str = "reference"):
    film = Film((resolution, resolution),
                filter=LanczosSincFilter((1.0, 1.0), 3.0), filename=filename)
    return PerspectiveCamera(
        T.look_at([0.0, 15.0, 50.0], [0.0, 0.0, -2.0], [0.0, 1.0, 0.0]),
        screen_window=((-1.0, -1.0), (1.0, 1.0)), shutter_open=0.0,
        shutter_close=1.0, lens_radius=0.0, focal_distance=1e6, fov=90.0,
        film=film, convention=convention)


if __name__ == "__main__":
    from ._run import sppm_main

    # The reference's hero config: SPPM 1024^2, 100 iterations, initial
    # radius 0.025, depth 5, as the JAX package's script runs it. Bench
    # config 1's Whitted settings are chip_smoke.py's phase 5b.
    sppm_main(__doc__, build_scene, build_camera, resolution=1024,
              iterations=100, radius=0.025, depth=5, output="shadows.png")
