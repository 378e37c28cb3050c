"""Instanced sphere field (port of trace_tpu/models/sphere_field.py):
1024 transformed copies of ONE clipped sphere over a matte ground plane,
lit by a distant and a point light. The base sphere is stored once and
each copy adds a row of the instance table (accel/instances.py).

    python -m trace_tpu_torch.models.sphere_field --resolution 512 \
        --spp 4 --depth 3
"""
from __future__ import annotations

import numpy as np

from ..camera.perspective import PerspectiveCamera
from ..core import transform as T
from ..film.film import Film
from ..film.filters import LanczosSincFilter
from ..lights.lights import distant_light, point_light
from ..materials.materials import MatteMaterial, PlasticMaterial
from ..scene import Scene, SceneBuilder

GRID = 32  # 32 x 32 = 1024 instances


def field_transforms(n: int = GRID):
    """A jittered n x n grid over [-12, 12]^2 from one seeded generator:
    per instance a translation, a spin about y and a slight tilt about x
    (the tilt makes the z-clip cut each dome at another angle)."""
    rng = np.random.default_rng(41)
    xs = np.linspace(-12.0, 12.0, n, dtype=np.float32)
    out = []
    for i in range(n):
        for j in range(n):
            dx, dz = rng.uniform(-0.25, 0.25, 2)
            out.append(T.compose(
                T.translate([xs[i] + dx, 0.35, xs[j] + dz]),
                T.rotate_y(float(rng.uniform(0.0, 360.0))),
                T.rotate_x(float(rng.uniform(-25.0, 25.0)))))
    return out


def build_scene(n: int = GRID, device="cuda") -> Scene:
    b = SceneBuilder()
    ground = b.material(MatteMaterial(Kd=(0.45, 0.45, 0.48), sigma=15.0))
    shell = b.material(PlasticMaterial(Kd=(0.68, 0.26, 0.16),
                                       Ks=(0.35, 0.35, 0.35),
                                       roughness=0.08))
    # One base sphere, z-clipped to a dome, shared by every instance.
    base = dict(object_to_world=T.identity(), radius=0.35,
                z_min=-0.12, z_max=0.35, material_id=shell)
    b.instanced_spheres([base], field_transforms(n))

    gv = np.array([[-16, 0, 16], [16, 0, 16], [16, 0, -16], [-16, 0, -16]],
                  np.float32)
    b.triangle_mesh(T.identity(),
                    np.array([[0, 1, 2], [0, 2, 3]], np.uint32), gv, ground)

    b.light(distant_light(T.identity(), (2.2, 2.1, 1.9),
                          direction=(-0.35, -1.0, -0.25)))
    b.light(point_light(T.translate([6.0, 9.0, 6.0]), (180.0, 175.0, 165.0)))
    return b.build(device=device)


def build_camera(resolution: int = 512, filename: str = "sphere_field.png",
                 convention: str = "pbrt"):
    film = Film((resolution, resolution),
                filter=LanczosSincFilter((1.0, 1.0), 3.0), filename=filename)
    return PerspectiveCamera(
        T.look_at([14.0, 9.0, 18.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]),
        lens_radius=0.0, focal_distance=1e6, fov=55.0, film=film,
        convention=convention)


if __name__ == "__main__":
    from ._run import whitted_main

    whitted_main(__doc__, build_scene, build_camera, resolution=512, spp=4,
                 depth=3, output="sphere_field.png")
