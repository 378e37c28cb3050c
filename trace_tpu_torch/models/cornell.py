"""Cornell-box-style scene (port of trace_tpu/models/cornell.py): a
[-1, 1]^3 box open toward +z, matte walls, a matte and a plastic sphere,
and a ceiling area light, for the MIS path tracer.

    python -m trace_tpu_torch.models.cornell --resolution 512 --spp 4 \
        --depth 5
"""
from __future__ import annotations

import numpy as np

from ..camera.perspective import PerspectiveCamera
from ..core import transform as T
from ..film.film import Film
from ..film.filters import LanczosSincFilter
from ..materials.materials import MatteMaterial, PlasticMaterial
from ..scene import Scene, SceneBuilder

_QUAD_IDX = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)


def _quad(b, verts, material, emission=None):
    b.triangle_mesh(T.identity(), _QUAD_IDX, np.asarray(verts, np.float32),
                    material, emission=emission)


def build_scene(device="cuda", **build_kw) -> Scene:
    """``build_kw`` goes to SceneBuilder.build (``exact_shared_edges``)."""
    b = SceneBuilder()
    white = b.material(MatteMaterial(Kd=(0.73, 0.73, 0.73)))
    red = b.material(MatteMaterial(Kd=(0.65, 0.05, 0.05)))
    green = b.material(MatteMaterial(Kd=(0.12, 0.45, 0.15)))
    plastic = b.material(PlasticMaterial(
        Kd=(0.1, 0.1, 0.4), Ks=(0.7, 0.7, 0.7), roughness=0.05))

    # Walls, wound so the geometric normals point into the box.
    _quad(b, [[-1, -1, 1], [1, -1, 1], [1, -1, -1], [-1, -1, -1]], white)
    _quad(b, [[-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]], white)
    _quad(b, [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1]], white)
    _quad(b, [[-1, -1, 1], [-1, -1, -1], [-1, 1, -1], [-1, 1, 1]], red)
    _quad(b, [[1, -1, -1], [1, -1, 1], [1, 1, 1], [1, 1, -1]], green)
    # Ceiling light panel, slightly below the ceiling, emitting downward.
    _quad(b, [[-0.35, 0.98, -0.35], [0.35, 0.98, -0.35],
              [0.35, 0.98, 0.35], [-0.35, 0.98, 0.35]],
          white, emission=(17.0, 12.0, 8.0))

    b.sphere(T.translate([-0.45, -0.65, -0.2]), 0.35, white)
    b.sphere(T.translate([0.45, -0.6, 0.25]), 0.4, plastic)
    return b.build(device=device, **build_kw)


def build_camera(resolution: int = 512, filename: str = "cornell.png"):
    film = Film((resolution, resolution),
                filter=LanczosSincFilter((1.0, 1.0), 3.0), filename=filename)
    # Centres the box under the reference-faithful projection.
    return PerspectiveCamera(
        T.look_at([0.0, 0.0, 140.0], [-1.397, -1.708, 0.0], [0.0, 1.0, 0.0]),
        screen_window=((-1.0, -1.0), (1.0, 1.0)), lens_radius=0.0,
        focal_distance=1e6, fov=90.0, film=film)


if __name__ == "__main__":
    from ._run import path_main

    # Bench config 2: path tracer 512^2, 4 spp, depth 5.
    path_main(__doc__, build_scene, build_camera, resolution=512, spp=4,
              depth=5, output="cornell.png")
