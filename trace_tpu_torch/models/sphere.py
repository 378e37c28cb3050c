"""Minimal example scene (port of trace_tpu/models/sphere.py): one red
matte sphere over a single white triangle, one point light, SPPM at 341^2
(1024 / 3), the reference's smallest runnable scene.

    python -m trace_tpu_torch.models.sphere [--device cpu]
"""
from __future__ import annotations

import numpy as np

from ..camera.perspective import PerspectiveCamera
from ..core import transform as T
from ..film.film import Film
from ..film.filters import LanczosSincFilter
from ..lights.lights import point_light
from ..materials.materials import MatteMaterial
from ..scene import Scene, SceneBuilder


def build_scene(device="cuda") -> Scene:
    b = SceneBuilder()
    red = b.material(MatteMaterial(Kd=(0.796, 0.235, 0.2), sigma=0.0))
    white = b.material(MatteMaterial(Kd=(1.0, 1.0, 1.0), sigma=0.0))

    b.sphere(T.translate([0.7, 0.31, -2.8]), 0.3, red)

    # The one active triangle of the reference's quad mesh (1-based
    # indices [6, 5, 3]).
    verts = np.array([[0, 0, 0], [0, 0, -1], [1, 0, -1],
                      [1, 0, 0], [0, 1, -1], [1, 1, -1]], np.float32)
    normals = np.array([[0, 1, 0], [0, 1, 0], [0, 1, 0],
                        [0, 1, 0], [0, 0, 1], [0, 0, 1]], np.float32)
    b.triangle_mesh(T.translate([0.0, 0.0, -2.0]),
                    np.array([[5, 4, 2]], np.uint32), verts, white,
                    normals=normals)

    b.light(point_light(T.translate([-1.0, 1.0, 0.0]), (25.0, 25.0, 25.0)))
    return b.build(device=device)


def build_camera(resolution: int = 1024 // 3,
                 filename: str = "sphere-sppm.png",
                 convention: str = "reference"):
    film = Film((resolution, resolution),
                filter=LanczosSincFilter((1.0, 1.0), 3.0), filename=filename)
    return PerspectiveCamera(
        T.look_at([0.0, 15.0, 50.0], [0.0, 0.0, -2.0], [0.0, 1.0, 0.0]),
        screen_window=((-1.0, -1.0), (1.0, 1.0)), shutter_open=0.0,
        shutter_close=1.0, lens_radius=0.0, focal_distance=1e6, fov=90.0,
        film=film, convention=convention)


def render(resolution: int = 1024 // 3, iterations: int = 10,
           filename: str = "sphere-sppm.png", device="cuda"):
    """The reference script's body: SPPM, initial radius 0.025, ray depth
    5, ``iterations`` iterations. Writes ``filename``; returns the
    SPPMState."""
    from ..integrators.sppm import SPPMIntegrator

    scene = build_scene(device=device)
    camera = build_camera(resolution, filename)
    integ = SPPMIntegrator(camera, initial_search_radius=0.025, max_depth=5,
                           n_iterations=iterations, device=device)
    state = integ.render(scene)
    integ.save(state, iterations, filename)
    return state


if __name__ == "__main__":
    from ._run import sppm_main

    sppm_main(__doc__, build_scene, build_camera, resolution=1024 // 3,
              iterations=10, radius=0.025, depth=5, output="sphere-sppm.png")
