"""Environment-lit studio (port of trace_tpu/models/env_studio.py):
matte, mirror and glass spheres on a matte floor under a procedural sky
(a gradient and a hot sun disk), rendered with the MIS path tracer
through the ``pbrt`` camera.

    python -m trace_tpu_torch.models.env_studio --resolution 512 --spp 64 \
        --depth 5
"""
from __future__ import annotations

import numpy as np

from ..camera.perspective import PerspectiveCamera
from ..core import transform as T
from ..film.film import Film
from ..film.filters import LanczosSincFilter
from ..lights.lights import infinite_light
from ..materials.materials import GlassMaterial, MatteMaterial, MirrorMaterial
from ..scene import Scene, SceneBuilder


def sky_image(h: int = 64, w: int = 128) -> np.ndarray:
    """Procedural equal-rect sky [h, w, 3]: a blue-to-horizon gradient over
    the upper hemisphere (theta < pi/2 from the env frame's +z), a warm
    ground below, and a 5 degree sun disk 40 degrees above the horizon."""
    theta = (np.arange(h) + 0.5) * np.pi / h
    phi = (np.arange(w) + 0.5) * 2 * np.pi / w
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    img = np.empty((h, w, 3), np.float32)
    t = np.clip(tt / (np.pi / 2), 0.0, 1.0)[..., None]  # 0 zenith, 1 horizon
    zenith = np.array([0.08, 0.18, 0.45], np.float32)
    horizon = np.array([0.55, 0.62, 0.70], np.float32)
    img[:] = zenith * (1 - t) + horizon * t
    img[tt > np.pi / 2] = np.array([0.18, 0.14, 0.10], np.float32)
    sun_dir = np.array([
        np.sin(np.deg2rad(50)) * np.cos(np.deg2rad(70)),
        np.sin(np.deg2rad(50)) * np.sin(np.deg2rad(70)),
        np.cos(np.deg2rad(50)),
    ])
    d = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                  np.cos(tt)], axis=-1)
    in_sun = (d @ sun_dir) > np.cos(np.deg2rad(2.5))
    img[in_sun] = np.array([120.0, 110.0, 90.0], np.float32)
    return img


def build_scene(device="cuda", **build_kw) -> Scene:
    """``build_kw`` goes to SceneBuilder.build (``exact_shared_edges``)."""
    b = SceneBuilder()
    grey = b.material(MatteMaterial(Kd=(0.55, 0.55, 0.55), sigma=0.0))
    red = b.material(MatteMaterial(Kd=(0.70, 0.20, 0.18), sigma=0.0))
    mirror = b.material(MirrorMaterial(Kr=(0.95, 0.95, 0.95)))
    glass = b.material(GlassMaterial(
        Kr=(1.0, 1.0, 1.0), Kt=(1.0, 1.0, 1.0), u_roughness=0.0,
        v_roughness=0.0, index=1.5, remap_roughness=True))

    # Spheres resting on the z = 0 floor (the env frame's +z is up).
    b.sphere(T.translate([0.0, 0.0, 0.4]), 0.4, red)
    b.sphere(T.translate([-0.9, 0.6, 0.3]), 0.3, mirror)
    b.sphere(T.translate([0.8, -0.4, 0.25]), 0.25, glass)

    floor_v = np.array([[-4, -4, 0], [4, -4, 0], [4, 4, 0], [-4, 4, 0]],
                       np.float32)
    floor_n = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    b.triangle_mesh(T.identity(), np.array([[0, 1, 2], [0, 2, 3]], np.uint32),
                    floor_v, grey, normals=floor_n)

    b.light(infinite_light(image=sky_image()))
    return b.build(device=device, **build_kw)


def build_camera(resolution: int = 512, filename: str = "env_studio.png",
                 convention: str = "pbrt"):
    """The ``pbrt`` convention by default: the scene is not one of the
    reference's, so it takes the well-framed projection."""
    film = Film((resolution, resolution),
                filter=LanczosSincFilter((1.0, 1.0), 3.0), filename=filename)
    return PerspectiveCamera(
        T.look_at([3.2, -3.2, 1.6], [0.0, 0.0, 0.35], [0.0, 0.0, 1.0]),
        screen_window=((-1.0, -1.0), (1.0, 1.0)), shutter_open=0.0,
        shutter_close=1.0, lens_radius=0.0, focal_distance=1e6, fov=35.0,
        film=film, convention=convention)


if __name__ == "__main__":
    from ._run import path_main

    path_main(__doc__, build_scene, build_camera, resolution=512, spp=64,
              depth=5, output="env_studio.png")
