"""The reference's caustic-glass scene (port of
trace_tpu/models/caustic_glass.py): a glass PLY mesh over a plastic
floor, lit by a spot light, rendered with SPPM (bench config 3).

The mesh is not in the repository: pass its path (``--ply``). A missing
file raises FileNotFoundError naming the path; no other mesh stands in.

    python -m trace_tpu_torch.models.caustic_glass --ply caustic-glass.ply
"""
from __future__ import annotations

import os

import numpy as np

from ..camera.perspective import PerspectiveCamera
from ..core import transform as T
from ..film.film import Film
from ..film.filters import LanczosSincFilter
from ..io.ply import load_ply
from ..lights.lights import spot_light
from ..materials.materials import GlassMaterial, PlasticMaterial
from ..scene import Scene, SceneBuilder

PLY_NAME = "caustic-glass.ply"


def build_scene(ply_path: str = PLY_NAME, device="cuda") -> Scene:
    if not os.path.isfile(ply_path):
        raise FileNotFoundError(
            f"caustic_glass needs the reference's mesh at {ply_path!r}; the "
            f"file is absent (it is not in the repository)")
    return scene_around(load_ply(ply_path), device)


def scene_around(mesh: dict, device="cuda") -> Scene:
    """The scene around a glass mesh given as load_ply's dict (indices,
    vertices, normals, uv; normals and uv may be None) in the PLY's own
    frame, which the scene moves by (5, -1.49, -100)."""
    b = SceneBuilder()
    glass = b.material(GlassMaterial(
        Kr=(1.0, 1.0, 1.0), Kt=(1.0, 1.0, 1.0), u_roughness=0.0,
        v_roughness=0.0, index=1.25, remap_roughness=True))
    plastic = b.material(PlasticMaterial(
        Kd=(0.6399999857,) * 3, Ks=(0.1000000015,) * 3,
        roughness=0.010408001, remap_roughness=True))

    b.triangle_mesh(T.translate([5.0, -1.49, -100.0]), mesh["indices"],
                    mesh["vertices"], glass, normals=mesh.get("normals"),
                    uv=mesh.get("uv"))

    # The intended 30 x 30 floor quad (the reference's vertex list
    # collapses both triangles onto a line, as the JAX twin notes).
    floor_verts = np.array([[0, 0, 0], [0, 0, -30], [30, 0, -30],
                            [30, 0, 0]], np.float32)
    floor_idx = np.array([[0, 2, 1], [0, 3, 2]], np.uint32)
    floor_normals = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    b.triangle_mesh(T.translate([-10.0, 0.0, -87.0]), floor_idx,
                    floor_verts, plastic, normals=floor_normals)

    # Spot light aimed from (0, 2, 0) toward (-5, 0, 5) in its frame, then
    # shifted by (4.5, 0, -101).
    frm = np.array([0.0, 2.0, 0.0], np.float32)
    to = np.array([-5.0, 0.0, 5.0], np.float32)
    l2w = T.compose(T.compose(T.translate([4.5, 0.0, -101.0]),
                              T.translate(frm)),
                    T.inverse(T.dir_to_z(to - frm)))
    b.light(spot_light(l2w, (60.0, 60.0, 60.0), 30.0, 30.0 - 10.0))
    return b.build(device=device)


def build_camera(resolution: int = 256, filename: str = "caustics.png",
                 showcase: bool = False,
                 convention: str = "reference"):
    """The reference's camera; ``showcase=True`` retargets it so the
    caustic and the glass land mid-frame (as the JAX twin)."""
    film = Film((resolution, resolution),
                filter=LanczosSincFilter((1.0, 1.0), 3.0), filename=filename)
    target = [-3.535, -1.205, -93.0] if showcase else [-3.0, 0.0, -91.0]
    return PerspectiveCamera(
        T.look_at([0.0, 150.0, 150.0], target, [0.0, 1.0, 0.0]),
        screen_window=((-1.0, -1.0), (1.0, 1.0)), shutter_open=0.0,
        shutter_close=1.0, lens_radius=0.0, focal_distance=1e6, fov=90.0,
        film=film, convention=convention)


if __name__ == "__main__":
    import sys

    from ._run import sppm_main

    # --ply PATH is ours; the rest goes to the SPPM script's parser.
    argv = sys.argv[1:]
    ply = PLY_NAME
    if "--ply" in argv:
        i = argv.index("--ply")
        ply = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    # Bench config 3: SPPM, r0 = 0.075, ray depth 8, 100 iterations.
    sppm_main(__doc__,
              lambda device: build_scene(ply, device=device), build_camera,
              resolution=1024, iterations=100, radius=0.075, depth=8,
              output="caustics.png", argv=argv)
