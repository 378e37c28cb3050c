"""The program's scene and camera from a configuration's scene
description (the heightfield of scenes/heightfield.py, a matte Oren-Nayar
ground, a smooth glass sphere, a point light), through the port's public
constructors."""
from __future__ import annotations

from ..scenes.heightfield import heightfield, heightfield_grid


def terrain(desc: dict):
    """(verts, tris, n) of the description's heightfield."""
    n = heightfield_grid(desc["heightfield_tris"])
    verts, tris = heightfield(n)
    return verts, tris, n


def build_scene(desc: dict, device, verts, tris, **build_kw):
    import trace_tpu_torch as tt

    T = tt.transforms
    b = tt.SceneBuilder()
    g = desc["ground"]
    ground = b.material(tt.MatteMaterial(Kd=tuple(g["Kd"]), sigma=g["sigma"]))
    s = desc["glass_sphere"]
    glass = b.material(tt.GlassMaterial(index=s["eta"]))
    b.triangle_mesh(T.identity(), tris, verts, ground)
    b.sphere(T.translate(s["center"]), s["radius"], glass)
    lt = desc["point_light"]
    b.light(tt.point_light(T.translate(lt["position"]), tuple(lt["I"])))
    return b.build(device=device, accelerator=desc["accelerator"], **build_kw)


def build_camera(desc: dict, resolution: int):
    import trace_tpu_torch as tt

    c = desc["camera"]
    f = c["filter"]
    film = tt.Film((resolution, resolution),
                   filter=tt.LanczosSincFilter(tuple(f["radius"]), f["tau"]),
                   filename="unused.png")
    (sx0, sy0), (sx1, sy1) = c["screen_window"]
    return tt.PerspectiveCamera(
        tt.transforms.look_at(c["position"], c["target"], c["up"]),
        screen_window=((sx0, sy0), (sx1, sy1)), lens_radius=0.0,
        focal_distance=1e6, fov=c["fov"], film=film, convention="reference")
