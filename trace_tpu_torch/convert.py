"""Scene state carried across from the JAX package as plain arrays.

``scene_from_numpy`` builds the port's Scene from numpy arrays that a
caller extracted from a ``trace_tpu`` Scene, so both packages compute on
identical data. Keys (all numpy):

- spheres: ``sphere_<field>`` for every field of shapes.sphere.Spheres;
- triangles: ``tri_<field>`` for every field of shapes.triangle.Triangles;
- lights: ``light_kind`` [L] i32, ``light_p`` [L, 3], ``light_i`` [L, 3];
- materials: ``material_kind`` [M] i32 (MATTE or GLASS) and
  ``material_params`` [M, 7] f32: matte (Kd rgb, sigma), glass (Kr rgb,
  Kt rgb, index);
- sweep tables (optional): ``panel`` (f32, or a bf16 or hi/lo panel as
  its uint16 view), ``slot_to_tri``, ``s_lo``, ``s_hi``;
- ``exact_edges`` (optional): the scene's exact_shared_edges switch;
- ``fused_b`` (optional): ops/intersect_pallas.py::pack_tris' B; the scene
  then intersects through the fused brute-force accelerator.
"""
from __future__ import annotations

import numpy as np

from .core import transform as T
from .lights import lights as light_mod
from .materials.materials import GlassMaterial, MatteMaterial
from .ops import intersect
from .ops.sweep import SweepTables
from .scene import Scene
from .shapes.sphere import Spheres
from .shapes.triangle import Triangles

MATTE = 0
GLASS = 1


def _materials(kinds, params):
    out = []
    for k, p in zip(np.asarray(kinds), np.asarray(params, np.float32)):
        if k == MATTE:
            out.append(MatteMaterial(Kd=p[0:3], sigma=p[3]))
        elif k == GLASS:
            out.append(GlassMaterial(Kr=p[0:3], Kt=p[3:6], index=p[6]))
        else:
            raise NotImplementedError(f"material kind {k} is not ported yet")
    return out


def scene_from_numpy(arrays: dict, device) -> Scene:
    spheres = Spheres(*[np.asarray(arrays["sphere_" + f])
                        for f in Spheres._fields])
    tris = Triangles(*[np.asarray(arrays["tri_" + f])
                       for f in Triangles._fields])
    lights = light_mod.pack_lights([
        light_mod.point_light(T.translate(p), i) if k == light_mod.POINT
        else {"kind": int(k)}
        for k, p, i in zip(arrays["light_kind"], arrays["light_p"],
                           arrays["light_i"])])
    tables = None
    if "panel" in arrays:
        tables = SweepTables.from_arrays(arrays["panel"],
                                         arrays["slot_to_tri"],
                                         arrays["s_lo"], arrays["s_hi"])
    scene = Scene(spheres, tris,
                  _materials(arrays["material_kind"],
                             arrays["material_params"]),
                  lights, device, sweep_tables=tables,
                  exact_edges=bool(arrays.get("exact_edges", False)))
    if "fused_b" in arrays:
        intersect.attach(scene, b=arrays["fused_b"])
    return scene
