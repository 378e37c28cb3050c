"""The program's Cornell box from a configuration's scene description (a
list of materials, quads of two triangles each, some of them emitting,
and spheres), through the port's public constructors; its camera is
drivers/scene.py's."""
from __future__ import annotations

import numpy as np

# A quad's two triangles, (v0, v1, v2) and (v0, v2, v3): wound as its
# vertices are listed.
QUAD_IDX = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)


def material(tt, m: dict):
    if m["type"] == "matte":
        return tt.MatteMaterial(Kd=tuple(m["Kd"]))
    if m["type"] == "plastic":
        return tt.PlasticMaterial(Kd=tuple(m["Kd"]), Ks=tuple(m["Ks"]),
                                  roughness=m["roughness"])
    raise ValueError(f"unknown material type {m['type']!r}")


def build_scene(desc: dict, device, **build_kw):
    """The description's box on ``device``: materials in their listed
    order, then the quads (an emitting quad is a diffuse area light of
    its two triangles), then the spheres."""
    import trace_tpu_torch as tt

    T = tt.transforms
    b = tt.SceneBuilder()
    ids = {m["name"]: b.material(material(tt, m)) for m in desc["materials"]}
    for q in desc["quads"]:
        emission = q.get("emission")
        b.triangle_mesh(T.identity(), QUAD_IDX,
                        np.asarray(q["verts"], np.float32), ids[q["material"]],
                        emission=None if emission is None else tuple(emission))
    for s in desc["spheres"]:
        b.sphere(T.translate(s["center"]), s["radius"], ids[s["material"]])
    return b.build(device=device, accelerator=desc["accelerator"], **build_kw)
