"""Carry a ``trace_tpu`` Scene across to the port as numpy arrays (the keys
of ``trace_tpu_torch.convert.scene_from_numpy``), so both packages compute
on identical data. Also the small converters the port's tests share."""
import contextlib
import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from trace_tpu.materials import materials as JM
from trace_tpu_torch import convert as C
from trace_tpu_torch.core.vec import V3 as TV3
from trace_tpu_torch.shapes.sphere import Spheres
from trace_tpu_torch.shapes.triangle import Triangles

# One intra-op thread per test process. The suite runs one process per
# core (pytest-xdist), and torch's default of one thread per core in each
# oversubscribes the cores: small-tensor loops (SPPM's pair chunks, the
# sweep's plain version) then wait on spinning threads. Every pytest
# worker imports this module while it collects the port's tests.
torch.set_num_threads(1)


def warm_vector_math():
    """Call the vector-math functions of the env lookups and samplers once
    before any test does.

    torch computes them on the CPU through MKL's VML, in chunks of 2048
    elements on its intra-op threads. When a process's first call ran on
    two threads at once, the second thread's chunk came out less
    accurate: sin of acos of 4096 directions off by up to 3e-5 relative
    on lanes 2048-4095, in about one process in six, while the same call
    repeated was exact. Each function is called first on the calling
    thread alone (below 2048 elements), then on every intra-op thread.
    """
    for n in (1024, 2048 * max(torch.get_num_threads(), 2)):
        x = torch.linspace(-0.9, 0.9, n)
        for f in (torch.acos, torch.sin, torch.cos, torch.sqrt):
            f(x.abs())
        torch.atan2(x, x + 2.0)


warm_vector_math()

LIGHT_FIELDS = ("kind", "p", "i", "direction", "w2l", "l2w",
                "cos_total_width", "cos_falloff_start", "tri_start",
                "tri_count", "two_sided", "env_rgb", "env_pmf", "env_prob",
                "env_alias", "env_h", "env_w")


def _v(tex):
    """A constant texture's value; zeros of the texture's width for any
    other (its tree goes across as ``tex<m>_<name>_`` keys)."""
    from trace_tpu.materials.textures import ConstantTexture

    if isinstance(tex, ConstantTexture):
        return np.asarray(tex.value, np.float32).reshape(-1)
    return np.zeros(3 if _spectral(tex) else 1, np.float32)


def _spectral(tex) -> bool:
    """Whether a JAX texture evaluates to [N, 3]."""
    from trace_tpu.materials import textures as JX

    if isinstance(tex, JX.ScaleTexture):
        return _spectral(tex.value) or _spectral(tex.scale)
    if isinstance(tex, JX.MixTexture):
        return _spectral(tex.t1) or _spectral(tex.t2)
    return bool(tex.is_spectral)


def mapping_arrays(mp, pre) -> dict:
    from trace_tpu.materials import textures as JX

    if isinstance(mp, JX.UVMapping2D):
        return {pre + "map_kind": np.int32(C.MAP_UV), pre + "map_uv":
                np.array([mp.su, mp.sv, mp.du, mp.dv], np.float32)}
    return {pre + "map_kind": np.int32(C.MAP_3D),
            pre + "map_m": np.asarray(mp.w2t.m, np.float32),
            pre + "map_inv": np.asarray(mp.w2t.inv_m, np.float32)}


def texture_arrays(tex, pre) -> dict:
    """One JAX texture tree as convert.py's keys under ``pre``."""
    from trace_tpu.materials import textures as JX

    if isinstance(tex, JX.ConstantTexture):
        return {pre + "kind": np.int32(C.TEX_CONSTANT),
                pre + "value": np.asarray(tex.value, np.float32)}
    if isinstance(tex, JX.ScaleTexture):
        return {pre + "kind": np.int32(C.TEX_SCALE),
                **texture_arrays(tex.value, pre + "value_"),
                **texture_arrays(tex.scale, pre + "scale_")}
    if isinstance(tex, JX.MixTexture):
        return {pre + "kind": np.int32(C.TEX_MIX),
                **texture_arrays(tex.t1, pre + "t1_"),
                **texture_arrays(tex.t2, pre + "t2_"),
                **texture_arrays(tex.amount, pre + "amount_")}
    if isinstance(tex, JX.BilerpTexture):
        return {pre + "kind": np.int32(C.TEX_BILERP),
                **mapping_arrays(tex.mapping, pre),
                **{pre + c: np.asarray(getattr(tex, c), np.float32)
                   for c in ("v00", "v01", "v10", "v11")}}
    if isinstance(tex, JX.ImageTexture):
        mip = tex.mip
        return {pre + "kind": np.int32(C.TEX_IMAGE),
                **mapping_arrays(tex.mapping, pre),
                pre + "dims": mip.dims, pre + "offsets": mip.offsets,
                pre + "texels": mip.texels,
                pre + "wrap": np.int32(("repeat", "clamp", "black").index(
                    mip.wrap)),
                pre + "spectral": np.bool_(mip.is_spectral),
                pre + "scale": np.float32(tex.scale)}
    raise TypeError(type(tex))


def material_texture_arrays(materials) -> dict:
    """Every parameter that is not a constant, as ``tex<m>_<name>_``
    trees."""
    from trace_tpu.materials.textures import ConstantTexture, Texture

    a = {}
    for m, mat in enumerate(materials):
        for name, tex in vars(mat).items():
            if isinstance(tex, Texture) and not isinstance(
                    tex, ConstantTexture):
                a.update(texture_arrays(tex, f"tex{m}_{name}_"))
    return a


def material_arrays(materials):
    kinds, params = [], []
    for m in materials:
        if isinstance(m, JM.MatteMaterial):
            k, p = C.MATTE, [*_v(m.Kd), *_v(m.sigma)]
        elif isinstance(m, JM.GlassMaterial):
            k, p = C.GLASS, [*_v(m.Kr), *_v(m.Kt), *_v(m.index),
                             *_v(m.u_roughness), *_v(m.v_roughness),
                             float(m.remap_roughness)]
        elif isinstance(m, JM.MirrorMaterial):
            k, p = C.MIRROR, [*_v(m.Kr)]
        elif isinstance(m, JM.PlasticMaterial):
            k, p = C.PLASTIC, [*_v(m.Kd), *_v(m.Ks), *_v(m.roughness),
                               float(m.remap_roughness)]
        elif isinstance(m, JM.MetalMaterial):
            k, p = C.METAL, [*_v(m.eta), *_v(m.k), *_v(m.roughness),
                             float(m.remap_roughness)]
        else:
            raise TypeError(type(m))
        kinds.append(k)
        params.append(p + [0.0] * (C.N_PARAMS - len(p)))
    return np.asarray(kinds, np.int32), np.asarray(params, np.float32)


def arrays_from_jax(scene) -> dict:
    a = {}
    for f in Spheres._fields:
        a["sphere_" + f] = np.asarray(getattr(scene.spheres_host, f))
    for f in Triangles._fields:
        a["tri_" + f] = np.asarray(getattr(scene.triangles_host, f))
    a["tri_light_id"] = np.asarray(scene.tri_light_id)
    for f in LIGHT_FIELDS:
        a["light_" + f] = np.asarray(getattr(scene.lights, f))
    a["material_kind"], a["material_params"] = material_arrays(
        scene.materials)
    a.update(material_texture_arrays(scene.materials))
    a["exact_edges"] = scene.exact_edges
    if scene.n_triangles > 64:
        a.update(sweep_arrays(scene.triangles_host))
    for k, geom in enumerate(scene.instanced):
        a.update(instanced_arrays(geom, f"inst{k}_"))
    return a


def sweep_arrays(tris, prefix="") -> dict:
    """The JAX package's sweep tables (leaf 64, group 8) of a triangle
    table."""
    from trace_tpu.accel.clusters import build_clusters
    from trace_tpu.ops.sweep_pallas import SweepTables

    tb = SweepTables(build_clusters(tris, 64, 4), 8)
    return {prefix + f: np.asarray(getattr(tb, f)) for f in C.SWEEP_FIELDS}


def instanced_arrays(geom, prefix) -> dict:
    """One JAX instanced geometry (a mesh or a sphere base) as
    convert.py's ``inst<k>_`` keys."""
    from trace_tpu.accel.instances import InstancedGeometry

    a = {prefix + f: np.asarray(getattr(geom.table, f))
         for f in ("o2w", "w2o", "lo", "hi", "material_id", "swaps")}
    base = jax.tree.map(np.asarray, geom.base)
    if isinstance(geom, InstancedGeometry):
        a[prefix + "kind"] = np.int32(C.INST_MESH)
        for f in Triangles._fields:
            a[prefix + "tri_" + f] = np.asarray(getattr(base, f))
        if geom.n_base > 64:
            a.update(sweep_arrays(base, prefix))
    else:
        a[prefix + "kind"] = np.int32(C.INST_SPHERES)
        for f in Spheres._fields:
            a[prefix + "sphere_" + f] = np.asarray(getattr(base, f))
    return a


def port_scene(jax_scene, device="cpu"):
    return C.scene_from_numpy(arrays_from_jax(jax_scene), device)


def both3(a):
    """numpy [N, 3] -> (torch V3, JAX V3)."""
    from trace_tpu.core.vec import V3 as JV3

    a = np.asarray(a, np.float32)
    return (TV3(*[torch.from_numpy(a[:, i].copy()) for i in range(3)]),
            JV3(*[jnp.asarray(a[:, i]) for i in range(3)]))


def both(a):
    a = np.asarray(a)
    return torch.from_numpy(a.copy()), jnp.asarray(a)


def lane_keys(seed: int, n: int):
    """(torch [N, 2] int64 keys, JAX key array) for lanes 0..n-1."""
    from trace_tpu.sampler import uniform as JU

    jk = JU.lane_keys(jax.random.key(seed), jnp.arange(n, dtype=jnp.uint32))
    tk = torch.from_numpy(
        np.asarray(jax.random.key_data(jk)).astype(np.int64))
    return tk, jk


def np3(v) -> np.ndarray:
    """torch or JAX V3 -> numpy [N, 3]."""
    return np.stack([np.asarray(c) for c in v], -1)


def mse(a, b) -> float:
    return float(np.mean((np.asarray(a, np.float32) - b) ** 2))


def spawn_along(p, n_geom, wi):
    """The JAX package's continuation rule, ``p + wi * SPAWN_EPS``: 1e-6
    along ``wi`` and nothing along the normal, below float32's resolution
    where |p| > ~8. A spawn rule for the port's walks (their ``spawn``
    argument)."""
    from trace_tpu_torch.core.ray import SPAWN_EPS

    return p + wi * SPAWN_EPS


def cancelling_disc(o_obj, d_obj, a, od, radius):
    """The JAX package's sphere discriminant, b^2 - 4ac as written, with
    its cancelling c = |o|^2 - r^2: a stand-in for
    ``geom._sphere_disc``."""
    b = 2.0 * od
    return b * b - 4.0 * a * (o_obj.length_squared() - radius * radius)


@contextlib.contextmanager
def jax_rules():
    """The port with the float32 rules of the JAX package that it has
    left on purpose (ROADMAP §C.1-2, all repaired): a continuation of the
    SPPM walks and of the path tracer spawned 1e-6 along wi
    (:func:`spawn_along`, through the walks' and ``wavefront/path.py::li``'s
    ``spawn`` argument), and the sphere's cancelling discriminant
    (:func:`cancelling_disc` in place of ``geom._sphere_disc``). Tests
    that hold the port's other arithmetic to the JAX package, or to
    renders made under those rules, run the port inside it."""
    from trace_tpu_torch.wavefront import geom as G
    from trace_tpu_torch.wavefront import path as WP
    from trace_tpu_torch.wavefront import sppm_camera as SC
    from trace_tpu_torch.wavefront import sppm_photon as SP

    saved = (G._sphere_disc, SC.camera_pass_body, SP.photon_walk_body,
             WP.li)
    G._sphere_disc = cancelling_disc
    SC.camera_pass_body = functools.partial(saved[1], spawn=spawn_along)
    SP.photon_walk_body = functools.partial(saved[2], spawn=spawn_along)
    WP.li = functools.partial(saved[3], spawn=spawn_along)
    try:
        yield
    finally:
        (G._sphere_disc, SC.camera_pass_body, SP.photon_walk_body,
         WP.li) = saved
