"""Scene state carried across from the JAX package as plain arrays.

``scene_from_numpy`` builds the port's Scene from numpy arrays that a
caller extracted from a ``trace_tpu`` Scene, so both packages compute on
identical data. Keys (all numpy):

- spheres: ``sphere_<field>`` for every field of shapes.sphere.Spheres;
- triangles: ``tri_<field>`` for every field of shapes.triangle.Triangles,
  and optionally ``tri_light_id`` [T] i32 (-1: not emissive);
- lights: ``light_<field>`` for fields of lights.lights.Lights; ``kind``,
  ``p`` and ``i`` are required, the rest default as in ``make_lights``
  (``flags`` follow from the kinds, ``total_area`` from the triangles);
  an environment light comes with its six ``light_env_*`` tables (rgb,
  pmf, prob, alias, h, w) as the JAX package packed them;
- materials: ``material_kind`` [M] i32 (MATTE, GLASS, MIRROR, PLASTIC,
  METAL) and ``material_params`` [M, <= 10] f32, zero-padded: matte (Kd
  rgb, sigma), glass (Kr rgb, Kt rgb, index, u and v roughness,
  remap_roughness), mirror (Kr rgb), plastic (Kd rgb, Ks rgb, roughness,
  remap_roughness), metal (eta rgb, k rgb, roughness, remap_roughness);
- textures (optional): a parameter of material m that is not a constant
  comes as a tree under the prefix ``tex<m>_<name>_`` (``name`` the
  material's attribute, e.g. ``Kd``), which overrides its params entry.
  Each node has ``kind`` (TEX_CONSTANT, TEX_SCALE, TEX_MIX, TEX_BILERP,
  TEX_IMAGE) and: a constant its ``value``; a scale its children
  ``value_`` and ``scale_``; a mix ``t1_``, ``t2_`` and ``amount_``; a
  bilerp its mapping and corners ``v00`` ``v01`` ``v10`` ``v11``; an
  image its mapping, the MipMap tables ``dims``, ``offsets``,
  ``texels``, ``wrap`` (an index into textures.WRAPS), ``spectral`` and
  its ``scale``. A mapping is ``map_kind`` (MAP_UV, MAP_3D) with
  ``map_uv`` (su, sv, du, dv) or the world-to-texture ``map_m`` and
  ``map_inv`` [4, 4];
- sweep tables (optional): ``panel`` (f32, or a bf16 or hi/lo panel as
  its uint16 view), ``slot_to_tri``, ``s_lo``, ``s_hi``;
- instanced geometry (optional), for k = 0, 1, ... in the scene's order:
  ``inst<k>_kind`` (INST_MESH or INST_SPHERES), the base as
  ``inst<k>_tri_<field>`` or ``inst<k>_sphere_<field>``, the instance
  table's six arrays ``inst<k>_<field>`` (o2w, w2o, lo, hi, material_id,
  swaps), and for a mesh base above 64 triangles its sweep tables
  ``inst<k>_panel`` etc.;
- ``exact_edges`` (optional): the scene's exact_shared_edges switch;
- ``fused_b`` (optional): ops/intersect_pallas.py::pack_tris' B; the scene
  then intersects through the fused brute-force accelerator.

``sppm_state_from_numpy`` carries an SPPM state across the same way, so a
run of the JAX package resumes in the port; ``film_state_from_numpy`` a
film state with its splats; ``triangles_from_jax`` and
``transform_from_jax`` carry a frame's geometry and motion;
``linear_bvh`` and ``cluster_accel`` a JAX SAH tree and cluster tables,
so the port's walks run on JAX's own trees; ``tri_matmul_consts`` JAX's
matmul constants (accel/mxu.py), so both packages' all-pairs tests read
one table.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .accel import instances as inst_mod
from .accel.bvh import LinearBVH
from .accel.clusters import ClusterAccel
from .accel.mxu import TriMatmulConsts
from .core.transform import Transform
from .lights import lights as light_mod
from .materials import materials as M
from .materials import textures as TX
from .ops import intersect
from .ops.sweep import SweepTables
from .scene import Scene
from .shapes.sphere import Spheres
from .shapes.triangle import Triangles

TEX_CONSTANT = 0
TEX_SCALE = 1
TEX_MIX = 2
TEX_BILERP = 3
TEX_IMAGE = 4
MAP_UV = 0
MAP_3D = 1
MATTE = 0
GLASS = 1
MIRROR = 2
PLASTIC = 3
METAL = 4
N_PARAMS = 10
INST_MESH = 0
INST_SPHERES = 1
SWEEP_FIELDS = ("panel", "slot_to_tri", "s_lo", "s_hi")


def _mapping(arrays, pre):
    if int(arrays[pre + "map_kind"]) == MAP_UV:
        return TX.UVMapping2D(*[float(x) for x in arrays[pre + "map_uv"]])
    return TX.TransformMapping3D(Transform(
        np.asarray(arrays[pre + "map_m"], np.float32),
        np.asarray(arrays[pre + "map_inv"], np.float32)))


def _texture(arrays, pre):
    """The texture tree under the key prefix ``pre``."""
    kind = int(arrays[pre + "kind"])
    if kind == TEX_CONSTANT:
        return TX.ConstantTexture(arrays[pre + "value"])
    if kind == TEX_SCALE:
        return TX.ScaleTexture(_texture(arrays, pre + "value_"),
                               _texture(arrays, pre + "scale_"))
    if kind == TEX_MIX:
        return TX.MixTexture(_texture(arrays, pre + "t1_"),
                             _texture(arrays, pre + "t2_"),
                             _texture(arrays, pre + "amount_"))
    if kind == TEX_BILERP:
        return TX.BilerpTexture(_mapping(arrays, pre), *[
            arrays[pre + c] for c in ("v00", "v01", "v10", "v11")])
    if kind == TEX_IMAGE:
        mip = TX.MipMap.from_tables(
            arrays[pre + "dims"], arrays[pre + "offsets"],
            arrays[pre + "texels"], TX.WRAPS[int(arrays[pre + "wrap"])],
            bool(arrays[pre + "spectral"]))
        return TX.ImageTexture(_mapping(arrays, pre), mip,
                               float(arrays[pre + "scale"]))
    raise NotImplementedError(f"texture kind {kind} is not ported")


def _with_textures(mat, m: int, arrays):
    """Replace each parameter of material ``m`` that ``arrays`` holds a
    texture tree for."""
    for name in list(vars(mat)):
        pre = f"tex{m}_{name}_"
        if pre + "kind" in arrays:
            setattr(mat, name, _texture(arrays, pre))
    return mat


def _materials(kinds, params, arrays=None):
    params = np.asarray(params, np.float32)
    params = np.pad(params, ((0, 0), (0, N_PARAMS - params.shape[1])))
    out = []
    for k, p in zip(np.asarray(kinds), params):
        if k == MATTE:
            out.append(M.MatteMaterial(Kd=p[0:3], sigma=p[3]))
        elif k == GLASS:
            out.append(M.GlassMaterial(Kr=p[0:3], Kt=p[3:6], index=p[6],
                                       u_roughness=p[7], v_roughness=p[8],
                                       remap_roughness=bool(p[9])))
        elif k == MIRROR:
            out.append(M.MirrorMaterial(Kr=p[0:3]))
        elif k == PLASTIC:
            out.append(M.PlasticMaterial(Kd=p[0:3], Ks=p[3:6],
                                         roughness=p[6],
                                         remap_roughness=bool(p[7])))
        elif k == METAL:
            out.append(M.MetalMaterial(eta=p[0:3], k=p[3:6], roughness=p[6],
                                       remap_roughness=bool(p[7])))
        else:
            raise NotImplementedError(f"material kind {k} is not ported")
    if arrays is not None:
        out = [_with_textures(mat, m, arrays) for m, mat in enumerate(out)]
    return out


def _lights(arrays, tris) -> light_mod.Lights:
    names = [f.name for f in dataclasses.fields(light_mod.Lights)
             if f.name not in ("kind", "p", "i", "flags", "total_area",
                               "world_center", "world_radius")]
    return light_mod.make_lights(
        arrays["light_kind"], arrays["light_p"], arrays["light_i"], tris,
        **{f: arrays["light_" + f] for f in names
           if "light_" + f in arrays})


def sppm_state_from_numpy(src, device):
    """The JAX package's SPPMState -> the port's SPPMState on ``device``.
    ``src`` is an object or dict holding the six fields (ld, tau, radius,
    n, phi, m) as arrays, or the path of a checkpoint that
    trace_tpu.utils.checkpoint.save_pytree wrote (leaves in field
    order)."""
    from .integrators.sppm import SPPMState

    names = [f.name for f in dataclasses.fields(SPPMState)]
    if isinstance(src, str):
        with np.load(src) as data:
            vals = [data[f"leaf_{i}"] for i in range(len(names))]
    elif isinstance(src, dict):
        vals = [src[k] for k in names]
    else:
        vals = [getattr(src, k) for k in names]
    dtypes = {"m": np.int32}
    return SPPMState(**{
        k: torch.from_numpy(np.array(v, dtypes.get(k, np.float32))).to(
            device) for k, v in zip(names, vals)})


def film_state_from_numpy(src, device):
    """The JAX package's FilmState (xyz [H, W, 3], weight_sum [H, W],
    splat_xyz [H, W, 3]; an object or a dict of arrays) -> the port's
    FilmState on ``device``, float32."""
    from .film.film import FilmState

    get = src.get if isinstance(src, dict) else (
        lambda k: getattr(src, k))
    return FilmState(*[torch.from_numpy(np.array(get(k), np.float32)).to(
        device) for k in FilmState._fields])


def triangles_from_jax(tris) -> Triangles:
    """A JAX package Triangles (device or host arrays) -> the port's
    Triangles of host numpy arrays, field by field."""
    return Triangles(*[np.asarray(getattr(tris, f)) for f in
                       Triangles._fields])


def transform_from_jax(xf) -> Transform:
    """A JAX package Transform (m, inv_m) -> the port's, float32."""
    return Transform(np.asarray(xf.m, np.float32),
                     np.asarray(xf.inv_m, np.float32))


def linear_bvh(bvh) -> LinearBVH:
    """A JAX package LinearBVH (device or host arrays) -> the port's, of
    host numpy arrays, field by field."""
    return LinearBVH(*[np.asarray(getattr(bvh, f)) for f in
                       LinearBVH._fields])


def cluster_accel(accel) -> ClusterAccel:
    """A JAX package ClusterAccel -> the port's, of host numpy arrays
    (leaf_tris and super_size as ints)."""
    return ClusterAccel(**{f: (int(getattr(accel, f))
                               if f in ("leaf_tris", "super_size")
                               else np.asarray(getattr(accel, f)))
                           for f in ClusterAccel._fields})


def tri_matmul_consts(consts) -> TriMatmulConsts:
    """A JAX package TriMatmulConsts -> the port's, of host numpy arrays,
    field by field."""
    return TriMatmulConsts(*[np.asarray(getattr(consts, f)) for f in
                             TriMatmulConsts._fields])


def _sweep_tables(arrays, prefix=""):
    if prefix + "panel" not in arrays:
        return None
    return SweepTables.from_arrays(*[arrays[prefix + f]
                                     for f in SWEEP_FIELDS])


def _instanced(arrays) -> list:
    out = []
    k = 0
    while f"inst{k}_kind" in arrays:
        pre = f"inst{k}_"
        table = inst_mod.InstanceTable(*[np.asarray(arrays[pre + f])
                                         for f in inst_mod.InstanceTable
                                         ._fields])
        if int(arrays[pre + "kind"]) == INST_MESH:
            base = Triangles(*[np.asarray(arrays[pre + "tri_" + f])
                               for f in Triangles._fields])
            out.append(inst_mod.InstancedGeometry(
                base, table, sweep_tables=_sweep_tables(arrays, pre)))
        else:
            base = Spheres(*[np.asarray(arrays[pre + "sphere_" + f])
                             for f in Spheres._fields])
            out.append(inst_mod.InstancedSpheres(base, table))
        k += 1
    return out


def scene_from_numpy(arrays: dict, device) -> Scene:
    spheres = Spheres(*[np.asarray(arrays["sphere_" + f])
                        for f in Spheres._fields])
    tris = Triangles(*[np.asarray(arrays["tri_" + f])
                       for f in Triangles._fields])
    scene = Scene(spheres, tris,
                  _materials(arrays["material_kind"],
                             arrays["material_params"], arrays),
                  _lights(arrays, tris), device,
                  sweep_tables=_sweep_tables(arrays),
                  exact_edges=bool(arrays.get("exact_edges", False)),
                  tri_light_id=arrays.get("tri_light_id"),
                  instanced=_instanced(arrays))
    if "fused_b" in arrays:
        intersect.attach(scene, b=arrays["fused_b"])
    return scene
