"""Multi-device rendering over a torch.distributed device mesh (port of
trace_tpu/parallel/render.py).

The JAX package shards the film samples over a mesh axis with shard_map,
each device splats into its own film, and one psum merges the films. Here
every rank of the default process group runs the same program (SPMD):
rank r renders the r-th contiguous share of the padded pixel list into its
own film (the scatter splat, padded lanes masked out), and one
all_reduce(SUM) per FilmState field over the axis's group merges the
films, so every rank returns the same merged state. The caller initialises
the process group (``torch.distributed.init_process_group`` with its
address, world size and rank); ``make_mesh`` names it as a 1-D
DeviceMesh. Works for the sampler integrators, ``"whitted"`` and
``"path"``; SPPM has its own sharded passes (parallel/sppm.py).

Sample streams are pixel-identity-keyed (SamplerIntegrator.sample), so
any number of ranks draws the single-device streams; only the f32 order
of the film sums differs. The JAX package caches its jitted shard_map
steps per (scene, camera, mesh, settings); torch compiles nothing, so
there is nothing to cache.

``gather_shares`` concatenates the ranks' shares in rank order through
all_reduce(SUM) of buffers that hold a rank's share at its offset and
-0.0 (integers: 0) elsewhere. x + (-0.0) == x for every float, -0.0 and
NaN included, so the sum is the gather bit for bit, and all_reduce takes
CUDA tensors on gloo and NCCL alike: one code path serves every backend.
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass, replace

import numpy as np
import torch
import torch.distributed as dist

from ..film.film import FilmState
from ..integrators.base import stratum_arrays
from ..sampler import uniform as U
from ..sampler.uniform import UniformSampler

F32 = torch.float32


def mesh_devices(devices, rank: int, world: int):
    """(device type, this rank's device or None) of make_mesh's
    ``devices``: None (the card), a device type, or one device per
    rank."""
    if devices is None:
        devices = "cuda"
    if isinstance(devices, (str, torch.device)):
        return torch.device(devices).type, None
    devs = [torch.device(d) for d in devices]
    if len(devs) != world:
        raise ValueError(f"{len(devs)} devices for {world} ranks")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"devices of several types: {devs}")
    return devs[0].type, devs[rank]


def make_mesh(devices=None, axis: str = "rays"):
    """A 1-D DeviceMesh over the default process group, its one dimension
    named ``axis``. ``devices``: None (the card), a device type ("cpu"),
    or one device per rank (a CUDA rank then makes its device current)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group first "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    dtype, local = mesh_devices(devices, dist.get_rank(), world)
    if local is not None and local.type == "cuda":
        torch.cuda.set_device(local)
    return DeviceMesh(dtype, list(range(world)), mesh_dim_names=(axis,))


def axis_group(mesh, axis: str):
    """(process group, this rank's index, size) of the mesh dimension
    ``axis``; raises ValueError where the mesh has no such dimension."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise ValueError(f"axis {axis!r} is not a dimension of the mesh "
                         f"{names}")
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(names.index(axis)))


def check_device(mesh, device) -> None:
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"the scene is on {device}, the mesh on "
                         f"{mesh.device_type}")


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In place: the sum of ``t`` over the group's ranks."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if is_dataclass(tree):
        return [x for f in fields(tree) for x in _leaves(getattr(tree,
                                                                 f.name))]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _rebuild(tree, it):
    if torch.is_tensor(tree):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if is_dataclass(tree):
        return replace(tree, **{f.name: _rebuild(getattr(tree, f.name), it)
                                for f in fields(tree)})
    if isinstance(tree, (tuple, list)):
        vals = [_rebuild(v, it) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return tree


def tree_map(fn, tree):
    """``tree`` (tensors in dicts, tuples, lists and dataclasses) with
    ``fn`` applied to every tensor."""
    return _rebuild(tree, iter([fn(t) for t in _leaves(tree)]))


def gather_shares(tree, group, rank: int, size: int):
    """Every tensor of ``tree`` (tensors, dicts, tuples, dataclasses) is
    this rank's share [n, ...] of an array split in ``size`` equal
    contiguous shares; returns the tree of whole arrays [size * n, ...],
    rank 0's share first, the same bits on every rank. One all_reduce a
    dtype (bools travel as int32)."""
    parts = _leaves(tree)
    out = [None] * len(parts)
    wire = [torch.int32 if t.dtype == torch.bool else t.dtype for t in parts]
    for dtype in dict.fromkeys(wire):
        idx = [i for i, w in enumerate(wire) if w == dtype]
        fill = -0.0 if dtype.is_floating_point else 0
        bufs = []
        for i in idx:
            b = torch.full((size, parts[i].numel()), fill, dtype=dtype,
                           device=parts[i].device)
            b[rank] = parts[i].reshape(-1).to(dtype)
            bufs.append(b)
        flat = all_sum(torch.cat([b.reshape(-1) for b in bufs]), group)
        off = 0
        for i, b in zip(idx, bufs):
            t = parts[i]
            g = flat[off:off + b.numel()].reshape(
                (size * t.shape[0],) + tuple(t.shape[1:]))
            out[i] = g.to(torch.bool) if t.dtype == torch.bool else g
            off += b.numel()
    return _rebuild(tree, iter(out))


def _li_fn(integrator: str):
    """The sampler integrator whose ``li`` renders the lanes."""
    if integrator == "whitted":
        from ..integrators.whitted import WhittedIntegrator
        return WhittedIntegrator
    if integrator == "path":
        from ..integrators.path import PathIntegrator
        return PathIntegrator
    raise ValueError(f"unknown sampler integrator {integrator!r}")


def shard_pixels(film, rank: int, size: int, device):
    """(pixels [n, 2] int32, valid [n] bool): rank ``rank``'s contiguous
    share of the sample-bounds grid (x fastest), padded with zeros to a
    multiple of ``size``, as ``P(axis)`` splits it."""
    (x0, y0), (x1, y1) = film.sample_bounds()
    xs = np.arange(x0, x1 + 1, dtype=np.int32)
    ys = np.arange(y0, y1 + 1, dtype=np.int32)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    pixels = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
    n = pixels.shape[0]
    pad = (-n) % size
    valid = np.concatenate([np.ones(n, bool), np.zeros(pad, bool)])
    pixels = np.concatenate([pixels, np.zeros((pad, 2), np.int32)])
    share = (n + pad) // size
    sl = slice(rank * share, (rank + 1) * share)
    return (torch.from_numpy(pixels[sl].copy()).to(device),
            torch.from_numpy(valid[sl].copy()).to(device))


def render_share(integ, scene, pixels, valid) -> FilmState:
    """The film of lanes ``pixels`` [n, 2] (``valid`` masks padded lanes)
    through every sample pass of the sampler integrator ``integ``, splat
    by the scatter (Film.add_samples): one rank's part of
    render_sharded. A padded lane adds nothing, not even filter weight."""
    film = integ.camera.film
    dev = scene.device
    state = film.initial_state(dev)
    spp = integ.sampler.samples_per_pixel
    lo, scale = stratum_arrays(integ.sampler, spp, dev)
    base_key = U.key(integ.sampler.seed, dev)
    ids = U.pixel_ids(pixels)
    pix_f = pixels.to(F32)
    for s in range(spp):
        p_film, l, weight, _ = integ.sample(scene, pixels, pix_f, ids,
                                            base_key, s, lo, scale)
        state = film.add_samples(state, p_film,
                                 torch.where(valid[:, None], l, 0.0),
                                 torch.where(valid, weight, 0.0),
                                 valid=valid)
    return state


def render_sharded(scene, camera, mesh, spp: int = 1, max_depth: int = 5,
                   seed: int = 0, axis: str = "rays",
                   integrator: str = "whitted") -> FilmState:
    """Render the camera's whole film, data-parallel over the mesh
    dimension ``axis``. Call it on every rank; each returns the merged
    FilmState. The pixels are padded to a multiple of the dimension's size
    and split evenly; the ranks' films are summed by one all_reduce a
    field. ``integrator``: "whitted" or "path"."""
    group, rank, size = axis_group(mesh, axis)
    cls = _li_fn(integrator)
    check_device(mesh, scene.device)
    integ = cls(camera, UniformSampler(spp, seed=seed), max_depth=max_depth)
    pixels, valid = shard_pixels(camera.film, rank, size, scene.device)
    state = render_share(integ, scene, pixels, valid)
    for t in state:
        all_sum(t, group)
    return state
