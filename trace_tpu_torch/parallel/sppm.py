"""Multi-device SPPM: pixel-, photon- and pair-level data parallelism over
a torch.distributed device mesh (port of trace_tpu/parallel/sppm.py).

Every sample dimension of a photon is keyed on its global Halton index,
and every camera draw on its pixel, so splitting photons and pixels over
ranks changes no draw: each rank walks its contiguous range of Halton
indices (or pixels), and the ranks' results are gathered in rank order
(render.gather_shares), which is the layout of the JAX package's
``out_specs=P(axis)``: rank by rank, each rank level by level. The pair
reduction becomes per-rank partial (phi, M) accumulators, each rank
taking its own chunk of the global pair list, summed by one all_reduce:
the deterministic replacement for the reference's atomics.

The scene, the grid and the visible points are replicated: every rank
builds the same grid from the same gathered points. Each function takes
its JAX twin's arguments and returns on every rank what the twin's
``out_specs`` give globally. The JAX package caches its jitted shard_map
bodies; torch compiles nothing, so there is nothing to cache.
"""
from __future__ import annotations

import torch

from .render import all_sum, axis_group, gather_shares

F32 = torch.float32


def _share(x, rank: int, size: int):
    n = x.shape[0] // size
    return x[rank * n:(rank + 1) * n]


def camera_pass_sharded(integ, scene, mesh, axis: str, pixels, lane_valid,
                        it_key):
    """The SPPM camera pass over the mesh dimension ``axis``: ``pixels``
    [P, 2] and ``lane_valid`` [P] padded to a multiple of its size, rank r
    walking the r-th share -> (ld_add [P, 3], VisiblePoints [P]) on every
    rank. Pixel-identity-keyed streams make it bit-exact against the
    single-device pass."""
    from ..wavefront import sppm_camera

    group, rank, size = axis_group(mesh, axis)
    ld, vp = sppm_camera.camera_pass_body(
        integ, scene, _share(pixels, rank, size),
        _share(lane_valid, rank, size), it_key)
    return gather_shares((ld, vp), group, rank, size)


def photon_walk_sharded(integ, scene, mesh, axis: str, halton_idx,
                        lane_valid, light_cdf, light_pmf, grid_lo, grid_res,
                        grid_inv_extent, sorted_cells,
                        idx_max: int | None = None):
    """The photon walk over ``axis``: ``halton_idx`` [N] (uint32 values in
    int64) and ``lane_valid`` [N] padded to a multiple of its size, rank r
    walking the r-th range -> the splat records of all N photons, rank by
    rank, each rank level by level. ``idx_max`` (optional) is a host bound
    on the indices; it only shortens the digit loops."""
    from ..wavefront import sppm_photon

    group, rank, size = axis_group(mesh, axis)
    splat = sppm_photon.photon_walk_body(
        integ, scene, _share(halton_idx, rank, size),
        _share(lane_valid, rank, size), light_cdf, light_pmf, grid_lo,
        grid_res, grid_inv_extent, sorted_cells, idx_max=idx_max)
    return gather_shares(splat, group, rank, size)


def pair_pass_sharded(integ, mesh, axis: str, phi, m_cnt, total: int,
                      offsets, sp_p, sp_d, sp_beta, sp_start, vp, radius,
                      sorted_vp, super_chunk: int, bases, tables=None):
    """One sharded pair sweep: rank r reduces the pairs [bases[r],
    bases[r] + super_chunk / size) of the ``total`` into zero (phi, M)
    (``integ._pair_body``); the partials are summed over ``axis`` and
    added to the running accumulators. ``bases``: a host sequence, one
    base a rank; ``tables`` (integrators.sppm.pair_tables) may be built
    once per iteration. -> (phi, M), new tensors."""
    group, rank, size = axis_group(mesh, axis)
    n_local = super_chunk // size
    dphi = torch.zeros_like(phi)
    dm = torch.zeros_like(m_cnt)
    integ._pair_body(dphi, dm, int(bases[rank]), int(total), offsets, sp_p,
                     sp_d, sp_beta, sp_start, vp, radius, sorted_vp, n_local,
                     tables)
    return phi + all_sum(dphi, group), m_cnt + all_sum(dm, group)
