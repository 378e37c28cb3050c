"""Sampler-integrator render loop (port of trace_tpu/integrators/base.py).

The film-sample grid goes through in chunks of ``pixel_chunk`` lanes (by
default 1 << 16, the JAX package's, so a frame above 65,536 lanes
renders in several chunks), all samples of a chunk before the next; the
tail chunk is padded to the chunk's size with lanes at pixel (0, 0)
marked invalid, which trace like any lane (``useful_rays`` and
``queue_drops`` count them, as the JAX package's do) and add nothing to
the film. A sample pass over a chunk: identity-keyed camera samples, the
film jitter confined to the sample's stratum (a StratifiedSampler's; the
identity for the uniform sampler), ray generation, ``li``, then the
splat: the stencil (``Film.add_samples_grid``, which offsets a cropped
film by its crop window) when one chunk is the whole grid, otherwise the
scatter (``Film.add_samples``) with the chunk's valid lanes. A lane's
draws hang off its pixel, so every chunking draws the same samples; the
splats differ only in their summation order. ``spp_per_dispatch`` (the
JAX package's cap on the samples of one TPU dispatch, a relay
workaround) is accepted for the signature only, stored and read nowhere:
the port issues a chunk's samples one after another as eager launches,
so it has no dispatch to split. ``stats`` (a utils.stats.
RenderStats) gathers the JAX twin's counters and the render's time.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.ray import scale_differentials
from ..film.film import FilmState
from ..lights.lights import num_lights
from ..sampler import uniform as U
from ..sampler.uniform import UniformSampler
from . import common
from .common import sanitize_radiance

F32 = torch.float32
PIXEL_CHUNK = 1 << 16


def stratum_arrays(sampler, spp: int, device):
    """(lo [spp, 2], scale [spp, 2]) float32 on ``device``, one upload a
    render: sample s of a sampler with strata (``stratum``) lands in cell
    (s mod x, s div x) of its x * y grid; any other sampler keeps the
    identity (0, 1). Row s is the JAX twin's ``_stratum_arrays(s)``,
    operation for operation."""
    lo = np.zeros((spp, 2), np.float32)
    scale = np.ones((spp, 2), np.float32)
    if hasattr(sampler, "stratum"):
        xs = np.float32(sampler.x_samples)
        ys = np.float32(sampler.y_samples)
        for s in range(spp):
            sf = np.float32(s)
            lo[s] = (np.mod(sf, xs) / xs, np.floor(sf / xs) / ys)
            scale[s] = (np.float32(1.0) / xs, np.float32(1.0) / ys)
    return (torch.from_numpy(lo).to(device),
            torch.from_numpy(scale).to(device))


class SamplerIntegrator:
    def __init__(self, camera, sampler: UniformSampler | None = None,
                 max_depth: int = 5, pixel_chunk: int = PIXEL_CHUNK,
                 stats=None, spp_per_dispatch: int | None = None):
        self.camera = camera
        self.sampler = sampler or UniformSampler(1)
        self.max_depth = int(max_depth)
        self.pixel_chunk = int(pixel_chunk)
        self.stats = stats
        self.spp_per_dispatch = (int(spp_per_dispatch) if spp_per_dispatch
                                 else None)
        self.last_queue_drops = None
        self.last_useful_rays = None

    def li(self, scene, rd, key):
        """``key``: per-lane keys [N, 2] -> (radiance [N, 3],
        {"queue_drops", "useful_rays"})."""
        raise NotImplementedError

    def __call__(self, scene, save: bool = True) -> FilmState:
        state = self.render(scene)
        if save:
            self.camera.film.save_png(state)
        return state

    def pixel_grid(self, device) -> torch.Tensor:
        """[N, 2] int32 raster coordinates of the sample-bounds grid,
        x fastest."""
        (x0, y0), (x1, y1) = self.camera.film.sample_bounds()
        xs = np.arange(x0, x1 + 1, dtype=np.int32)
        ys = np.arange(y0, y1 + 1, dtype=np.int32)
        gx, gy = np.meshgrid(xs, ys, indexing="xy")
        grid = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
        return torch.from_numpy(grid).to(device)

    def sample(self, scene, pixels, pix_f, ids, base_key, s: int, lo, scale):
        """Sample pass ``s`` of the lanes ``pixels`` [N, 2] (``pix_f`` as
        float32, ``ids`` their U.pixel_ids; ``lo``, ``scale`` from
        stratum_arrays): identity-keyed camera samples jittered inside
        their stratum, rays scaled by 1/sqrt(spp), ``li``. A lane's draw
        depends only on its pixel, so any subset of the grid (a rank's
        share in parallel.render) draws what the whole grid draws there.
        -> (p_film [N, 2], sanitized radiance [N, 3], weight [N], aux)."""
        spp = self.sampler.samples_per_pixel
        ks = U.lane_keys(U.fold_in(base_key, s), ids)
        p_film, u_lens, u_time = U.get_camera_samples_lanes(
            U.fold_lanes(ks, 0), pixels)
        p_film = pix_f + lo[s] + (p_film - pix_f) * scale[s]
        rd, weight = self.camera.generate_ray_differentials(
            p_film, u_lens, u_time)
        rd = scale_differentials(rd, float(np.float32(1.0 / np.sqrt(spp))))
        l, aux = self.li(scene, rd, U.fold_lanes(ks, 1))
        return p_film, sanitize_radiance(l), weight, aux

    def render(self, scene, geometry=None, geometry_transform=None,
               geometry_accel=None) -> FilmState:
        """Render ``scene`` in chunks of ``pixel_chunk`` lanes (module
        docstring). ``geometry`` (optional): a Triangles table with
        the scene's topology and moved vertices, which replaces the
        scene's for this render -- one frame of animated geometry, its
        sweep tables rebuilt on the device; ``geometry_transform`` moves
        it there first; ``geometry_accel`` gives pre-built tables instead
        (common.prepare_geometry)."""
        scene = common.apply_geometry(scene, common.prepare_geometry(
            scene, geometry, geometry_transform, geometry_accel))
        dev = scene.device
        film = self.camera.film
        state = film.initial_state(dev)
        pixels = self.pixel_grid(dev)
        (x0, y0), (x1, y1) = film.sample_bounds()
        grid_hw = (y1 - y0 + 1, x1 - x0 + 1)
        spp = self.sampler.samples_per_pixel
        base_key = U.key(self.sampler.seed, dev)
        ids = U.pixel_ids(pixels)
        n = pixels.shape[0]
        if self.stats is not None:
            self.stats.start("render")
            # Per level, one closest-hit and one shadow ray per light for
            # every lane: the JAX twin's numerator (dead lanes counted).
            self.stats.add("camera_samples", n * spp)
            self.stats.add("rays_dispatched", n * spp * self.max_depth
                           * (1 + num_lights(scene.lights)))
        lo, scale = stratum_arrays(self.sampler, spp, dev)
        drops = torch.zeros((), dtype=torch.int64, device=dev)
        useful = torch.zeros((), dtype=torch.int64, device=dev)
        chunk = min(self.pixel_chunk, n)
        for start in range(0, n, chunk):
            part, p_ids, valid = pixels[start:start + chunk], None, None
            if chunk < n:
                p_ids = ids[start:start + chunk]
                valid = torch.ones(chunk, dtype=torch.bool, device=dev)
                pad = chunk - part.shape[0]
                if pad:   # the tail: lanes at pixel (0, 0), invalid
                    zeros = part.new_zeros((pad, 2))
                    part = torch.cat([part, zeros])
                    p_ids = torch.cat([p_ids, U.pixel_ids(zeros)])
                    valid[chunk - pad:] = False
            pix_f = part.to(F32)
            for s in range(spp):
                p_film, l, weight, aux = self.sample(
                    scene, part, pix_f, ids if p_ids is None else p_ids,
                    base_key, s, lo, scale)
                if valid is None:
                    state = film.add_samples_grid(state, p_film, l, weight,
                                                  (x0, y0), grid_hw)
                else:
                    state = film.add_samples(
                        state, p_film, torch.where(valid[:, None], l, 0.0),
                        torch.where(valid, weight, 0.0), valid=valid)
                drops = drops + aux["queue_drops"]
                useful = useful + aux["useful_rays"]
        self.last_queue_drops = int(drops)
        self.last_useful_rays = int(useful)
        if self.stats is not None:
            self.stats.stop("render")
            self.stats.add("specular_queue_drops", self.last_queue_drops)
            self.stats.add("useful_rays", self.last_useful_rays)
        return state
