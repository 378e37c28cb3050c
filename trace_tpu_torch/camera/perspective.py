"""Perspective camera with batched ray generation (port of
trace_tpu/camera/perspective.py): pinhole or thin lens, under either
convention.

The raster -> camera chain is built on the host. ``convention=
"reference"`` keeps the reference's literal matrix semantics
(``compose_ref`` and the transposed projection, see core/transform.py);
``"pbrt"`` is the standard PBRT chain (true inverses, ``perspective_pbrt``
with z flipped, the raster's y flipped). Ray generation runs on the
film-sample tensors' device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import math as m
from ..core import transform as T
from ..core import vec as V
from ..core.ray import RayDifferentials
from ..core.sync import device_constant
from ..film.film import Film

F32 = torch.float32


class PerspectiveCamera:
    def __init__(self, camera_to_world: T.Transform,
                 screen_window=((-1.0, -1.0), (1.0, 1.0)),
                 shutter_open: float = 0.0, shutter_close: float = 1.0,
                 lens_radius: float = 0.0, focal_distance: float = 1e6,
                 fov: float = 90.0, film: Film = None,
                 convention: str = "reference"):
        if film is None:
            raise ValueError("PerspectiveCamera requires a Film")
        if convention not in ("reference", "pbrt"):
            raise ValueError(f"unknown camera convention {convention!r}")
        self.camera_to_world = camera_to_world
        self.shutter_open = float(shutter_open)
        self.shutter_close = float(shutter_close)
        self.lens_radius = float(lens_radius)
        self.focal_distance = float(focal_distance)
        self.film = film

        pbrt = convention == "pbrt"
        if pbrt:
            # look_at has the camera look down -z; PBRT's projection looks
            # down +z, so z is flipped into it.
            camera_to_screen = T.compose(T.perspective_pbrt(fov, 1e-2, 1000.0),
                                         T.scale(1.0, 1.0, -1.0))
        else:
            camera_to_screen = T.perspective(fov, 1e-2, 1000.0)
        (sx0, sy0), (sx1, sy1) = screen_window
        rx, ry = film.resolution
        # PBRT flips y in the raster chain; the reference's positive y
        # scale and wrong-order inverses are kept under its convention.
        y_scale = 1.0 / (sy0 - sy1) if pbrt else 1.0 / (sy1 - sy0)
        comp = T.compose if pbrt else T.compose_ref
        screen_to_raster = comp(
            comp(T.scale(rx, ry, 1.0),
                 T.scale(1.0 / (sx1 - sx0), y_scale, 1.0)),
            T.translate([-sx0, -sy1, 0.0]),
        )
        self.raster_to_camera = comp(T.inverse(camera_to_screen),
                                     T.inverse(screen_to_raster))

    def _one_ray(self, p_film: torch.Tensor, u_lens: torch.Tensor):
        """Camera-space origin/direction for film points [N, 2]; with a
        lens, ``u_lens`` [N, 2] picks the point on it."""
        p_cam = T.apply_point(
            self.raster_to_camera,
            torch.cat([p_film, torch.zeros_like(p_film[..., :1])], dim=-1))
        d = m.normalize(p_cam)
        if self.lens_radius <= 0:
            return torch.zeros_like(d), d
        lx, ly = V.concentric_sample_disk(u_lens[..., 0], u_lens[..., 1])
        # Camera rays travel toward -z, so the focal plane lies at z =
        # -focal_distance (the reference divides by +d.z and turns every
        # lens ray backwards; the JAX package fixes that, and so does
        # this port). A tensor numerator: torch computes a Python scalar
        # over a tensor as a reciprocal times the scalar.
        ft = torch.full_like(d[..., 2], self.focal_distance) / -d[..., 2]
        p_focus = d * ft[..., None]
        o = torch.stack([self.lens_radius * lx, self.lens_radius * ly,
                         torch.zeros_like(lx)], dim=-1)
        return o, m.normalize(p_focus - o)

    def generate_ray_differentials(self, p_film, u_lens, u_time):
        """p_film [N, 2] (1-based raster), u_lens [N, 2] (read by a thin
        lens), u_time [N] -> (RayDifferentials, weight [N])."""
        dev = p_film.device
        o_c, d_c = self._one_ray(p_film, u_lens)
        ox_c, dx_c = self._one_ray(
            p_film + device_constant((1.0, 0.0), F32, dev), u_lens)
        oy_c, dy_c = self._one_ray(
            p_film + device_constant((0.0, 1.0), F32, dev), u_lens)
        c2w = self.camera_to_world
        time = m.lerp(float(np.float32(self.shutter_open)),
                      float(np.float32(self.shutter_close)), u_time)
        n = p_film.shape[0]
        rd = RayDifferentials(
            o=T.apply_point(c2w, o_c),
            d=m.normalize(T.apply_vec(c2w, d_c)),
            t_max=torch.full((n,), float("inf"), dtype=F32, device=dev),
            time=time,
            has_differentials=torch.ones((n,), dtype=torch.bool, device=dev),
            rx_origin=T.apply_point(c2w, ox_c),
            ry_origin=T.apply_point(c2w, oy_c),
            rx_direction=m.normalize(T.apply_vec(c2w, dx_c)),
            ry_direction=m.normalize(T.apply_vec(c2w, dy_c)),
        )
        return rd, torch.ones((n,), dtype=F32, device=dev)
