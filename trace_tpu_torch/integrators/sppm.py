"""Stochastic Progressive Photon Mapping (port of
trace_tpu/integrators/sppm.py, the stepwise path, on one device or
sharded over a torch.distributed mesh).

Five phases an iteration (``_iteration``, on either route), each a
method so a caller can time it:

1. ``_camera_pass_all``: one bounce walk per pixel, in chunks of
   ``pixel_chunk`` pixels (wavefront/sppm_camera.py); visible points land
   in ``VisiblePoints`` (p, wo, beta and a compact 2-slot lobe table).
2. ``_build_grid``: each visible point emits its <= 8 overlapped cells
   (cell edge 2 * max radius), hashed, stably sorted by cell.
3. ``_photon_walk_all``: Halton-keyed emission and walk in chunks of
   ``pixel_chunk`` photons (wavefront/sppm_photon.py); splat records
   carry each photon hit's range of sorted grid entries.
4. ``_pair_loop``: the (photon, visible point) candidate pairs, expanded
   by an exclusive scan over the records' entry counts, in chunks of
   ``pair_chunk`` pairs; each chunk is reduced into (phi, M) by a
   scatter-add that adds in the same order on every run.
5. ``_update_pixels``: the radius/tau update, then ``to_image``.

The pair count is read on the host once per iteration and the pair
chunks loop in Python. Like the reference, the direct lighting added to
Ld is not scaled by the path throughput.

Fused blocks (``fused_iterations``, JAX's ``_iterations_fused``): up to
``fused_block`` iterations run as one block through the sync-free body
``_iterations_body`` -- every depth and every sweep chunk
(core/sync.py), full Halton trips, the pair total kept on the device and
a fixed number of pair chunks, the instance walks' pairs in buffers of a
fixed size (accel/instances.py) -- which gives the stepwise state bit
for bit. On the card a block length's blocks after its first in a scene
view are replays of one CUDA graph (integrators/fused.py); the host
reads once a block whether the pairs overflowed the chunks or an
instance walk's buffer (the block then runs again stepwise, and later
blocks take larger ones). ``fused_cost_analysis`` counts a block's work
from its static shapes. ``fused_unroll`` is kept for the JAX signature:
a block is straight-line code in a graph either way.

Animated geometry (``render(geometry=, geometry_transform=)``) and
relit frames (``render_frames``) run the same stepwise path on a scene
view (integrators/common.py), on one device.

With ``mesh`` (parallel.render.make_mesh) every rank runs the iteration:
the photon walk and the pair pass are split over the mesh dimension
``shard_axis``, the camera pass too with ``shard_camera``
(parallel/sppm.py); each rank holds the whole state, the same bits on
every rank. Any mix of lights
renders (the camera pass picks one light per lane); a scene whose
materials the planar wavefront cannot shade raises, as in
wavefront/path.py. The environment light emits photons from a disk of
the scene's bounding radius on the side of a direction its texel tables
pick. ``stats`` (a utils.stats.RenderStats) gathers the JAX twin's
per-iteration counters, at the cost of a few host reads.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from ..core.math import scatter_add as _scatter_add
from ..core.sync import StaticRoute, no_host_reads
from ..core.vec import V3
from ..lights import lights as light_mod
from ..sampler import uniform as U
from ..utils.stats import span, spanned
from ..wavefront import path as WP
from ..wavefront import shade as S
from . import common, fused

F32 = torch.float32
M32 = 0xFFFFFFFF
VP_LOBES = 2  # compact visible-point lobe slots (the shipped materials put
              # their non-specular lobes in slots 0..1)
GAMMA = float(np.float32(2 / 3))
# Pixels (and photons) per camera / photon chunk and pairs per pair chunk.
# One chunk covers a 1024^2 frame's pixels and config 3's 262144 photons:
# the passes issue each tensor op once per chunk, and the card's frames
# are bound by the host issuing them (PERF.md).
PIXEL_CHUNK = 1 << 20
PAIR_CHUNK = 1 << 22


@dataclass
class SPPMState:
    ld: torch.Tensor       # [P, 3] accumulated direct lighting
    tau: torch.Tensor      # [P, 3]
    radius: torch.Tensor   # [P]
    n: torch.Tensor        # [P] photon count estimate
    phi: torch.Tensor      # [P, 3] this iteration's photon sum
    m: torch.Tensor        # [P] int32 this iteration's photon count


@dataclass
class PackedLobes:
    """Per-lane lobe table, slots on axis 1 (the JAX package's bsdf.Lobes
    layout): kind/fr_kind int32 [N, L], c0/c1/fr_eta/fr_k [N, L, 3],
    eta_a/eta_b/a/b [N, L], frame ng/ns/ss/ts [N, 3], eta [N]."""
    kind: torch.Tensor
    c0: torch.Tensor
    c1: torch.Tensor
    eta_a: torch.Tensor
    eta_b: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    fr_kind: torch.Tensor
    fr_eta: torch.Tensor
    fr_k: torch.Tensor
    ng: torch.Tensor
    ns: torch.Tensor
    ss: torch.Tensor
    ts: torch.Tensor
    eta: torch.Tensor


SLOT_FIELDS = ("kind", "c0", "c1", "eta_a", "eta_b", "a", "b", "fr_kind",
               "fr_eta", "fr_k")


@dataclass
class VisiblePoints:
    p: torch.Tensor        # [P, 3]
    wo: torch.Tensor       # [P, 3]
    beta: torch.Tensor     # [P, 3]
    valid: torch.Tensor    # [P] bool
    lobes: PackedLobes     # VP_LOBES slots + frame


def initial_state(n_pixels: int, initial_radius: float,
                  device="cuda") -> SPPMState:
    z3 = lambda: torch.zeros((n_pixels, 3), dtype=F32, device=device)
    return SPPMState(
        ld=z3(), tau=z3(),
        radius=torch.full((n_pixels,), float(initial_radius), dtype=F32,
                          device=device),
        n=torch.zeros((n_pixels,), dtype=F32, device=device),
        phi=z3(), m=torch.zeros((n_pixels,), dtype=torch.int32,
                                device=device))


def _compact_lobes(lobes: PackedLobes) -> PackedLobes:
    """Keep the first VP_LOBES slots (delta lobes in later slots evaluate
    to 0 in the photon phase anyway)."""
    return replace(lobes, **{f: getattr(lobes, f)[:, :VP_LOBES]
                             for f in SLOT_FIELDS})


def _cat_tree(parts):
    """Concatenate a list of same-type dataclasses of tensors along axis 0."""
    first = parts[0]
    out = {}
    for f in fields(first):
        vals = [getattr(p, f.name) for p in parts]
        out[f.name] = (_cat_tree(vals) if not torch.is_tensor(vals[0])
                       else torch.cat(vals))
    return type(first)(**out)


def _hash_cells(gx, gy, gz, n_pixels: int) -> torch.Tensor:
    """3-prime XOR hash of grid coords, uint32 arithmetic (wrapping) in
    int64 -> int32 cell id in [0, n_pixels)."""
    h = (((gx.to(torch.int64) & M32) * 73856093) & M32) \
        ^ (((gy.to(torch.int64) & M32) * 19349663) & M32) \
        ^ (((gz.to(torch.int64) & M32) * 83492791) & M32)
    return (h % n_pixels).to(torch.int32)


def _to_grid(p, lo, res, inv_extent):
    """Grid coords [N, 3] int32 (clipped) and the in-bounds flag."""
    off = (p - lo) * inv_extent
    g = torch.floor(res.to(F32) * off).to(torch.int32)
    in_bounds = ((g >= 0) & (g < res)).all(-1)
    return in_bounds, torch.clamp(g, min=torch.zeros_like(res), max=res - 1)


@dataclass
class PairTables:
    """Loop-invariant row tables of one iteration's pair pass."""
    vp_rows: torch.Tensor   # [P, 21 + 18 * VP_LOBES] f32
    sp_rows: torch.Tensor   # [S, 9] f32 (splat p, d, beta)
    kinds: tuple            # S.SlotKinds of the VP_LOBES slots; () = any


def pair_tables(vp: VisiblePoints, radius, sp_p, sp_d, sp_beta,
                kinds=()) -> PairTables:
    """The visible-point row table (p, radius, valid, wo, frame, eta,
    then per slot kind, c0, c1, eta_a, eta_b, a, b, fr_kind, fr_eta, fr_k;
    kinds as float32 values, exact for these small codes) and the splat
    row table, so a pair costs two row gathers."""
    lob = vp.lobes
    cols = [vp.p, radius[:, None], vp.valid.to(F32)[:, None], vp.wo,
            lob.ng, lob.ns, lob.ss, lob.ts, lob.eta[:, None]]
    for sl in range(VP_LOBES):
        cols += [lob.kind[:, sl, None].to(F32), lob.c0[:, sl], lob.c1[:, sl],
                 lob.eta_a[:, sl, None], lob.eta_b[:, sl, None],
                 lob.a[:, sl, None], lob.b[:, sl, None],
                 lob.fr_kind[:, sl, None].to(F32), lob.fr_eta[:, sl],
                 lob.fr_k[:, sl]]
    return PairTables(torch.cat(cols, 1),
                      torch.cat([sp_p, sp_d, sp_beta], 1), tuple(kinds))


class SPPMIntegrator:
    """SPPM over the planar wavefront. Runs on ``device`` (the card unless
    the caller asks for the CPU); the scene must live there too.
    ``stats`` (optional utils.stats.RenderStats) gathers per-iteration
    counters, at the cost of host reads; they count the whole iteration
    on every rank of a mesh. ``mesh`` (a DeviceMesh with a dimension
    ``shard_axis``): the photon walk and the pair pass run split over its
    ranks, the camera pass too with ``shard_camera``; call ``render`` on
    every rank. Photons and pixels keep their single-device draws, so the
    sharded run matches one device: bit for bit at depth 2 while an
    iteration's pairs fit one pair chunk, to the f32 order of the pair
    sums beyond (deeper splat records lie rank by rank, and each chunk's
    partial sums add to the running ones). ``fused_iterations``: blocks
    of up to ``fused_block`` iterations (module docstring), when render
    has no mesh, stats, progress or checkpoint, as in the JAX package;
    ``fused_graphs`` then holds the card's captures and their memory
    (None frees them)."""

    def __init__(self, camera, initial_search_radius: float = 1.0,
                 max_depth: int = 5, n_iterations: int = 64,
                 photons_per_iteration: int = -1, write_frequency: int = 0,
                 pixel_chunk: int = PIXEL_CHUNK, pair_chunk: int = PAIR_CHUNK,
                 seed: int = 0, stats=None, mesh=None,
                 shard_axis: str = "photons", shard_camera: bool = False,
                 fused_iterations: bool = False, fused_block: int = 8,
                 fused_unroll: bool = False, device="cuda"):
        if mesh is not None:
            from ..parallel.render import axis_group, check_device

            axis_group(mesh, shard_axis)
            check_device(mesh, device)
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.shard_camera = bool(shard_camera)
        self.camera = camera
        self.device = torch.device(device)
        self.initial_search_radius = float(initial_search_radius)
        self.max_depth = int(max_depth)
        self.n_iterations = int(n_iterations)
        film = camera.film
        self.n_pixels = film.width * film.height
        self.photons_per_iteration = (
            int(photons_per_iteration) if photons_per_iteration > 0
            else self.n_pixels)
        self.write_frequency = int(write_frequency)
        self.pixel_chunk = int(pixel_chunk)
        self.pair_chunk = int(pair_chunk)
        self.seed = int(seed)
        self.stats = stats
        self.fused_iterations = bool(fused_iterations)
        self.fused_block = max(1, int(fused_block))
        self.fused_unroll = bool(fused_unroll)
        # Pair chunks a fused block runs (K); raised after an overflow.
        self.fused_pair_chunks = 1
        # The instance walks' pair buffer a fused block gives each
        # instanced geometry (core/sync.py's StaticRoute): none before
        # its first block (the walk's bound), then twice the power of two
        # of the most pairs a group had, raised after an overflow.
        self.fused_pair_capacity = {}
        # Blocks run again stepwise after an overflow (pairs or an
        # instance walk's pair buffer).
        self.fused_reruns = 0
        self.fused_graphs = None
        self.last_pair_totals = None

    # -- phase 1: camera pass ------------------------------------------------

    @spanned("sppm.camera_pass")
    def _camera_pass_all(self, scene, pixels, it_key, tally=None):
        """Every pixel chunk -> (ld_add [P, 3], VisiblePoints). ``tally``:
        a list that gets the walk's self-hit counts (camera_pass_body)."""
        from ..wavefront import sppm_camera

        lds, vps = [], []
        for s in range(0, pixels.shape[0], self.pixel_chunk):
            part = pixels[s:s + self.pixel_chunk]
            valid = torch.ones(part.shape[0], dtype=torch.bool,
                               device=part.device)
            ld, vp = sppm_camera.camera_pass_body(self, scene, part, valid,
                                                  it_key, tally=tally)
            lds.append(ld)
            vps.append(vp)
        return torch.cat(lds), _cat_tree(vps)

    # -- phase 2: grid -------------------------------------------------------

    def _build_grid(self, vp: VisiblePoints, radius) -> dict:
        """Sorted cell-entry table over the visible points. Cell edge = 2 *
        max radius, so a point's radius box overlaps at most 2 cells per
        axis: 8 entries a point, duplicates masked."""
        p_total = vp.p.shape[0]
        valid = vp.valid & ~(vp.beta == 0.0).all(-1)
        big = 3e38
        r = torch.where(valid, radius, 0.0)
        lo = torch.where(valid[:, None], vp.p - r[:, None], big).amin(0)
        hi = torch.where(valid[:, None], vp.p + r[:, None], -big).amax(0)
        max_r = r.max().clamp_min(1e-12)
        diag = (hi - lo).clamp_min(1e-12)
        max_diag = diag.max()
        base_res = torch.floor(max_diag / (2.0 * max_r)).clamp_min(1.0)
        res = torch.floor(base_res * diag / max_diag).clamp_min(1.0).to(
            torch.int32)
        inv_extent = 1.0 / diag

        _, gmin = _to_grid(vp.p - r[:, None], lo, res, inv_extent)
        _, gmax = _to_grid(vp.p + r[:, None], lo, res, inv_extent)
        cells, masks, seen = [], [], []
        for cz in (0, 1):
            for cy in (0, 1):
                for cx in (0, 1):
                    gx = (gmin if cx == 0 else gmax)[:, 0]
                    gy = (gmin if cy == 0 else gmax)[:, 1]
                    gz = (gmin if cz == 0 else gmax)[:, 2]
                    dup = torch.zeros(p_total, dtype=torch.bool,
                                      device=vp.p.device)
                    for s in seen:
                        dup = dup | ((s[0] == gx) & (s[1] == gy)
                                     & (s[2] == gz))
                    seen.append((gx, gy, gz))
                    cells.append(_hash_cells(gx, gy, gz, self.n_pixels))
                    masks.append(valid & ~dup)
        cell_ids = torch.stack(cells, 1).reshape(-1)
        entry_ok = torch.stack(masks, 1).reshape(-1)
        vp_ids = torch.arange(p_total, dtype=torch.int32,
                              device=vp.p.device)[:, None].expand(
                                  p_total, 8).reshape(-1)
        sort_key = torch.where(entry_ok, cell_ids, self.n_pixels)
        order = torch.argsort(sort_key, stable=True)
        return dict(sorted_cells=sort_key[order], sorted_vp=vp_ids[order],
                    lo=lo, res=res, inv_extent=inv_extent)

    # -- phase 3: photon walk ------------------------------------------------

    @spanned("sppm.photon_walk")
    def _photon_walk_all(self, scene, halton_base, light_cdf, light_pmf,
                         grid: dict, tally=None) -> dict:
        """Every photon chunk -> splat records: dict of p, d, beta [S, 3],
        start, count [S] int32, S = (max_depth - 1) x photons, laid out
        chunk by chunk, each chunk level by level. ``halton_base``: a host
        int, or a device scalar (the Halton digit loops then run their
        full trip count). ``tally``: a list that gets the walk's self-hit
        counts (photon_walk_body)."""
        from ..wavefront import sppm_photon

        np_iter = self.photons_per_iteration
        chunk = min(self.pixel_chunk, np_iter)
        dev = light_cdf.device
        parts = []
        for c0 in range(0, np_iter, chunk):
            n = min(chunk, np_iter - c0)
            first = halton_base + c0
            idx = (first + torch.arange(n, dtype=torch.int64, device=dev)
                   ) & M32
            last = first + n - 1
            parts.append(sppm_photon.photon_walk_body(
                self, scene, idx, torch.ones(n, dtype=torch.bool, device=dev),
                light_cdf, light_pmf, grid["lo"], grid["res"],
                grid["inv_extent"], grid["sorted_cells"],
                idx_max=(None if torch.is_tensor(last) or last > M32
                         else last), tally=tally))
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    # -- phase 4: pair reduction ---------------------------------------------

    def _pair_loop(self, phi, m_cnt, total, offsets, splat: dict,
                   vp: VisiblePoints, radius, sorted_vp, kinds=(),
                   chunks: int | None = None):
        """All ``total`` pairs in chunks of ``pair_chunk`` -> (phi, M), new
        tensors (the inputs are left as they were). ``total`` is a host
        int, or with ``chunks`` a device scalar (JAX's device-side loop):
        then ``chunks`` chunks run whatever the total, and each pair at or
        past it adds to a sink row of its own past the last pixel, so
        every pixel sums the same pairs in the same order as the host loop
        (and no row gathers a long run of them: the card's deterministic
        scatter adds one row's entries one after another); pairs past
        ``chunks`` chunks are left out, and the caller checks the total.
        With a mesh, rank r takes the r-th ``pair_chunk`` pairs of each
        (mesh size) x ``pair_chunk`` (parallel.sppm.pair_pass_sharded)."""
        tables = pair_tables(vp, radius, splat["p"], splat["d"],
                             splat["beta"], kinds)
        if self.mesh is not None:
            from ..parallel.sppm import pair_pass_sharded

            size = self._mesh_size()
            for base in range(0, total, size * self.pair_chunk):
                phi, m_cnt = pair_pass_sharded(
                    self, self.mesh, self.shard_axis, phi, m_cnt, total,
                    offsets, splat["p"], splat["d"], splat["beta"],
                    splat["start"], vp, radius, sorted_vp,
                    size * self.pair_chunk,
                    [base + r * self.pair_chunk for r in range(size)],
                    tables=tables)
            return phi, m_cnt
        if chunks is None:
            phi, m_cnt = phi.clone(), m_cnt.clone()
            bases = range(0, total, self.pair_chunk)
        else:
            sink = self.pair_chunk
            phi = torch.cat([phi, phi.new_zeros((sink, 3))])
            m_cnt = torch.cat([m_cnt, m_cnt.new_zeros(sink)])
            bases = range(0, chunks * self.pair_chunk, self.pair_chunk)
        for base in bases:
            self._pair_body(phi, m_cnt, base, total, offsets, splat["p"],
                            splat["d"], splat["beta"], splat["start"], vp,
                            radius, sorted_vp, self.pair_chunk, tables)
        if chunks is not None:
            phi, m_cnt = phi[:-sink], m_cnt[:-sink]
        return phi, m_cnt

    def _pair_body(self, phi, m_cnt, pair_base: int, total, offsets,
                   sp_p, sp_d, sp_beta, sp_start, vp: VisiblePoints, radius,
                   sorted_vp, chunk: int, tables: PairTables | None = None):
        """Accumulate pairs [pair_base, min(pair_base + chunk, total)) into
        (phi, M) in place; returns them. ``tables`` (pair_tables) may be
        built once per iteration; without it the lobe evaluation runs
        every kind. A device scalar ``total`` runs the whole chunk, pair
        ``pair_base + i`` at or past it adding to row i of the last
        ``chunk`` rows of (phi, M), a sink (_pair_loop)."""
        if tables is None:
            tables = pair_tables(vp, radius, sp_p, sp_d, sp_beta)
        dev = phi.device
        past = None
        if torch.is_tensor(total):
            j = torch.arange(pair_base, pair_base + chunk, dtype=torch.int32,
                             device=dev)
            past = j >= total
        else:
            stop = min(pair_base + chunk, total)
            if stop <= pair_base:
                return phi, m_cnt
            j = torch.arange(pair_base, stop, dtype=torch.int32, device=dev)
        s = (torch.searchsorted(offsets, j, right=True) - 1).clamp(
            0, offsets.shape[0] - 1)
        k = j - offsets[s]
        entry = (sp_start[s] + k).clamp(0, sorted_vp.shape[0] - 1)
        vp_id = sorted_vp[entry].long()

        g = tables.vp_rows[vp_id].T.contiguous()      # [55, pairs]
        h = tables.sp_rows[s].T.contiguous()          # [9, pairs]
        v3 = lambda t, i: V3(t[i], t[i + 1], t[i + 2])
        slots = []
        for sl in range(VP_LOBES):
            o = 21 + sl * 18
            slots.append(S.LobeSlotP(
                kind=g[o].to(torch.int32), c0=v3(g, o + 1), c1=v3(g, o + 4),
                eta_a=g[o + 7], eta_b=g[o + 8], a=g[o + 9], b=g[o + 10],
                fr_kind=g[o + 11].to(torch.int32), fr_eta=v3(g, o + 12),
                fr_k=v3(g, o + 15)))
        lo_p = S.LobesP(slots=tuple(slots), ng=v3(g, 8), ns=v3(g, 11),
                        ss=v3(g, 14), ts=v3(g, 17), eta=g[20],
                        kinds=tables.kinds)
        r = g[3]
        d2 = (v3(g, 0) - v3(h, 0)).length_squared()
        ok = (g[4] != 0.0) & (d2 <= r * r)
        f_val = S.f(lo_p, v3(g, 5), -v3(h, 3), S.BSDF_ALL)
        c = v3(h, 6) * f_val
        contrib = torch.stack([torch.where(ok, c.x, 0.0),
                               torch.where(ok, c.y, 0.0),
                               torch.where(ok, c.z, 0.0)], 1)
        if past is not None:
            vp_id = torch.where(past, (j - pair_base).long()
                                + (phi.shape[0] - chunk), vp_id)
        _scatter_add(phi, vp_id, contrib)
        _scatter_add(m_cnt, vp_id, ok.to(torch.int32))
        return phi, m_cnt

    # -- phase 5: pixel update and image -------------------------------------

    @spanned("sppm.update")
    def _update_pixels(self, state: SPPMState, ld_add) -> SPPMState:
        has = state.m > 0
        mf = state.m.to(F32)
        n_new = state.n + GAMMA * mf
        r_new = state.radius * torch.sqrt(
            n_new / (state.n + mf).clamp_min(1e-20))
        q = r_new / state.radius.clamp_min(1e-20)
        tau_new = (state.tau + state.phi) * (q * q)[:, None]
        return SPPMState(
            ld=state.ld + ld_add,
            tau=torch.where(has[:, None], tau_new, state.tau),
            radius=torch.where(has, r_new, state.radius),
            n=torch.where(has, n_new, state.n),
            phi=torch.zeros_like(state.phi), m=torch.zeros_like(state.m))

    def to_image(self, state: SPPMState, iteration: int) -> torch.Tensor:
        """-> [H, W, 3] rgb."""
        film = self.camera.film
        np_total = float(np.float32(iteration * self.photons_per_iteration
                                    * np.pi))
        r = state.radius.clamp_min(1e-20)
        img = state.ld / float(iteration) + state.tau / (
            np_total * (r * r))[:, None]
        return img.reshape(film.height, film.width, 3)

    # -- main loop -----------------------------------------------------------

    def _pixel_grid(self, device) -> torch.Tensor:
        film = self.camera.film
        xs = np.arange(film.crop_min[0], film.crop_max[0] + 1, dtype=np.int32)
        ys = np.arange(film.crop_min[1], film.crop_max[1] + 1, dtype=np.int32)
        gx, gy = np.meshgrid(xs, ys, indexing="xy")
        return torch.from_numpy(np.stack([gx.reshape(-1), gy.reshape(-1)],
                                         axis=-1)).to(device)

    def light_distribution(self, scene):
        """(cdf [L], pmf [L]) of the lights' power on the scene's device."""
        cdf = common.light_power_cdf(scene)
        pmf = common.light_power_pmf(cdf)
        return (torch.from_numpy(cdf).to(scene.device),
                torch.from_numpy(pmf).to(scene.device))

    def check_scene(self, scene) -> None:
        if scene.device.type != self.device.type:
            raise ValueError(f"the scene is on {scene.device}, the "
                             f"integrator on {self.device}")
        if scene.lights.kind.shape[0] == 0:
            raise ValueError("SPPM needs at least one light (the photon "
                             "pass samples the lights' power distribution)")
        WP.supports(scene)

    def render(self, scene, n_iterations: int | None = None,
               progress: bool = False, state: SPPMState | None = None,
               start_iteration: int = 1, checkpoint_path: str | None = None,
               geometry=None, geometry_transform=None) -> SPPMState:
        """Run iterations ``start_iteration``..``n_iterations``. Pass
        (state, start_iteration) from an earlier run (or
        utils.checkpoint.load_pytree) to resume bit-exactly; with
        ``checkpoint_path`` the state is saved after every iteration (with
        a mesh, the checkpoint and the PNG by global rank 0 alone).
        ``geometry`` (optional): a Triangles table with the scene's
        topology and moved vertices, moved by ``geometry_transform`` on
        the device and re-clustered there (common.prepare_geometry); the
        camera pass and the photon walk both see it, on one device only.
        With ``fused_iterations`` and no mesh, stats, progress or
        checkpoint, the iterations run in fused blocks (``_fused_block``)
        that stop at each ``write_frequency`` multiple, where a snapshot
        is taken."""
        if geometry is not None and self.mesh is not None:
            raise ValueError("animated geometry renders on one device: the "
                             "sharded passes take the scene's geometry")
        scene = common.apply_geometry(scene, common.prepare_geometry(
            scene, geometry, geometry_transform))
        self.check_scene(scene)
        iters = n_iterations or self.n_iterations
        dev = scene.device
        if state is None:
            state = initial_state(self.n_pixels, self.initial_search_radius,
                                  dev)
        pixels = self._pixel_grid(dev)
        key = U.key(self.seed, dev)
        light_cdf, light_pmf = self.light_distribution(scene)
        pending = None
        writes = self.mesh is None or torch.distributed.get_rank() == 0
        fused = (self.fused_iterations and self.mesh is None
                 and self.stats is None and not progress
                 and not checkpoint_path)
        # Fused blocks (the JAX package's rule above), then the stepwise loop
        # over what they leave: every iteration when not fused.
        it = start_iteration
        while fused and it <= iters:
            stop = iters
            if self.write_frequency:
                stop = min(iters, ((it - 1) // self.write_frequency + 1)
                           * self.write_frequency)
            stop = min(stop, it + self.fused_block - 1)
            state = self._fused_block(scene, state, it, stop - it + 1, pixels,
                                      key, light_cdf, light_pmf)
            if self.write_frequency and (stop % self.write_frequency == 0
                                         or stop == iters):
                pending = self.to_image(state, stop)
            it = stop + 1
        for it in range(it, iters + 1):
            state = self.step(scene, state, it, pixels, key, light_cdf,
                              light_pmf)
            if progress:
                print(f"sppm iteration {it}/{iters}", flush=True)
            if self.write_frequency and writes and (
                    it % self.write_frequency == 0 or it == iters):
                pending = self.to_image(state, it)
            if checkpoint_path and writes:
                from ..utils.checkpoint import save_pytree

                save_pytree(checkpoint_path, state,
                            metadata={"iteration": it})
        if pending is not None and writes:
            film = self.camera.film
            film.save_png(film.set_image(pending))
        return state

    def vp_kinds(self, scene) -> tuple:
        """The lobe kinds the visible points' VP_LOBES slots can hold."""
        from ..wavefront import materials as WM

        kinds = WM.lobe_kinds(scene.materials, allow_multiple_lobes=True)
        empty = S.SlotKinds(frozenset({S.NONE}),
                            frozenset({S.FRESNEL_NOOP}))
        return (tuple(kinds) + (empty,) * VP_LOBES)[:VP_LOBES]

    def step(self, scene, state: SPPMState, iteration: int, pixels, key,
             light_cdf, light_pmf, geom=None) -> SPPMState:
        """One iteration (``_iteration``, the pair total read on the host);
        with a mesh, the passes split as the constructor says. ``geom``:
        a frame's (triangles, sweep tables) from
        common.prepare_geometry, rendered in place of the scene's (one
        device only, as in the JAX package)."""
        if geom is not None:
            if self.mesh is not None:
                raise ValueError("animated geometry renders on one device")
            scene = common.apply_geometry(scene, geom)
        return self._iteration(scene, state, iteration, pixels, key,
                               light_cdf, light_pmf)[0]

    def _iteration(self, scene, state: SPPMState, it, pixels, key,
                   light_cdf, light_pmf, pair_chunks: int | None = None):
        """One iteration's five phases: camera pass, grid, photon walk,
        pairs, update -> (state, pair total). ``it`` a host int: the total
        is read on the host and the pair chunks cover it (``step``). ``it``
        a device int64 scalar with ``pair_chunks``: the total stays on the
        device and that many pair chunks run (``_iterations_body``, under
        no_host_reads). A mesh splits the passes and ``stats`` counts the
        iteration; neither is set in a fused block."""
        it_key = U.fold_in(key, it)
        n_pix = pixels.shape[0]
        # The walks' self-hit counts, kept on the device for _count's read;
        # the sharded passes keep none.
        counting = self.stats is not None and self.mesh is None
        tally = {"camera": [], "photon": []} if counting else {}
        if self.mesh is not None and self.shard_camera:
            from ..parallel.render import tree_map
            from ..parallel.sppm import camera_pass_sharded

            part, valid = self._padded(pixels, n_pix)
            ld_add, vp = tree_map(lambda x: x[:n_pix], camera_pass_sharded(
                self, scene, self.mesh, self.shard_axis, part, valid, it_key))
        else:
            ld_add, vp = self._camera_pass_all(
                scene, pixels, it_key, tally=tally.get("camera"))
        grid = self._build_grid(vp, state.radius)
        np_iter = self.photons_per_iteration
        halton_base = ((it - 1) * np_iter) & M32
        if self.mesh is not None:
            from ..parallel.sppm import photon_walk_sharded

            size = self._mesh_size()
            npad = -(-np_iter // size) * size
            lane = torch.arange(npad, dtype=torch.int64, device=pixels.device)
            last = halton_base + npad - 1
            splat = photon_walk_sharded(
                self, scene, self.mesh, self.shard_axis,
                (halton_base + lane) & M32, lane < np_iter, light_cdf,
                light_pmf, grid["lo"], grid["res"], grid["inv_extent"],
                grid["sorted_cells"], idx_max=last if last <= M32 else None)
        else:
            splat = self._photon_walk_all(scene, halton_base, light_cdf,
                                          light_pmf, grid,
                                          tally=tally.get("photon"))
        counts = splat["count"]
        offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
        if pair_chunks is None:
            with span("host_read"):
                total = int(counts.sum())
        else:
            total = counts.sum()
        phi, m_cnt = self._pair_loop(state.phi, state.m, total, offsets,
                                     splat, vp, state.radius,
                                     grid["sorted_vp"], self.vp_kinds(scene),
                                     chunks=pair_chunks)
        if self.stats is not None:
            self._count(vp, grid, splat, total, n_pix, tally)
        return self._update_pixels(
            SPPMState(state.ld, state.tau, state.radius, state.n, phi,
                      m_cnt), ld_add), total

    def _iterations_body(self, scene, state: SPPMState, n_iters: int,
                         it_start, pixels, key, light_cdf, light_pmf,
                         pair_chunks: int):
        """Iterations it_start .. it_start + n_iters - 1 (``it_start`` a
        device int64 scalar) with no host read: ``_iteration`` on the
        sync-free routes (core/sync.py), the pair total on the device and
        ``pair_chunks`` pair chunks. -> (state, pair totals int64
        [n_iters], instance pairs int64 [G]: per instanced geometry, the
        most candidate pairs of a group its walks saw); the instance walks'
        pair buffers hold ``fused_pair_capacity`` (accel/instances.py).
        The state is ``step``'s bit for bit while every total is at most
        pair_chunks * pair_chunk and no geometry's pairs exceed its
        capacity."""
        totals = []
        route = StaticRoute(self.fused_pair_capacity)
        with no_host_reads(route):
            for k in range(n_iters):
                state, total = self._iteration(
                    scene, state, it_start + k, pixels, key, light_cdf,
                    light_pmf, pair_chunks)
                totals.append(total)
        zero = torch.zeros((), dtype=torch.int64, device=pixels.device)
        most = [torch.stack(route.counts.get(g, []) + [zero]).max()
                for g in scene.instanced]
        return state, torch.stack(totals), torch.stack(most + [zero])[:-1]

    def _fused_block(self, scene, state: SPPMState, it: int, n_iters: int,
                     pixels, key, light_cdf, light_pmf) -> SPPMState:
        """Iterations it .. it + n_iters - 1 as one block: on the card
        through ``fused_graphs`` (integrators/fused.py), on the CPU
        ``_iterations_body`` itself. One host read: the largest pair total
        of the block (``last_pair_totals`` keeps them all), with the
        instance walks' pair counts. A block whose pairs overflowed
        ``fused_pair_chunks`` chunks, or an instance walk's pair buffer,
        runs again stepwise from ``state`` (the same bits; counted in
        ``fused_reruns``), and later blocks take enough chunks. A
        geometry's buffer is sized from its counts after its first block
        and after an overflow: twice the count's next power of two."""
        k = self.fused_pair_chunks
        it0 = torch.full((), it, dtype=torch.int64, device=pixels.device)
        made = (pixels, key, light_cdf, light_pmf)

        def body(made, start, first):
            return self._iterations_body(scene, start, n_iters, first, *made,
                                         k)

        if fused.on_card(state.ld.device):
            if self.fused_graphs is None:
                self.fused_graphs = fused.Graphs("sppm.replay")
            capacities = tuple(self.fused_pair_capacity.get(g)
                               for g in scene.instanced)
            out, totals, over = self.fused_graphs.run(
                self, scene, (n_iters, k, capacities), body, lambda: made,
                (state, it0), n_iters=n_iters, pair_chunks=k)
        else:
            out, totals, over = body(made, state, it0)
        self.last_pair_totals = totals
        with span("host_read"):
            most, *pairs = torch.cat([totals.max()[None], over]).tolist()
        caps = self.fused_pair_capacity
        overflow = False
        for g, need in zip(scene.instanced, pairs):
            cap = caps.get(g)
            overflow |= cap is not None and need > cap
            if cap is None or need > cap:
                # Twice the count's power of two: a later iteration's
                # rays may need a few more pairs.
                caps[g] = 2 << (max(int(need), 1) - 1).bit_length()
        if most <= k * self.pair_chunk and not overflow:
            return out
        for i in range(it, it + n_iters):
            state = self.step(scene, state, i, pixels, key, light_cdf,
                              light_pmf)
        self.fused_reruns += 1
        self.fused_pair_chunks = max(k, -(-most // self.pair_chunk))
        return state

    def graph_settings(self) -> tuple:
        """The settings a block's graph is kept under (fused.Graphs)."""
        return (self.seed, self.max_depth, self.n_iterations,
                self.photons_per_iteration, self.pixel_chunk, self.pair_chunk)

    def _mesh_size(self) -> int:
        from ..parallel.render import axis_group

        return axis_group(self.mesh, self.shard_axis)[2]

    def _padded(self, pixels, n_pix: int):
        """(pixels, valid) padded with zeros to a multiple of the mesh
        dimension's size."""
        pad = (-n_pix) % self._mesh_size()
        part = torch.cat([pixels, torch.zeros((pad, 2), dtype=pixels.dtype,
                                              device=pixels.device)])
        valid = torch.arange(n_pix + pad, device=pixels.device) < n_pix
        return part, valid

    def _count(self, vp, grid, splat, total, n_pix, tally=None) -> None:
        """Add an iteration's counters to ``stats`` in one host read; with
        ``tally`` (step's self-hit counts of each walk) also
        ``sppm_camera_self_hits`` and ``sppm_photon_self_hits``: bounces
        whose next hit re-met the primitive they left at their origin."""
        sc = grid["sorted_cells"]
        zero = sc.new_zeros((), dtype=torch.int64)
        walks = [sum(tally[k], zero) for k in ("camera", "photon")
                 if tally]
        with span("host_read"):
            occupied, visible, records, *selfs = torch.stack([
                ((sc[1:] != sc[:-1]) & (sc[1:] < self.n_pixels)).sum()
                + (sc[0] < self.n_pixels),
                (vp.valid & ~(vp.beta == 0.0).all(-1)).sum(),
                (splat["count"] > 0).sum(), *walks]).tolist()
        add = {
            "photons_traced": self.photons_per_iteration,
            "photon_vp_pairs": total,
            "camera_rays": n_pix,
            "rays_dispatched": (n_pix * self.max_depth * 2
                                + self.photons_per_iteration * self.max_depth),
            "grid_cells_occupied": occupied,
            "visible_points": visible,
            "splat_records": records,
        }
        if selfs:
            add["sppm_camera_self_hits"], add["sppm_photon_self_hits"] = selfs
        for k, v in add.items():
            self.stats.add(k, v)

    def save(self, state: SPPMState, iteration: int, path: str | None = None):
        film = self.camera.film
        return film.save_png(film.set_image(self.to_image(state, iteration)),
                             path)

    def __call__(self, scene):
        state = self.render(scene)
        self.save(state, self.n_iterations)
        return state

    def render_frames(self, scene, frame_lights,
                      n_iterations: int | None = None, geometry=None,
                      frame_transforms=None) -> SPPMState:
        """Render K frames of an animation, each ``n_iterations``
        iterations from a fresh state; returns the states stacked, [K, ...]
        in every field (frame k: ``SPPMState(*[x[k] for x in ...])``).

        ``frame_lights``: K lists of light entries (as from
        models.caustic_moving.frame_lights), packed and preprocessed here
        against the base scene's triangles and bounds; every frame must
        have as many lights. ``geometry`` with ``frame_transforms``: a
        base Triangles table and K Transforms, frame k rendering
        ``geometry`` moved by transform k. Frame k is a ``render`` of that
        frame, bit for bit, in fused blocks with ``fused_iterations`` (the
        JAX package maps its blocks over the frames with ``lax.map``; the
        port runs the frames one after another). One device only: refused
        with a mesh, as in the JAX package."""
        if self.mesh is not None:
            raise ValueError("render_frames renders on one device")
        center, radius = scene.bounding_sphere()
        tables = [light_mod.preprocess(
            light_mod.pack_lights(entries, scene.triangles), center, radius)
            for entries in frame_lights]
        counts = {light_mod.num_lights(t) for t in tables}
        if len(counts) != 1:
            raise ValueError(f"frames must have equal light counts: {counts}")
        if geometry is not None and (frame_transforms is None or len(
                frame_transforms) != len(tables)):
            raise ValueError("geometry needs one frame transform a frame")
        states = []
        for k, lights in enumerate(tables):
            states.append(self.render(
                scene.with_lights(lights), n_iterations=n_iterations,
                geometry=geometry,
                geometry_transform=(None if geometry is None
                                    else frame_transforms[k])))
        return SPPMState(**{f.name: torch.stack([getattr(s, f.name)
                                                 for s in states])
                            for f in fields(SPPMState)})

    def fused_cost_analysis(self, scene, n_iters: int = 1) -> dict:
        """The work of a fused block of ``n_iters`` iterations on
        ``scene``, counted from the shapes of the static route it replays
        (``_iterations_body``): its lanes, depths, sweep chunks, pair
        chunks (``fused_pair_chunks``) and pixels. Returns JAX's keys,
        ``"flops"`` and ``"bytes accessed"``, and per phase under
        ``"phases"`` (camera, grid, photons, pairs, update) the same two.

        These figures are the port's model of the cost, not XLA's: each
        term is a lower bound of what the replay does (FP32 operations and
        bytes that must cross HBM), so flops or bytes over a replay's time
        can read no more than the card's peak. Like XLA's analysis of a
        Pallas call, they charge the intersection kernels only what their
        static shapes prove: each call reads its rays (o, d, t_max) and
        writes (t, id), 36 B a lane, and the sweep's prologue writes its
        [blocks, supers] order and suffix tables (8 B an entry) and tests
        every live lane of a block against every super box, 24 FP32
        operations a test (per axis two differences, two products, a min
        and a max; the running near and far over three axes; the widened
        far plane; the clamp at 0). Only the camera's first depth has
        lanes live by shape alone (the camera weights every ray 1); the
        other depths' box tests, and the triangle tests of every call,
        depend on the data and are not counted. The other terms: 6 FP32
        operations a lane a depth for the hit point o + t d (camera and
        photons); 18 a visible point for its two grid corners; 11 a pair
        lane for the distance test and the weighted flux; 17 a pixel for
        the update. Bytes: the camera's radiance (12 B a pixel), the
        grid's 8 cell entries a point (cell and point ids, written and
        sorted), the photons' splat records (44 B a photon a level), 256 B
        a pair lane for its gathered visible-point and record rows, and
        the state read and written (96 B a pixel)."""
        from ..ops.sweep import SweepAccelerator

        p = self.n_pixels
        depth = self.max_depth
        n_ph = self.photons_per_iteration
        lanes = self.fused_pair_chunks * self.pair_chunk
        acc = scene.accel
        sweep = isinstance(acc, SweepAccelerator) and scene.n_triangles
        n_supers = acc.tables.n_supers if sweep else 0

        def call_bytes(n):
            """One intersection call of n lanes."""
            out = 36 * n
            if sweep:
                c, b = acc.ray_chunk, acc.block_rays
                for start in range(0, n, c):
                    out += -(-min(c, n - start) // b) * n_supers * 8
            return out

        cam_calls = sum(call_bytes(min(self.pixel_chunk, p - s0))
                        for s0 in range(0, p, self.pixel_chunk))
        ph_chunk = min(self.pixel_chunk, n_ph)
        ph_calls = sum(call_bytes(min(ph_chunk, n_ph - s0))
                       for s0 in range(0, n_ph, ph_chunk))
        phases = {
            "camera": dict(flops=6 * p * depth + 24 * p * n_supers,
                           bytes=2 * depth * cam_calls + 12 * p),
            "grid": dict(flops=18 * p, bytes=8 * p * 16),
            "photons": dict(flops=6 * n_ph * depth,
                            bytes=depth * ph_calls
                            + 44 * n_ph * max(depth - 1, 0)),
            "pairs": dict(flops=11 * lanes, bytes=256 * lanes),
            "update": dict(flops=17 * p, bytes=96 * p),
        }
        phases = {k: {m: float(v * n_iters) for m, v in d.items()}
                  for k, d in phases.items()}
        return {"flops": sum(d["flops"] for d in phases.values()),
                "bytes accessed": sum(d["bytes"] for d in phases.values()),
                "phases": phases}
