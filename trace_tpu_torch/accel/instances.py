"""Two-level instanced geometry: many transformed copies of one base mesh
or sphere array sharing one base table (port of
trace_tpu/accel/instances.py).

The base is packed once in object space; each instance adds one row of a
transform table (o2w, w2o, its world box, a material override and whether
it swaps handedness). The walk, :func:`sweep_instances`, is the JAX
package's demand-ordered instance sweep:

1. one [N, I] slab pass gives every ray's entry distance to every
   instance's world box (accel/clusters.py::entry_boxes, the rule of the
   JAX package's ``_entry_boxes``);
2. instances are visited in demand order (``argsort(-demand)``, stable,
   the demand counted over the whole call); a lane retires once the
   suffix-min of the entries it has not visited is at least
   ``min(best_t, t_max)`` (under any-hit, also once it has a hit: the
   JAX walk's test, ``best_t <= t_max``, also retires a lane with no hit
   and t_max = +inf after its first instance, so it can miss occluders;
   the port's retires only on a hit);
3. a visit transforms the lanes' rays into the instance's object space
   with the direction left UNNORMALIZED, so object-space t is world t, and
   runs the base's own closest hit: the sphere quadratic over the base
   array, the brute-force triangle grid (64 base triangles or fewer), or
   the sweep over the base's own tables (ops/sweep.py, csrc/sweep.cu and
   csrc/entry.cu on the card). A lane keeps the best (t, element,
   instance), taking a visit only where its t is strictly less.

The port differs in how it spends the host, not in what it returns. It
visits instances ``group`` at a time: of the [lanes, group] grid it keeps
the (lane, instance) pairs whose ray enters the instance's box within the
lane's limit, runs the base's test on those pairs (for a mesh base, ONE
sweep call, which sorts, chunks and launches them), and within the group
a lane takes the least t, among equal t the earliest instance in demand
order, then the strict ``t < best_t``; retirement is tested between
groups, on the lanes still walking only (two host reads a group: the
lanes, the pairs). This keeps the JAX package's result, by the argument
that makes the walk exact at all: a hit lies inside its instance's box,
so its t is at least the box entry. A pair left out has an entry past the
lane's limit, and can only give a t the limit refuses. A lane that the
JAX walk retires inside a group can only meet hits with t >= its suffix
entry >= min(best_t, t_max) after that point, and the strict ``t <
best_t`` refuses those. Rays go through in ``RAY_CHUNK`` lanes at a
time, so the [chunk, I] entries stay at 256 MiB for 1024 instances; the
demand order is still the whole call's, counted over the lanes that can
hit (t_max >= 0): the JAX walk also counts dead lanes whose origin lies
inside a box, which can only change which of two instances at exactly
the same t a lane keeps.

A retired lane walks no further; the integrators hand a lane that is
dead to the walk with limit -1, never -inf (the sweep counts either dead
since ops/sweep.py's pad_rays sends -inf to -1, and such a lane never
walks).

Under core/sync.py's ``no_host_reads`` (SPPM's fused blocks) the walk
takes a static route with no host read and the same result: every lane
(a dead one's entries set to +inf) walks every group, a retired lane
with no candidate pair; a group's candidate pairs go, in the order
``nonzero`` gives them, into a buffer filled by a prefix count and a
``searchsorted``, the slots past the count tested with limit -1. The
buffer holds the run's StaticRoute capacity for the geometry, at most
the group's lanes x instances; a geometry with no capacity there gets
that bound, which no count exceeds. Each group's candidate count goes to
the StaticRoute's ``counts``: a count above the buffer left pairs out,
and the caller runs that work again stepwise with a larger capacity
(integrators/sppm.py's fused blocks).
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import numpy as np
import torch

from ..core import vec as V
from ..core.sync import static_route, sync_free
from ..core.vec import V3
from ..shapes import sphere as sph_mod
from ..shapes import triangle as tri_mod
from ..wavefront import geom as G
from .clusters import entry_boxes

F32 = torch.float32
INF = float("inf")
RAY_CHUNK = 65536
# Instances visited per group (module docstring). On an H100 (700 W),
# the camera walk of sphere_field 512^2 (264,196 rays, 1024 instances)
# took 614 ms at 16, 364 at 32, 170 at 128 and 92 at 1024; 100 instanced
# stand-ins' took 22-25 ms at 128 and 1024 alike (chip_smoke 9b, 9c).
GROUP = 1024


class InstanceTable(NamedTuple):
    """Host numpy, equal to the JAX package's InstanceTable as arrays."""
    o2w: np.ndarray          # [I, 4, 4] object -> world
    w2o: np.ndarray          # [I, 4, 4] world -> object
    lo: np.ndarray           # [I, 3] world box of the transformed base
    hi: np.ndarray           # [I, 3]
    material_id: np.ndarray  # [I] int32; -1 keeps the base's materials
    swaps: np.ndarray        # [I] bool: the transform swaps handedness


def transform_aabb(o2w: np.ndarray, lo, hi):
    """World box of an object-space box under an affine map: the 8-corner
    bound in float32."""
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for z in (lo[2], hi[2])], np.float32)
    w = corners @ o2w[:3, :3].T + o2w[:3, 3]
    return w.min(axis=0), w.max(axis=0)


def instance_table(transforms, bounds: np.ndarray,
                   material_ids=None) -> InstanceTable:
    """The table for ``transforms`` (core.transform.Transform) over a base
    whose element boxes are ``bounds`` [E, 2, 3]."""
    b_lo = bounds[:, 0].min(axis=0)
    b_hi = bounds[:, 1].max(axis=0)
    n_i = len(transforms)
    o2w = np.stack([np.asarray(t.m, np.float32) for t in transforms])
    w2o = np.stack([np.asarray(t.inv_m, np.float32) for t in transforms])
    lo = np.zeros((n_i, 3), np.float32)
    hi = np.zeros((n_i, 3), np.float32)
    for i in range(n_i):
        lo[i], hi[i] = transform_aabb(o2w[i], b_lo, b_hi)
    swaps = np.array([np.linalg.det(mm[:3, :3]) < 0 for mm in o2w], bool)
    mat = (np.full(n_i, -1, np.int32) if material_ids is None
           else np.asarray(material_ids, np.int32))
    return InstanceTable(o2w, w2o, lo, hi, mat, swaps)


def _rows34(m: torch.Tensor):
    """[..., 4, 4] -> (R as a nested 3x3 of [...] tensors, t as V3)."""
    return ([[m[..., i, j] for j in range(3)] for i in range(3)],
            V3(m[..., 0, 3], m[..., 1, 3], m[..., 2, 3]))


def _apply_point(r, tr: V3, p: V3) -> V3:
    return V.mat3_apply(r, p) + tr


def compose44(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, 4, 4] a @ b as explicit products summed in k order (no matmul:
    a library product fixes no sum order)."""
    out = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for j in range(4):
            s = a[:, i, 0] * b[:, 0, j]
            for k in range(1, 4):
                s = s + a[:, i, k] * b[:, k, j]
            out[i][j] = s
    return torch.stack([torch.stack(r, -1) for r in out], -2)


class _Instanced:
    """What both base kinds share: the table, its device copy and the
    walk. ``to(device)`` gives a copy whose tables lie on ``device``."""

    group = GROUP

    def __init__(self, table: InstanceTable, n_base: int):
        self.table = table
        self.n_base = int(n_base)
        self.n_instances = int(table.o2w.shape[0])
        self.device = None
        self.groups_visited = 0   # instance groups walked, summed over calls

    def world_bounds_np(self) -> np.ndarray:
        """[1, 2, 3]: the union of the instances' world boxes."""
        return np.stack([self.table.lo.min(axis=0),
                         self.table.hi.max(axis=0)])[None]

    def to(self, device) -> "_Instanced":
        out = copy.copy(self)
        out.device = dev = torch.device(device)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        out.o2w, out.w2o = t(self.table.o2w), t(self.table.w2o)
        out.lo, out.hi = t(self.table.lo), t(self.table.hi)
        out.material_id = t(self.table.material_id)
        out.swaps = t(self.table.swaps)
        out._load_base(dev)
        return out

    def _load_base(self, dev) -> None:
        raise NotImplementedError

    def traverse(self, o: V3, d: V3, t_max, any_hit: bool = False):
        """(hit [N], t [N], element [N] i32, instance [N] i32)."""
        return sweep_instances(self, o, d, t_max, any_hit)

    def _pairs(self, o: V3, d: V3, inst: torch.Tensor):
        """Rays [P] in the object space of their instances ``inst`` [P]."""
        r, tr = _rows34(self.w2o[inst.long()])
        return _apply_point(r, tr, o), V.mat3_apply(r, d)


class InstancedGeometry(_Instanced):
    """One object-space base mesh, its instance table and, above 64 base
    triangles, the sweep over the base's own tables.

    ``use_accel``: the sweep (True), the brute-force grid (False), or the
    sweep above 64 base triangles (None, the JAX package's rule);
    ``sweep_tables`` gives the tables, else they are built from the base.
    ``stage_clusters`` and ``leaf_tris`` are the JAX package's settings of
    its cluster walk over the base: taken and ignored, the port's base
    sweep keeps leaf 64 x group 8 (ROADMAP.md, C, "Leaf sizes")."""

    def __init__(self, base: tri_mod.Triangles, table: InstanceTable,
                 stage_clusters: int = 64, leaf_tris: int = 32,
                 use_accel: bool | None = None, sweep_tables=None):
        super().__init__(table, tri_mod.num_triangles(base))
        self.base = base
        self.stage_clusters = int(stage_clusters)
        self.leaf_tris = int(leaf_tris)
        if use_accel is None:
            use_accel = self.n_base > 64
        if not use_accel:
            sweep_tables = None
        elif sweep_tables is None:
            from ..scene import sweep_tables as tables_of

            sweep_tables = tables_of(base, use_bvh=True)
        self.sweep_tables = sweep_tables
        self.accel = None

    def _load_base(self, dev) -> None:
        from ..scene import make_sweep

        self.base_rows = G.triangle_rows(self.base, dev)
        self.base_cols = G.triangle_cols(self.base, dev)
        self.has_normals = torch.from_numpy(self.base.has_normals).to(dev)
        self.accel = (None if self.sweep_tables is None
                      else make_sweep(self.sweep_tables, dev, False))

    def pair_hits(self, o: V3, d: V3, lim, inst, any_hit: bool):
        """The base's closest (or any) hit for pairs [P] of a ray and an
        instance ``inst``: (hit, t, triangle) [P]. Through the sweep as
        one call, or the brute-force grid."""
        o_l, d_l = self._pairs(o, d, inst)
        if self.accel is not None:
            return self.accel.intersect(o_l.arr(), d_l.arr(), lim, any_hit)
        return G.triangles_closest(self.base_cols, o_l, d_l, lim)

    def make_hit_record(self, o: V3, d: V3, time, elem_idx, inst_idx,
                        valid, prim_offset: int = 0) -> G.HitP:
        """The winner's record: built in object space from the per-lane
        transformed rays, then mapped to world -- points and tangents by
        o2w, normals by w2o transposed, flipped where the instance swaps
        handedness and the base triangle has vertex normals. ``dpdu`` and
        ``dpdv`` stay in object space, as in the JAX package."""
        inst = inst_idx.long()
        r_w2o, t_w2o = _rows34(self.w2o[inst])
        r_o2w, t_o2w = _rows34(self.o2w[inst])
        o_l = _apply_point(r_w2o, t_w2o, o)
        d_l = V.mat3_apply(r_w2o, d)
        rec = G.make_hit_triangles(self.base_rows, o_l, d_l, time, elem_idx,
                                   valid)
        to_w_v = lambda v: V.mat3_apply(r_o2w, v)
        to_w_n = lambda v: V.mat3_apply_t(r_w2o, v)
        flip = self.swaps[inst] & self.has_normals[elem_idx.long()]
        sign = torch.where(flip, -1.0, 1.0)
        nrm = lambda v: to_w_n(v).normalize() * sign
        inst_mat = self.material_id[inst]
        return rec._replace(
            p=_apply_point(r_o2w, t_o2w, rec.p), n=nrm(rec.n),
            ns=nrm(rec.ns), wo=(-d).normalize(), s_dpdu=to_w_v(rec.s_dpdu),
            s_dpdv=to_w_v(rec.s_dpdv), s_dndu=to_w_n(rec.s_dndu),
            s_dndv=to_w_n(rec.s_dndv),
            prim_id=(prim_offset + inst_idx * self.n_base + elem_idx).to(
                torch.int32),
            material_id=torch.where(inst_mat >= 0, inst_mat,
                                    rec.material_id).to(torch.int32))


class InstancedSpheres(_Instanced):
    """Many transformed copies of one sphere array. The inner test is the
    sphere quadratic over the base array, applied to the instance's w2o
    and then each sphere's own w2o (two transforms, in that order); the
    winner's record composes the two per lane and runs the sphere detail
    phase on the composed frame."""

    def __init__(self, base: sph_mod.Spheres, table: InstanceTable):
        super().__init__(table, sph_mod.num_spheres(base))
        self.base = base

    def _load_base(self, dev) -> None:
        self.base_cols = G.sphere_cols(self.base, dev)
        self.base_rows = torch.from_numpy(G.sphere_rows(self.base)).to(dev)
        self.base_o2w = torch.from_numpy(self.base.o2w).to(dev)
        self.base_w2o = torch.from_numpy(self.base.w2o).to(dev)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
        self.base_clip = {k: t(getattr(self.base, k)) for k in
                          ("radius", "z_min", "z_max", "phi_max")}

    def pair_hits(self, o: V3, d: V3, lim, inst, any_hit: bool):
        """The sphere quadratic over the base array for pairs [P] of a ray
        and an instance: (hit, t, sphere) [P]."""
        o_l, d_l = self._pairs(o, d, inst)
        return G.spheres_closest(self.base_cols, o_l, d_l, lim)

    def winner_t(self, o: V3, d: V3, elem_idx, inst_idx):
        """The winning (instance, sphere) pair intersected again lane by
        lane, through the walk's two transforms."""
        r_i, t_i = _rows34(self.w2o[inst_idx.long()])
        e = elem_idx.long()
        r_s, t_s = _rows34(self.base_w2o[e])
        o_l = _apply_point(r_i, t_i, o)
        d_l = V.mat3_apply(r_i, d)
        o_obj = _apply_point(r_s, t_s, o_l)
        d_obj = V.mat3_apply(r_s, d_l)
        cols = {k: v[e] for k, v in self.base_clip.items()}
        inf = torch.full_like(o.x, INF)
        return G._sphere_candidate(cols, o_obj, d_obj, inf)[1]

    def make_hit_record(self, o: V3, d: V3, time, elem_idx, inst_idx, valid,
                        prim_offset: int = 0) -> G.HitP:
        inst, e = inst_idx.long(), elem_idx.long()
        o2w = compose44(self.o2w[inst], self.base_o2w[e])
        w2o = compose44(self.base_w2o[e], self.w2o[inst])
        rows = self.base_rows[e].clone()
        rows[:, 0:12] = w2o[:, :3, :].reshape(-1, 12)
        rows[:, 12:24] = o2w[:, :3, :].reshape(-1, 12)
        t = self.winner_t(o, d, elem_idx, inst_idx)
        lanes = torch.arange(t.shape[0], device=t.device)
        rec = G.make_hit_spheres(rows, o, d, time, t, lanes, valid)
        inst_mat = self.material_id[inst]
        return rec._replace(
            prim_id=(prim_offset + inst_idx * self.n_base + elem_idx).to(
                torch.int32),
            material_id=torch.where(inst_mat >= 0, inst_mat,
                                    rec.material_id).to(torch.int32))


def build_instances(indices, vertices, transforms, material_id: int = 0,
                    normals=None, uv=None, material_ids=None,
                    stage_clusters: int = 64, leaf_tris: int = 32
                    ) -> InstancedGeometry:
    """The base mesh packed once in object space, its instance table, and
    above 64 triangles its sweep tables (leaf 64 x group 8; the JAX
    package's ``stage_clusters`` and ``leaf_tris`` are taken and ignored,
    InstancedGeometry); host data, ``to(device)`` moves it."""
    from ..core import transform as T
    from ..scene import sweep_tables

    base = tri_mod.pack_triangle_mesh(T.identity(), indices, vertices,
                                      normals=normals, uv=uv,
                                      material_id=material_id)
    table = instance_table(transforms, tri_mod.world_bounds_np(base),
                           material_ids)
    return InstancedGeometry(base, table, stage_clusters, leaf_tris,
                             sweep_tables=sweep_tables(base))


def build_sphere_instances(entries, transforms, material_ids=None
                           ) -> InstancedSpheres:
    """The base sphere array (SceneBuilder.sphere's dicts) packed once,
    and its instance table; host data, ``to(device)`` moves it."""
    base = sph_mod.pack_spheres(entries)
    return InstancedSpheres(base, instance_table(
        transforms, sph_mod.world_bounds_np(base), material_ids))


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------


def sweep_instances(geom, o: V3, d: V3, t_max, any_hit: bool = False,
                    group: int | None = None, ray_chunk: int = RAY_CHUNK):
    """The demand-ordered instance walk (module docstring): (hit [N], t
    [N], element [N] i32, instance [N] i32), equal to the JAX package's
    ``_sweep_instances`` on the same rays and limits. ``group`` instances
    are visited at a time (default: the geometry's). Only lanes with
    t_max >= 0 can hit; the walk and its demand count take those alone
    (one host read), and a call with none returns at once; under
    no_host_reads the static route instead (module docstring)."""
    n = t_max.shape[0]
    dev = t_max.device
    if sync_free():
        return _sweep_live(geom, o, d, t_max, any_hit,
                           int(group or geom.group), ray_chunk,
                           _walk_chunk_static)
    hit = torch.zeros((n,), dtype=torch.bool, device=dev)
    t = torch.full((n,), INF, dtype=F32, device=dev)
    elem = torch.zeros((n,), dtype=torch.int32, device=dev)
    inst = torch.zeros((n,), dtype=torch.int32, device=dev)
    live = (t_max >= 0).nonzero().squeeze(1)
    if live.numel() == 0:
        return hit, t, elem, inst
    pick = lambda v: V3(v.x[live], v.y[live], v.z[live])
    out = _sweep_live(geom, pick(o), pick(d), t_max[live], any_hit,
                      int(group or geom.group), ray_chunk)
    hit[live], t[live], elem[live], inst[live] = out
    return hit, t, elem, inst


def _sweep_live(geom, o: V3, d: V3, t_max, any_hit: bool, g: int,
                ray_chunk: int, walk=None):
    """The walk of lanes in chunks of ``ray_chunk``, each chunk by
    ``walk`` (_walk_chunk by default). A lane with t_max < 0 enters no
    box: its entries are +inf (the static route hands such lanes in)."""
    n = t_max.shape[0]
    dev = t_max.device
    oa, da = o.arr(), d.arr()
    starts = range(0, n, ray_chunk)

    def entries(sl):
        e = entry_boxes(geom.lo, geom.hi, oa[sl], da[sl], t_max[sl])
        return torch.where(t_max[sl, None] >= 0, e, INF)

    whole = None
    if n <= ray_chunk:
        whole = entries(slice(0, n))
        demand = torch.isfinite(whole).sum(0)
    else:
        demand = sum(torch.isfinite(entries(slice(s, s + ray_chunk))).sum(0)
                     for s in starts)
    perm = torch.argsort(-demand, stable=True).to(torch.int32)
    best_t = torch.full((n,), INF, dtype=F32, device=dev)
    best_elem = torch.zeros((n,), dtype=torch.int32, device=dev)
    best_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for s in starts:
        sl = slice(s, s + ray_chunk)
        entry = whole if whole is not None else entries(sl)
        (walk or _walk_chunk)(geom, V3(o.x[sl], o.y[sl], o.z[sl]),
                              V3(d.x[sl], d.y[sl], d.z[sl]), t_max[sl],
                              entry[:, perm.long()], perm, any_hit, g,
                              best_t[sl], best_elem[sl], best_inst[sl])
    hit = (best_inst >= 0) & (best_t <= t_max)
    return (hit, torch.where(hit, best_t, INF), best_elem,
            best_inst.clamp_min(0))


def _walk_chunk(geom, o: V3, d: V3, t_max, entry_p, perm, any_hit: bool,
                g: int, best_t, best_elem, best_inst) -> None:
    """Walk one chunk in place into the (best_t, best_elem, best_inst)
    views; ``entry_p`` [M, I] is the chunk's entries in demand order."""
    n_i = entry_p.shape[1]
    suffix = torch.cat([entry_p.flip(1).cummin(1).values.flip(1),
                        torch.full_like(entry_p[:, :1], INF)], 1)
    done = torch.zeros(t_max.shape, dtype=torch.bool, device=t_max.device)
    for r0 in range(0, n_i, g):
        lanes = (~done).nonzero().squeeze(1)         # a host read
        if lanes.numel() == 0:
            break
        geom.groups_visited += 1
        r1 = min(r0 + g, n_i)
        inst = perm[r0:r1]
        tm = t_max[lanes]
        bt = best_t[lanes]
        lim = torch.minimum(bt, tm)
        ent = entry_p[lanes, r0:r1]
        pa, pk = (torch.isfinite(ent) & (ent <= lim[:, None])).nonzero(
            as_tuple=True)                           # a host read
        t_g = torch.full(ent.shape, INF, dtype=F32, device=ent.device)
        e_g = torch.zeros(ent.shape, dtype=torch.int32, device=ent.device)
        if pa.numel():
            ln = lanes[pa]
            h, t, e = geom.pair_hits(
                V3(o.x[ln], o.y[ln], o.z[ln]), V3(d.x[ln], d.y[ln], d.z[ln]),
                lim[pa], inst[pk], any_hit)
            t_g[pa, pk] = torch.where(h, t, INF)
            e_g[pa, pk] = e.to(torch.int32)
        kt, kk = t_g.min(dim=1)                      # first least t
        better = kt < bt
        bt = torch.where(better, kt, bt)
        best_t[lanes] = bt
        best_elem[lanes] = torch.where(
            better, e_g.gather(1, kk[:, None]).squeeze(1), best_elem[lanes])
        best_inst[lanes] = torch.where(better, inst[kk], best_inst[lanes])
        retire = suffix[lanes, r1] >= torch.minimum(bt, tm)
        if any_hit:   # a hit, not merely inf <= inf (ROADMAP C)
            retire = retire | ((bt <= tm) & (bt < INF))
        done[lanes] = retire


def _walk_chunk_static(geom, o: V3, d: V3, t_max, entry_p, perm,
                       any_hit: bool, g: int, best_t, best_elem,
                       best_inst) -> None:
    """_walk_chunk with no host read: every lane, every group, the
    candidate pairs in a buffer of the StaticRoute's capacity for
    ``geom`` (module docstring)."""
    m, n_i = entry_p.shape
    dev = t_max.device
    route = static_route()
    counts = route.counts.setdefault(geom, [])
    suffix = torch.cat([entry_p.flip(1).cummin(1).values.flip(1),
                        torch.full_like(entry_p[:, :1], INF)], 1)
    done = torch.zeros(t_max.shape, dtype=torch.bool, device=dev)
    for r0 in range(0, n_i, g):
        geom.groups_visited += 1
        r1 = min(r0 + g, n_i)
        k = r1 - r0
        inst = perm[r0:r1]
        bt = best_t
        lim = torch.minimum(bt, t_max)
        ent = entry_p[:, r0:r1]
        cand = (torch.isfinite(ent) & (ent <= lim[:, None])
                & ~done[:, None]).reshape(-1)
        count = torch.cumsum(cand, 0)
        counts.append(count[-1])
        cap = min(route.capacity.get(geom) or m * k, m * k)
        slots = torch.arange(cap, device=dev)
        # Slot j holds the (j + 1)-th candidate in row-major order (what
        # nonzero gives); a slot past the count holds m * k, no pair.
        flat = torch.searchsorted(count, slots + 1)
        real = flat < m * k
        pa = torch.where(real, flat // k, 0)
        pk = torch.where(real, flat % k, 0)
        h, t, e = geom.pair_hits(
            V3(o.x[pa], o.y[pa], o.z[pa]), V3(d.x[pa], d.y[pa], d.z[pa]),
            torch.where(real, lim[pa], -1.0), inst[pk], any_hit)
        # Each slot writes its own cell; an empty slot one past the grid.
        cell = torch.where(real, flat, m * k + slots)
        t_g = torch.full((m * k + cap,), INF, dtype=F32, device=dev)
        e_g = torch.zeros((m * k + cap,), dtype=torch.int32, device=dev)
        t_g[cell] = torch.where(h, t, INF)
        e_g[cell] = e.to(torch.int32)
        kt, kk = t_g[:m * k].reshape(m, k).min(dim=1)   # first least t
        better = kt < bt
        bt = torch.where(better, kt, bt)
        best_t.copy_(bt)
        best_elem.copy_(torch.where(
            better, e_g[:m * k].reshape(m, k).gather(1, kk[:, None])
            .squeeze(1), best_elem))
        best_inst.copy_(torch.where(better, inst[kk], best_inst))
        retire = suffix[:, r1] >= torch.minimum(bt, t_max)
        if any_hit:   # a hit, not merely inf <= inf (ROADMAP C)
            retire = retire | ((bt <= t_max) & (bt < INF))
        done = done | retire
