"""The port's SPPM against the benchmark's float64 reference, on the CPU.

- The two ``mesh1m_sppm`` cells through the harness's whole run at a size
  a test holds (2,000 triangles, 32x32, 32,768 photons, radius 0.25): a
  sound run is correct under the cell's own limits file, and the control
  (the sweep's bf16 panel) and three faults planted under the timed path
  are not.
- A continuation spawned at |p| ~ 1,000: the JAX package's rule (1e-6
  along wi) re-hits the triangle it left, the port's (core/ray.py::spawn)
  does not.
- The sphere seen from 1,170 units, the cells' camera distance, and from
  inside it and its surface: the rays that hit are the float64
  reference's, and t agrees to 1e-5.
"""
import numpy as np
import pytest
import torch

from perfbench import control, harness
from perfbench.reference import tiles as TL
from perfbench.tests import test_perfbench_correct as PC
from torch_jax_arrays import spawn_along
from trace_tpu_torch.core import ray as R
from trace_tpu_torch.core.vec import V3
from trace_tpu_torch.wavefront import whitted as WW

CELLS = ["mesh1m_sppm_1024_fused", "mesh1m_sppm_1024_stepwise"]
SIZE = dict(tris=2000, resolution=32, photons=32768, radius=0.25)
SEED = 2 ** 31 + 11
F64 = torch.float64


def small_spec(cell):
    """The cell at SIZE, its pair chunks cut to 2^16 pairs (a fused block
    runs every chunk whole, and an iteration here has a few hundred
    pairs), and one warm iteration: on one CPU thread, as in the test
    suite, an iteration takes ~4 s here, most of it the plain sweep."""
    spec = PC.shrink(harness.CellSpec(PC.ROOT, cell), SIZE)
    spec.config["integrator_args"]["pair_chunk"] = 1 << 16
    spec.traffic["warm_steps"] = 1
    return spec


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = PC.run(small_spec(cell), seed=SEED)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    spec = small_spec(cell)
    r = PC.run(spec, PC.cell_of(spec, SEED, control=control.panel_bf16),
               seed=SEED)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [PC.unchanged, PC.half_left_out,
                                   PC.altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    spec = small_spec(cell)
    r = PC.run(spec, PC.Faulty(spec, fault), seed=SEED)
    assert not r["correct"], r["checks"]


def _far_mesh(n=16):
    """A bumpy (n-1)^2 x 2 triangle patch of 1-unit quads centred at
    (800, 100, -600), |p| ~ 1,005, on the sweep (over 64 triangles), with
    a point light above it."""
    import trace_tpu_torch as tt

    xs = np.arange(n, dtype=np.float32) - n / 2
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = 0.3 * np.sin(1.3 * gx) * np.cos(0.7 * gz)
    verts = np.stack([gx + 800.0, gy + 100.0, gz - 600.0], -1).reshape(
        -1, 3).astype(np.float32)
    q = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).ravel()
    tris = np.concatenate([np.stack([q, q + n, q + 1], -1),
                           np.stack([q + 1, q + n, q + n + 1], -1)])
    b = tt.SceneBuilder()
    m = b.material(tt.MatteMaterial(Kd=(0.5, 0.5, 0.5), sigma=0.0))
    b.triangle_mesh(tt.transforms.identity(), tris.astype(np.uint32), verts,
                    m)
    b.light(tt.point_light(tt.transforms.translate((800.0, 120.0, -600.0)),
                           (1.0, 1.0, 1.0)))
    return b.build(device="cpu")


def _v3(a):
    a = torch.as_tensor(a, dtype=torch.float32)
    return V3(a[:, 0].contiguous(), a[:, 1].contiguous(),
              a[:, 2].contiguous())


def test_spawn_leaves_its_triangle_far_from_the_origin():
    """Hits on the patch, then a continuation each, cosine-distributed
    about the geometric normal down to grazing: under the JAX package's
    rule some re-meet their own triangle at their origin, under the
    port's none does."""
    scene = _far_mesh()
    g = torch.Generator().manual_seed(7)
    n = 4096
    xz = (torch.rand((n, 2), generator=g, dtype=F64) - 0.5) * 12.0
    o = torch.stack([xz[:, 0] + 800.0, torch.full((n,), 130.0, dtype=F64),
                     xz[:, 1] - 600.0], -1)
    d = torch.tensor([[0.05, -1.0, 0.03]], dtype=F64).expand(n, 3)
    inf = torch.full((n,), float("inf"))
    time = torch.zeros(n)
    hit = WW.closest_hit(scene, _v3(o), _v3(d / d.norm(dim=-1, keepdim=True)),
                         inf, time)
    # The few lanes the shared edges drop (exact_shared_edges=False) go.
    keep = hit.valid
    assert int(keep.sum()) > 0.9 * n
    hit = hit._replace(**{f: (V3(*(c[keep] for c in v)) if isinstance(v, V3)
                              else v[keep]) for f, v in hit._asdict().items()})
    n, inf, time = int(keep.sum()), inf[keep], time[keep]
    assert float(hit.p.length().min()) > 990.0
    # A direction about the normal: cos theta = sqrt(u) (cosine sampling),
    # u from 1e-4 up, so some leave at a grazing angle.
    u = torch.rand(n, generator=g, dtype=F64) * (1 - 1e-4) + 1e-4
    phi = torch.rand(n, generator=g, dtype=F64) * 2 * np.pi
    nn = torch.stack([hit.n.x, hit.n.y, hit.n.z], -1).double()
    up = nn[:, 1:2].sign() * nn            # the side the rays came from
    t1 = torch.linalg.cross(up, torch.tensor([[1.0, 0.0, 0.0]],
                                             dtype=F64).expand(n, 3))
    t1 = t1 / t1.norm(dim=-1, keepdim=True)
    t2 = torch.linalg.cross(up, t1)
    st = (1 - u).sqrt()[:, None]
    wi = _v3(up * u.sqrt()[:, None] + st * (t1 * phi.cos()[:, None]
                                            + t2 * phi.sin()[:, None]))
    counts = {}
    for name, rule in (("along", spawn_along), ("normal", R.spawn)):
        o2 = rule(hit.p, hit.n, wi)
        h2 = WW.closest_hit(scene, o2, wi, inf, time)
        counts[name] = int(R.self_hits(h2.valid, h2.prim_id, h2.t,
                                       hit.prim_id, o2))
    assert counts["along"] > 0, counts
    assert counts["normal"] == 0, counts


def _glass_sphere():
    """The cells' glass sphere (radius 1 at (0, 2, 0)) and point light."""
    import trace_tpu_torch as tt

    b = tt.SceneBuilder()
    glass = b.material(tt.GlassMaterial(index=1.5))
    b.sphere(tt.transforms.translate((0.0, 2.0, 0.0)), 1.0, glass)
    b.light(tt.point_light(tt.transforms.translate((4.0, 8.0, 4.0)),
                           (400.0, 400.0, 400.0)))
    return b.build(device="cpu")


def test_sphere_from_afar_matches_float64():
    """Rays from the cells' camera (|o| ~ 1,170) aimed over a disk 1.3
    radii wide around the glass sphere: the hit set is the float64
    reference's on the same float32 rays, and t agrees to 1e-5 relative.
    Rays whose line passes within 1e-3 radii of the silhouette are left
    out of the set's comparison: at 1,170 units float32 resolves a point
    to ~1.2e-4, so the answer there is float32's either way. The old
    quadratic (|o|^2 - r^2, ulp 0.125) hit ~6% beyond the silhouette, a
    band this sample covers with hundreds of rays."""
    scene = _glass_sphere()

    g = torch.Generator().manual_seed(11)
    n = 8192
    eye = torch.tensor([0.0, 400.0, 1100.0], dtype=F64)
    centre = torch.tensor([0.0, 2.0, 0.0], dtype=F64)
    fwd = (centre - eye) / (centre - eye).norm()
    e1 = torch.linalg.cross(fwd, torch.tensor([0.0, 1.0, 0.0], dtype=F64))
    e1 = e1 / e1.norm()
    e2 = torch.linalg.cross(e1, fwd)
    rad = 1.3 * torch.rand(n, generator=g, dtype=F64).sqrt()
    ang = 2 * np.pi * torch.rand(n, generator=g, dtype=F64)
    aim = (centre + rad[:, None] * (ang.cos()[:, None] * e1
                                    + ang.sin()[:, None] * e2))
    d32 = (aim - eye).float()
    d32 = d32 / d32.norm(dim=-1, keepdim=True)
    o32 = eye.float().expand(n, 3)
    from trace_tpu_torch.wavefront import geom as G

    inf = torch.full((n,), float("inf"))
    hit, t, _ = G.spheres_closest(scene.sphere_cols, _v3(o32), _v3(d32), inf)

    o, d = o32.double(), d32.double()
    t_ref = TL.sphere_t(o, d, centre, 1.0, torch.full((n,), float("inf"),
                                                      dtype=F64))
    hit_ref = torch.isfinite(t_ref)
    oc = o - centre
    perp = (oc - (oc * d).sum(-1, keepdim=True) * d
            / (d * d).sum(-1, keepdim=True)).norm(dim=-1)
    clear = (perp - 1.0).abs() > 1e-3
    assert int((clear & (perp > 1.0) & (perp < 1.06)).sum()) > 200
    assert torch.equal(hit[clear], hit_ref[clear]), int(
        (hit[clear] != hit_ref[clear]).sum())
    both = hit & hit_ref
    rel = ((t.double() - t_ref) / t_ref).abs()[both]
    assert float(rel.max()) < 1e-5


@pytest.mark.parametrize("where", ["inside", "surface"])
def test_sphere_from_near_matches_float64(where):
    """The same sphere from origins near it: ``inside``, random points
    within 0.9 radii of the centre; ``surface``, random points of the
    sphere left by the port's spawn (core/ray.py::spawn) along random
    directions, into the sphere or away from it, as a walk's refraction
    and reflection leave it. The hit set is the float64 reference's on the
    same float32 rays, and t agrees to 1e-5 relative. Rays within 1e-3
    of grazing the surface they leave are left out of the set's
    comparison. A ray that enters within 0.1 of grazing crosses a chord
    t ~ 2 cos of its angle, the root of a discriminant near 0, which
    float32 resolves to ~2e-5 absolute: there t agrees to 5e-5."""
    from trace_tpu_torch.wavefront import geom as G

    scene = _glass_sphere()

    g = torch.Generator().manual_seed(13)
    n = 8192
    centre = torch.tensor([0.0, 2.0, 0.0], dtype=F64)

    def unit(k):
        v = torch.randn((k, 3), generator=g, dtype=F64)
        return v / v.norm(dim=-1, keepdim=True)

    d32 = unit(n).float()
    normal = unit(n)
    if where == "inside":
        r = 0.9 * torch.rand(n, generator=g, dtype=F64) ** (1 / 3)
        o32 = (centre + r[:, None] * normal).float()
        clear = steep = torch.ones(n, dtype=torch.bool)
    else:
        p32, n32 = (centre + normal).float(), normal.float()
        o32 = R.spawn(_v3(p32), _v3(n32), _v3(d32)).arr()
        cos = (n32 * d32).sum(-1)
        clear, steep = cos.abs() > 1e-3, cos.abs() > 0.1
        assert 0.4 < float((cos < 0).double().mean()) < 0.6
    inf = torch.full((n,), float("inf"))
    hit, t, _ = G.spheres_closest(scene.sphere_cols, _v3(o32), _v3(d32), inf)

    t_ref = TL.sphere_t(o32.double(), d32.double(), centre, 1.0,
                        torch.full((n,), float("inf"), dtype=F64))
    hit_ref = torch.isfinite(t_ref)
    assert int(hit_ref[clear].sum()) > 0.4 * n
    assert torch.equal(hit[clear], hit_ref[clear]), int(
        (hit[clear] != hit_ref[clear]).sum())
    both = hit & hit_ref & clear
    err = (t.double() - t_ref).abs()
    assert float((err / t_ref)[both & steep].max()) < 1e-5
    assert float(err[both].max()) < 5e-5


def test_self_hit_counters(monkeypatch):
    """``stats`` gets each walk's self hits in its one read: some photon
    bounces on the CPU-size heightfield re-meet their own triangle under
    the JAX package's spawn rule (the walks' ``spawn`` argument), none
    under the port's."""
    import functools

    from perfbench.drivers import scene as DS
    from trace_tpu_torch.integrators.sppm import SPPMIntegrator
    from trace_tpu_torch.utils.stats import RenderStats
    from trace_tpu_torch.wavefront import sppm_camera, sppm_photon

    desc = dict(harness.CellSpec(PC.ROOT, CELLS[1]).config["scene"],
                heightfield_tris=SIZE["tris"])
    verts, tris, _ = DS.terrain(desc)
    scene = DS.build_scene(desc, "cpu", verts, tris)

    def counters():
        stats = RenderStats()
        SPPMIntegrator(DS.build_camera(desc, SIZE["resolution"]),
                       initial_search_radius=SIZE["radius"], max_depth=8,
                       photons_per_iteration=SIZE["photons"], stats=stats,
                       device="cpu").render(scene, n_iterations=1)
        d = stats.as_dict()
        return d["sppm_camera_self_hits"], d["sppm_photon_self_hits"]

    assert counters() == (0, 0)
    for mod, name in ((sppm_camera, "camera_pass_body"),
                      (sppm_photon, "photon_walk_body")):
        monkeypatch.setattr(mod, name, functools.partial(
            getattr(mod, name), spawn=spawn_along))
    camera, photon = counters()
    assert photon > 0, (camera, photon)
