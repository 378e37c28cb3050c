"""The port takes every keyword of the JAX package's public signatures.

For each public module of ``trace_tpu`` and each function and class it
defines (a class's ``__init__``, ``__call__`` and public methods), the
port's counterpart must exist and accept every keyword the JAX one
names, unless the name stands in EXCLUDED (or its module in
EXCLUDED_MODULES), each with the reason it is left out by design: the
JAX package's packed stack (its planar twin is the port's one stack),
Pallas and native modules (the port's kernels and builder are its own),
and TPU workarounds. Each exclusion must still be absent from the port,
so the list cannot hide a name the port has.

Also: the five models' ``build_camera(convention=)`` against JAX's rays
(rtol 1e-5, atol 1e-6, the camera tests' tolerance), ``Filter``
subclassing in both of its forms, ``trace_profile(dir, *barrier_args)``,
``Scene.with_geometry(accelerator=)`` and ``bump_version``, and the
spheres script's arguments against the JAX package's script.
"""
import importlib
import inspect
import pkgutil
import runpy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import trace_tpu

# Modules of the JAX package the port leaves out, by design.
EXCLUDED_MODULES = {
    "bxdf": "the packed BSDF stack (the port's lobes: wavefront/shade.py)",
    "core.interaction": "packed hit records (the port's: wavefront/geom.py "
                        "HitP)",
    "utils.pytree": "JAX pytree registration",
    "native": "the JAX package's binding of the SAH builder (the port's: "
              "accel/native.py over csrc/bvh_builder.cpp)",
    "ops.intersect_pallas": "the Pallas all-pairs test (the port's: "
                            "ops/intersect.py and csrc/intersect.cu)",
}

# JAX modules and names whose port lives under another name: the Pallas
# sweep's public construction is ops/sweep.py's (over csrc/sweep.cu and
# csrc/entry.cu).
PORT_MODULES = {"ops.sweep_pallas": "ops.sweep"}
PORT_NAMES = {("ops.sweep_pallas", "PallasSweepAccelerator"):
              "SweepAccelerator"}

_PACKED = "the packed stack's [..., 3] form (the port keeps the planar one)"
# (module, name) the port leaves out, by design, with the reason.
EXCLUDED = {
    **{("core.math", n): _PACKED + ": core/vec.py" for n in (
        "cross", "length_squared", "distance", "distance_squared", "vec",
        "face_forward", "reflect", "refract", "unpack3", "pack3",
        "mat3_apply", "mat3_apply_t", "coordinate_system",
        "concentric_sample_disk", "cosine_sample_hemisphere",
        "uniform_sample_sphere", "uniform_sample_cone", "uniform_sphere_pdf",
        "uniform_cone_pdf", "uniform_sample_triangle", "cos_theta",
        "cos2_theta", "sin2_theta", "sin_theta", "tan_theta", "tan2_theta",
        "cos_phi", "sin_phi", "same_hemisphere", "spherical_direction",
        "spherical_theta", "spherical_phi", "power_heuristic")},
    **{("core.ray", n): _PACKED + ": packed rays (wavefront/geom.py RayP)"
       for n in ("Rays", "make_rays", "make_differentials", "base_rays",
                 "at", "check_direction", "spawn_ray", "spawn_ray_to")},
    **{("core.spectrum", n): _PACKED + ": packed spectra" for n in (
        "to_y", "is_black", "clamp_spectrum")},
    **{("core.vec", n): "the row-matrix gather, a TPU layout workaround "
       "(the port's tree_gather gathers each leaf)" for n in (
           "pack_rows", "unpack_rows", "tree_rows", "rows_tree")},
    **{("integrators.common", n): _PACKED + ": the packed li's helpers "
       "(their planar twins: wavefront/)" for n in (
           "offset_ray_origin", "sum_over_lights", "estimate_direct",
           "uniform_sample_one_light", "reflect_differentials",
           "transmit_differentials")},
    ("integrators.common", "vary_like"): "a shard_map carry workaround",
    ("integrators.path", "li"): _PACKED + ": the packed li",
    ("integrators.whitted", "li"): _PACKED + ": the packed li",
    **{("lights.lights", n): _PACKED + ": packed light sampling "
       "(wavefront/lights.py)" for n in (
           "falloff", "env_le", "le_inf", "sample_li", "pdf_li",
           "sample_le", "le_area")},
    **{("materials.materials", n): _PACKED + ": packed BSDF lobes "
       "(wavefront/materials.py)" for n in (
           "compute_scattering", "Material.add_lobes",
           "MatteMaterial.add_lobes", "MirrorMaterial.add_lobes",
           "GlassMaterial.add_lobes", "PlasticMaterial.add_lobes",
           "MetalMaterial.add_lobes")},
    **{("sampler.uniform", n): _PACKED + ": scalar-key draws of the packed "
       "path (the port draws per lane)" for n in (
           "get_1d", "get_2d", "ensure_lane_keys", "get_camera_samples")},
    **{(f"shapes.{m}", n): _PACKED + ": packed intersection and records "
       "(wavefront/geom.py)" for m in ("sphere", "triangle") for n in (
           "intersect_all", "intersect_closest", "intersect_p",
           "make_hit")},
    **{("wavefront.geom", n): _PACKED + ": conversions to and from packed "
       "records" for n in ("hitp_from_packed", "hitp_to_packed")},
    **{(f"accel.{m}", f"{c}.{n}"): _PACKED + ": the accelerators' packed "
       "closest / any_hit (the port's interface: intersect)"
       for m, c in (("bvh", "BVHAccelerator"),
                    ("clusters", "ClusterAccelerator"),
                    ("wbvh", "WBVHAccelerator"))
       for n in ("closest", "any_hit")},
    ("accel.instances", "instanced_traverse"): _PACKED + ": the packed "
        "instance walk (the port's: sweep_instances)",
    ("accel.instances", "make_instanced_hit"): _PACKED + ": packed "
        "instance records (the port's: InstancedGeometry.make_hit_record)",
    ("accel.wbvh", "traverse_batch"): "the JAX package's XLA walk (the "
        "port's: csrc/bvh_walk.cu through walk, its twin walk_plain)",
    **{("ops.sweep_pallas", f"PallasSweepAccelerator.{n}"): _PACKED + ": the "
       "accelerators' packed closest / any_hit (the port's interface: "
       "intersect)" for n in ("closest", "any_hit")},
}


# Keywords of a name the port has that it leaves out, with the reason.
_INTERPRET = {"interpret": "the Pallas interpreter (the port runs the "
                            "kernel's plain PyTorch version on the CPU)"}
EXCLUDED_KEYWORDS = {
    ("wavefront.path", "uniform_sample_one_light"): {
        "light_cdf": "a power-weighted pick that no caller in the JAX "
                     "package passes (its integrators pick uniformly)"},
    **{("ops.sweep_pallas", q): _INTERPRET for q in (
        "PallasSweepAccelerator", "PallasSweepAccelerator.from_tables",
        "attach")},
}


def _excluded_module(tail):
    return any(tail == m or tail.startswith(m + ".")
               for m in EXCLUDED_MODULES)


def _jax_modules():
    for m in pkgutil.walk_packages(trace_tpu.__path__, "trace_tpu."):
        tail = m.name[len("trace_tpu."):]
        if any(p.startswith("_") for p in tail.split(".")) or \
                _excluded_module(tail):
            continue
        yield tail


def _cases():
    """(module tail, qualified name) of every public function, class
    constructor and public or __call__ method (class and static methods
    too) the JAX package defines."""
    out = []
    for tail in _jax_modules():
        mod = importlib.import_module("trace_tpu." + tail)
        for name, obj in sorted(vars(mod).items()):
            if name.startswith("_") or getattr(obj, "__module__", None) \
                    != mod.__name__:
                continue
            if inspect.isfunction(obj):
                out.append((tail, name))
            elif inspect.isclass(obj):
                out.append((tail, name))
                for m, f in sorted(vars(obj).items()):
                    if isinstance(f, (classmethod, staticmethod)):
                        f = f.__func__
                    if (not m.startswith("_") or m == "__call__") and \
                            inspect.isfunction(f):
                        out.append((tail, f"{name}.{m}"))
    return [c for c in out if c not in EXCLUDED]


CASES = _cases()


def _port_name(tail, qual):
    """(module tail, qualified name) of a JAX name's port."""
    head, _, rest = qual.partition(".")
    head = PORT_NAMES.get((tail, head), head)
    return PORT_MODULES.get(tail, tail), head + ("." + rest if rest else "")


def _resolve(root, tail, qual):
    if root == "trace_tpu_torch":
        tail, qual = _port_name(tail, qual)
    obj = importlib.import_module(f"{root}.{tail}")
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj


def _keywords(fn):
    sig = inspect.signature(fn)
    return {k: p for k, p in sig.parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}


@pytest.mark.parametrize("tail, qual", CASES,
                         ids=[f"{t}:{q}" for t, q in CASES])
def test_port_takes_every_jax_keyword(tail, qual):
    jobj = _resolve("trace_tpu", tail, qual)
    tobj = _resolve("trace_tpu_torch", tail, qual)
    if inspect.isclass(jobj):
        jobj, tobj = jobj.__init__, tobj.__init__
    try:
        want = _keywords(jobj)
    except (TypeError, ValueError):   # no signature to hold
        return
    got = inspect.signature(tobj).parameters
    takes_any = any(p.kind == p.VAR_KEYWORD for p in got.values())
    left_out = EXCLUDED_KEYWORDS.get((tail, qual), {})
    missing = [k for k in want if k not in got and not takes_any
               and k not in left_out]
    assert not missing, f"{tail}.{qual} lacks {missing}"
    assert not set(left_out) & set(got), "an excluded keyword is taken"


@pytest.mark.parametrize("key", sorted(EXCLUDED) + sorted(
    (m, None) for m in EXCLUDED_MODULES), ids=str)
def test_exclusions_are_absent_from_the_port(key):
    """Every exclusion names something the port does not have."""
    tail, qual = key
    if qual is not None:
        tail, qual = _port_name(tail, qual)
    try:
        obj = importlib.import_module(f"trace_tpu_torch.{tail}")
    except ImportError:
        return
    assert qual is not None, f"the port has the excluded module {tail}"
    for part in qual.split("."):
        if not hasattr(obj, part):
            return
        obj = getattr(obj, part)
    pytest.fail(f"the port has the excluded {tail}.{qual}")


def test_the_cases_cover_the_ported_names():
    names = {f"{t}:{q}" for t, q in CASES}
    for want in ("integrators.base:SamplerIntegrator",
                 "integrators.whitted:WhittedIntegrator",
                 "integrators.sppm:SPPMIntegrator.fused_cost_analysis",
                 "integrators.sppm:SPPMIntegrator.step",
                 "accel.mxu:MXUAccelerator", "accel.mxu:attach",
                 "accel.morton:attach", "film.filters:Filter",
                 "scene:Scene.bump_version", "scene:Scene.with_geometry",
                 "accel.instances:build_instances",
                 "ops.sweep_pallas:PallasSweepAccelerator",
                 "ops.sweep_pallas:PallasSweepAccelerator.from_tables",
                 "ops.sweep_pallas:SweepTables", "ops.sweep_pallas:attach",
                 "utils.stats:trace_profile"):
        assert want in names, want
    assert len(CASES) > 300


# -- the named signatures, by behaviour -------------------------------------

MODELS = ("caustic_glass", "cornell", "mesh_heavy", "sphere", "spheres")


@pytest.mark.parametrize("convention", ["reference", "pbrt"])
@pytest.mark.parametrize("model", MODELS)
def test_build_camera_convention_matches_jax(model, convention):
    tm = importlib.import_module(f"trace_tpu_torch.models.{model}")
    jm = importlib.import_module(f"trace_tpu.models.{model}")
    tc = tm.build_camera(24, "unused.png", convention=convention)
    jc = jm.build_camera(24, "unused.png", convention=convention)
    rng = np.random.default_rng(7)
    p = rng.uniform(1.0, 25.0, (512, 2)).astype(np.float32)
    ul = rng.uniform(size=(512, 2)).astype(np.float32)
    ut = rng.uniform(size=512).astype(np.float32)
    trd, _ = tc.generate_ray_differentials(*map(torch.from_numpy,
                                                (p, ul, ut)))
    jrd, _ = jc.generate_ray_differentials(*map(jnp.asarray, (p, ul, ut)))
    for f in ("o", "d", "rx_direction", "ry_direction"):
        np.testing.assert_allclose(getattr(trd, f).numpy(),
                                   np.asarray(getattr(jrd, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)


def test_filter_subclasses_in_both_forms():
    """A Filter subclass gives its weight as __call__(p) over stacked
    offsets (the JAX package's form) or as weight(px, py); the film takes
    either, and the port's filters answer both calls alike."""
    from trace_tpu_torch.film import filters as F
    from trace_tpu_torch.film.film import Film

    class JaxStyle(F.Filter):
        radius = (1.5, 1.5)

        def __call__(self, p):
            return (1.5 - p.abs()).clamp_min(0.0).prod(-1)

    class PortStyle(F.Filter):
        radius = (1.5, 1.5)

        def weight(self, px, py):
            return (1.5 - px.abs()).clamp_min(0.0) * \
                (1.5 - py.abs()).clamp_min(0.0)

    p = torch.rand(40, 2) * 3 - 1.5
    for f in (JaxStyle(), PortStyle(), F.TriangleFilter((1.5, 1.5))):
        assert isinstance(f, F.Filter)
        torch.testing.assert_close(f(p), f.weight(p[:, 0], p[:, 1]),
                                   rtol=0, atol=0)
    for f in (PortStyle(), F.TriangleFilter((1.5, 1.5))):
        torch.testing.assert_close(f(p[:, 0], p[:, 1]), f(p), rtol=0,
                                   atol=0)
    films = [Film((8, 8), filter=f) for f in (
        JaxStyle(), PortStyle(), F.TriangleFilter((1.5, 1.5)))]
    pts = torch.rand(64, 2) * 8 + 1
    l, w = torch.rand(64, 3), torch.ones(64)
    outs = [fm.add_samples(fm.initial_state("cpu"), pts, l, w)
            for fm in films]
    for o in outs[1:]:
        assert torch.equal(o.weight_sum, outs[0].weight_sum)
    with pytest.raises(NotImplementedError):
        F.Filter()(p)


def test_trace_profile_takes_barrier_args(tmp_path):
    from trace_tpu_torch.utils.stats import trace_profile

    x = torch.ones(8)
    with trace_profile(str(tmp_path / "t"), x, (x, {"y": x})) as tp:
        y = (x * 2).sum()
    assert tp.barrier_args == (x, (x, {"y": x}))
    assert float(y) == 16.0 and tp.path.endswith("trace.json")


def test_with_geometry_accelerator_and_bump_version():
    from trace_tpu_torch.models import mesh_heavy as TMH

    scene = TMH.build_scene(200, device="cpu")
    acc = scene.accel
    for view in (scene.with_geometry(scene.triangles, acc),
                 scene.with_geometry(scene.triangles, accelerator=acc),
                 scene.with_geometry(scene.triangles, accel=acc)):
        assert view.accel is acc and view is not scene
    assert scene.with_geometry(scene.triangles).accel is None
    with pytest.raises(TypeError):
        scene.with_geometry(scene.triangles, acc, accel=acc)
    v = scene._version
    scene.bump_version()
    assert scene._version == v + 1


def test_instances_take_the_jax_settings():
    """build_instances and InstancedGeometry take stage_clusters,
    leaf_tris and use_accel; the port's base sweep keeps its 64 x 8."""
    from trace_tpu_torch.accel import instances as I
    from trace_tpu_torch.core import transform as T

    rng = np.random.default_rng(2)
    verts = rng.normal(size=(300, 3)).astype(np.float32)
    idx = np.arange(300).reshape(100, 3)
    trs = [T.translate([3.0 * k, 0.0, 0.0]) for k in range(3)]
    g = I.build_instances(idx, verts, trs, stage_clusters=32, leaf_tris=16)
    assert (g.stage_clusters, g.leaf_tris) == (32, 16)
    assert g.sweep_tables is not None
    grid = I.InstancedGeometry(g.base, g.table, use_accel=False)
    assert grid.sweep_tables is None
    auto = I.InstancedGeometry(g.base, g.table)
    assert auto.sweep_tables is not None


def _script_args(pkg, monkeypatch):
    run = importlib.import_module(f"{pkg}.models._run")
    got = {}
    monkeypatch.setattr(run, "sppm_main",
                        lambda *a, **k: got.update(k, args=a))
    runpy.run_module(f"{pkg}.models.spheres", run_name="__main__")
    monkeypatch.undo()
    return got


def test_spheres_script_runs_the_jax_hero_config(monkeypatch):
    """python -m trace_tpu_torch.models.spheres hands sppm_main what the
    JAX package's script hands it: SPPM 1024^2, 100 iterations, radius
    0.025, depth 5, shadows.png."""
    port = _script_args("trace_tpu_torch", monkeypatch)
    jax_ = _script_args("trace_tpu", monkeypatch)
    keys = ("resolution", "iterations", "radius", "depth", "output")
    assert {k: port[k] for k in keys} == {k: jax_[k] for k in keys} == dict(
        resolution=1024, iterations=100, radius=0.025, depth=5,
        output="shadows.png")


def test_small_helpers_match_jax():
    """core/vec.py's planar helpers, the shapes' area helpers and
    empty_hitp against the JAX package's, on the same inputs (bit for
    bit: the same operations, op by op)."""
    from trace_tpu.core import vec as JV
    from trace_tpu.shapes import sphere as JSp
    from trace_tpu.shapes import triangle as JTr
    from trace_tpu.wavefront import geom as JG
    from trace_tpu_torch.core import vec as TV
    from trace_tpu_torch.models import spheres as TSph
    from trace_tpu_torch.shapes import sphere as TSp
    from trace_tpu_torch.shapes import triangle as TTr
    from trace_tpu_torch.wavefront import geom as TG

    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(2, 3, 64)).astype(np.float32)
    t = rng.uniform(size=64).astype(np.float32)
    ta, tb = TV.V3(*map(torch.from_numpy, a)), TV.V3(*map(torch.from_numpy, b))
    ja, jb = JV.V3(*map(jnp.asarray, a)), JV.V3(*map(jnp.asarray, b))
    tt, jt = torch.from_numpy(t), jnp.asarray(t)
    pairs = [(TV.minimum(ta, tb), JV.minimum(ja, jb)),
             (TV.maximum(ta, tb), JV.maximum(ja, jb)),
             (TV.maximum(ta, 0.25), JV.maximum(ja, 0.25)),
             (TV.lerp(ta, tb, tt), JV.lerp(ja, jb, jt)),
             (TV.reflect(ta, tb), JV.reflect(ja, jb)),
             (TV.spherical_direction(tt, tt, tt),
              JV.spherical_direction(jt, jt, jt)),
             (TV.mat3_apply([[tt, tb.x, 0.5], [ta.y, tt, tb.z],
                             [1.0, ta.z, tt]], ta),
              JV.mat3_apply([[jt, jb.x, 0.5], [ja.y, jt, jb.z],
                             [1.0, ja.z, jt]], ja))]
    for x, y in pairs:
        np.testing.assert_allclose(np.stack([c.numpy() for c in x]),
                                   np.stack([np.asarray(c) for c in y]),
                                   rtol=1e-6, atol=1e-7)
    # A [..., 3, 3] tensor applies the matrix: the nested rows' result.
    # (JAX's vec.mat3_apply applies a [..., 3, 3] array's transpose, a
    # fault no JAX caller meets: they pass nested rows; ROADMAP C.)
    m = torch.from_numpy(rng.normal(size=(64, 3, 3)).astype(np.float32))
    rows = [[m[:, i, j] for j in range(3)] for i in range(3)]
    for f in (TV.mat3_apply, TV.mat3_apply_t):
        assert all(torch.equal(x, y) for x, y in zip(f(m, ta), f(rows, ta)))
    np.testing.assert_array_equal(TV.cos2_theta(ta).numpy(),
                                  np.asarray(JV.cos2_theta(ja)))
    np.testing.assert_array_equal(ta.sum().numpy(), np.asarray(ja.sum()))
    assert ta.astype(torch.float64).x.dtype == torch.float64
    tris = TSph.build_scene(device="cpu").triangles
    jtris = JTr.Triangles(*[jnp.asarray(x) for x in tris])
    np.testing.assert_allclose(TTr.areas_np(tris), JTr.areas_np(jtris),
                               rtol=1e-6)
    np.testing.assert_allclose(TTr.areas(tris).numpy(),
                               np.asarray(JTr.areas(jtris)), rtol=1e-6)
    assert TTr.num_triangles(TTr.empty_triangles()) == 0 == \
        JTr.num_triangles(JTr.empty_triangles())
    sph = TSph.build_scene(device="cpu").spheres
    np.testing.assert_allclose(TSp.area(sph), np.asarray(JSp.area(
        JSp.Spheres(*[jnp.asarray(x) for x in sph]))), rtol=1e-6)
    th, jh = TG.empty_hitp(5, "cpu"), JG.empty_hitp(5)
    for f, x, y in zip(TG.HitP._fields, th, jh):
        x = np.stack([c.numpy() for c in x]) if isinstance(x, tuple) \
            else x.numpy()
        y = np.stack([np.asarray(c) for c in y]) if isinstance(y, tuple) \
            else np.asarray(y)
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_li_return_aux_false_gives_the_radiance_alone():
    """The planar li's return_aux=False (the JAX package's default) gives
    the radiance that the counters come with otherwise."""
    from trace_tpu_torch.models import spheres as TSph
    from trace_tpu_torch.sampler import uniform as TU
    from trace_tpu_torch.wavefront import path as TWP
    from trace_tpu_torch.wavefront import whitted as TWW

    scene = TSph.build_scene(device="cpu")
    cam = TSph.build_camera(8, "unused.png")
    px = torch.stack(torch.meshgrid(torch.arange(1, 9), torch.arange(1, 9),
                                    indexing="xy"), -1).reshape(-1, 2)
    rd, _ = cam.generate_ray_differentials(px.float() + 0.5,
                                           torch.zeros(64, 2),
                                           torch.zeros(64))
    keys = TU.lane_keys(TU.key(0, "cpu"), TU.pixel_ids(px))
    for li in (TWW.li, TWP.li):
        l, aux = li(scene, rd, keys, max_depth=2)
        assert torch.equal(li(scene, rd, keys, max_depth=2,
                              return_aux=False), l)
        assert int(aux["useful_rays"]) > 0
