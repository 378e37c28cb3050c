"""Animated geometry in the port (render(geometry=, geometry_transform=,
geometry_accel=), SPPM render_frames, models/caustic_moving.py) against
scenes rebuilt from the moved mesh, in the port and in the JAX package.

Scenes: a soup of 300 triangles (more than 64: the sweep over tables the
frame rebuilds on its device, Morton clusters of 64 grouped 8 to a super;
``sweep_plain`` on the CPU) and a soup of 12 (the brute-force route), matte,
under a point light, framed by mesh_heavy's camera at 24^2 (the JAX
package's own animated tests use the ``pbrt`` camera convention, which the
port refuses).

Tolerances:
- an animated frame against a scene rebuilt from the moved mesh (SAH
  tables; the JAX package's images too): atol 2e-3, as the JAX package's
  tests/test_animated_geometry.py; only the clusters differ, and the sweep
  is exact;
- two spellings of one frame (a transform on the device against
  pre-moved triangles, a SweepTables against its SweepAccelerator,
  render_frames against render, batched against sequential animation
  frames, a relight against a scene built with the frame's lights):
  bit-equal;
- the frame's light tables against the JAX package's: bit-equal.
"""
from dataclasses import fields

import numpy as np
import pytest
import torch

from trace_tpu.core import transform as JT
from trace_tpu.integrators.path import PathIntegrator as JPath
from trace_tpu.integrators.whitted import WhittedIntegrator as JWhitted
from trace_tpu.lights import lights as JL
from trace_tpu.materials import materials as JMat
from trace_tpu.models import caustic_moving as JCM
from trace_tpu.models import mesh_heavy as JMH
from trace_tpu.sampler.uniform import UniformSampler as JSampler
from trace_tpu.scene import SceneBuilder as JBuilder
from trace_tpu_torch import convert as C
from trace_tpu_torch.accel import clusters as TC
from trace_tpu_torch.accel import morton as TM
from trace_tpu_torch.integrators import common as TCm
from trace_tpu_torch.integrators.path import PathIntegrator
from trace_tpu_torch.integrators.sppm import SPPMIntegrator, SPPMState
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.lights import lights as TL
from trace_tpu_torch.materials import materials as TMat
from trace_tpu_torch.models import caustic_moving as TCM
from trace_tpu_torch.models import mesh_heavy as TMH
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.sampler.uniform import UniformSampler
from trace_tpu_torch.scene import SceneBuilder
from trace_tpu_torch.shapes import triangle as TTri

RES = 24
ATOL = 2e-3
MSE_GATE = 5e-4
MESHES = {"soup": (300, 1.5), "small": (12, 4.0)}
JMOTION = JT.compose(JT.translate([0.15, -0.1, 0.3]), JT.rotate_y(20.0))
MOTION = C.transform_from_jax(JMOTION)
LIGHT = ([4.0, 8.0, 4.0], (400.0, 400.0, 400.0))
INTEGRATORS = {"whitted": (WhittedIntegrator, JWhitted),
               "path": (PathIntegrator, JPath)}
SPPM_KW = dict(initial_search_radius=0.6, max_depth=3, n_iterations=2,
               photons_per_iteration=256, device="cpu")


def _mesh(which):
    """Triangles with centres over mesh_heavy's terrain square, flattened
    in y, and edges ~``size`` long."""
    n, size = MESHES[which]
    rng = np.random.default_rng(3)
    c = rng.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    c[:, 1] *= 0.1
    e1 = rng.normal(0, size, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, size, (n, 3)).astype(np.float32)
    verts = np.concatenate([c, c + e1, c + e2], 0)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n],
                   -1)
    return idx, verts


def _port_scene(which, xf=None, lights=None, exact=False):
    idx, verts = _mesh(which)
    b = SceneBuilder()
    b.triangle_mesh(xf or C.transform_from_jax(JT.identity()), idx, verts,
                    b.material(TMat.MatteMaterial()))
    for entry in lights or [TL.point_light(C.transform_from_jax(
            JT.translate(LIGHT[0])), LIGHT[1])]:
        b.light(entry)
    return b.build(device="cpu", exact_shared_edges=exact)


def _jax_scene(which, xf):
    idx, verts = _mesh(which)
    b = JBuilder()
    b.triangle_mesh(xf, idx, verts, b.material(JMat.MatteMaterial()))
    b.light(JL.point_light(JT.translate(LIGHT[0]), LIGHT[1]))
    return b.build()


def _render(kind, scene, res=RES, **kw):
    integ = INTEGRATORS[kind][0](TMH.build_camera(res, "unused.png"),
                                 UniformSampler(1, seed=0), max_depth=3)
    return integ.camera.film.to_image(integ.render(scene, **kw)).numpy()


def _moved(scene, xf=MOTION):
    return TTri.transform_triangles(TTri.to_device(scene.triangles, "cpu"),
                                    xf)


@pytest.fixture(scope="module")
def jax_images():
    """The JAX package's render of each scene rebuilt with the moved mesh
    (jitted, once)."""
    out = {}
    for which, kind in (("soup", "whitted"), ("soup", "path"),
                        ("small", "whitted")):
        integ = INTEGRATORS[kind][1](JMH.build_camera(RES, "unused.png"),
                                     JSampler(1, seed=0), max_depth=3)
        out[which, kind] = np.asarray(integ.camera.film.to_image(
            integ.render(_jax_scene(which, JMOTION))))
    return out


def _scene_of(tris):
    """A scene built from a (moved) triangle table as it stands: the same
    vertex bits, SAH tables."""
    t = TTri.to_numpy(tris)
    n = t.v0.shape[0]
    b = SceneBuilder()
    b.triangle_mesh(C.transform_from_jax(JT.identity()),
                    np.arange(3 * n).reshape(n, 3),
                    np.stack([t.v0, t.v1, t.v2], 1).reshape(-1, 3),
                    b.material(TMat.MatteMaterial()))
    b.light(TL.point_light(C.transform_from_jax(JT.translate(LIGHT[0])),
                           LIGHT[1]))
    return b.build(device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """Per mesh: the base scene and the scene built with the moved mesh."""
    return {which: (_port_scene(which), _port_scene(which, MOTION))
            for which in MESHES}


def _mse(a, b):
    return float(np.mean((a - b) ** 2))


@pytest.mark.parametrize("which,kind", [("soup", "whitted"),
                                        ("soup", "path"),
                                        ("small", "whitted"),
                                        ("small", "path")])
def test_animated_frame_matches_rebuilt_scene(jax_images, scenes, which,
                                              kind):
    # Whitted within atol; the path tracer by the MSE gate: its bounces
    # start on the surface, where a last-bit difference in a vertex or in
    # a Moller-Trumbore constant turns a borderline hit, and 1 spp does
    # not average it out.
    base, rebuilt = scenes[which]
    moved = _moved(base)
    img = _render(kind, base, geometry=moved)
    assert np.isfinite(img).all() and img.max() > 0.01
    refs = [_render(kind, rebuilt), _render(kind, _scene_of(moved))]
    if (which, kind) in jax_images:
        refs.append(jax_images[which, kind])
    for ref in refs:
        if kind == "whitted":
            np.testing.assert_allclose(img, ref, atol=ATOL)
        assert _mse(img, ref) < MSE_GATE
    # The frame moved the mesh: the base scene's image differs.
    assert np.abs(_render(kind, base) - img).max() > 0.05
    if which == "soup":
        # The frame's clusters with the static build's double-precision
        # constants (a refit of the Morton topology): the image of the scene
        # built from the same vertex bits, bit for bit. Only the f32
        # constants of the device build (the JAX package's) part from it.
        mt = TM.build_clusters_device(moved, 64)
        host = TC.ClusterAccel(*(x.numpy() for x in mt[:4]), 64)
        v = TTri.to_numpy(moved)
        dbl = TS.SweepTables(TC.refit_clusters(host, v.v0, v.v1, v.v2), 8)
        np.testing.assert_array_equal(
            _render(kind, base, geometry=moved, geometry_accel=dbl), refs[1])


def test_prepare_geometry_routes(scenes):
    # Above 64 triangles: tables rebuilt where the triangles lie, Morton
    # clusters of LEAF_TRIS grouped GROUP to a super; at 64 or fewer, no
    # tables (brute force over the moved triangles). The base scene keeps
    # its own tables, rows and caches.
    soup, small = scenes["soup"][0], scenes["small"][0]
    tris, tables = TCm.prepare_geometry(soup, soup.triangles, MOTION)
    assert torch.is_tensor(tris.v0) and torch.is_tensor(tables.panel)
    assert (tables.leaf_tris, tables.group) == (64, 8)
    ref = TS.SweepTables(TM.build_clusters_device(_moved(soup), 64), 8)
    for f in ("panel", "slot_to_tri", "s_lo", "s_hi"):
        assert torch.equal(getattr(tables, f), getattr(ref, f)), f
    view = TCm.apply_geometry(soup, (tris, tables))
    assert view.accel is not soup.accel and view.accel.tables is tables
    assert view.triangles is tris and view.area_tables is not \
        soup.area_tables
    assert not torch.equal(view.triangle_rows, soup.triangle_rows)
    assert isinstance(soup.triangles.v0, np.ndarray)
    assert TCm.prepare_geometry(soup, None) is None
    tris_s, none = TCm.prepare_geometry(small, small.triangles, MOTION)
    assert none is None and small.accel is None
    assert TCm.apply_geometry(small, (tris_s, None)).accel is None


@pytest.mark.parametrize("kind", ["whitted", "path"])
def test_geometry_transform_equals_moved_geometry(scenes, kind):
    base = scenes["soup"][0]
    a = _render(kind, base, geometry=_moved(base))
    b = _render(kind, base, geometry=base.triangles,
                geometry_transform=MOTION)
    np.testing.assert_array_equal(a, b)


def test_geometry_accel_spellings_and_refit(scenes):
    base, rebuilt = scenes["soup"]
    plain = _render("whitted", base)
    sah = TS.SweepTables(TC.build_clusters(base.triangles, 64, 4), 8)
    acc = base.sweep(sah)
    img_t = _render("whitted", base, geometry=base.triangles,
                    geometry_accel=sah)
    img_a = _render("whitted", base, geometry=base.triangles,
                    geometry_accel=acc)
    # The base scene's own tables, through either spelling: its image.
    np.testing.assert_array_equal(img_t, img_a)
    np.testing.assert_array_equal(img_t, plain)
    # Device-built (Morton) tables of the same triangles: the same hits.
    morton = TS.SweepTables(TM.build_clusters_device(
        TTri.to_device(base.triangles, "cpu"), 64), 8)
    np.testing.assert_allclose(
        _render("whitted", base, geometry=base.triangles,
                geometry_accel=morton), plain, atol=ATOL)
    # Refit the SAH tables to the moved mesh: the rebuilt scene's image.
    moved = _moved(base)
    acc.refit(moved.v0, moved.v1, moved.v2)
    np.testing.assert_allclose(
        _render("whitted", base, geometry=moved, geometry_accel=acc),
        _render("whitted", rebuilt), atol=ATOL)
    with pytest.raises(TypeError):
        _render("whitted", base, geometry=moved, geometry_accel=object())


def test_exact_edges_through_geometry_accel(scenes):
    base = scenes["soup"][0]
    exact = _port_scene("soup", exact=True)
    sah = TS.SweepTables(TC.build_clusters(exact.triangles, 64, 4), 8)
    view = TCm.apply_geometry(exact, TCm.prepare_geometry(
        exact, exact.triangles, accel=sah))
    assert view.accel.certified and not base.accel.certified
    img = _render("whitted", exact, geometry=exact.triangles,
                  geometry_accel=sah)
    np.testing.assert_array_equal(img, _render("whitted", exact))
    np.testing.assert_allclose(img, _render("whitted", base), atol=ATOL)


def _sppm(res=RES):
    return SPPMIntegrator(TMH.build_camera(res, "unused.png"), **SPPM_KW)


def test_sppm_animated_matches_rebuilt_scene(scenes):
    base, rebuilt = scenes["soup"]
    a = _sppm().render(base, geometry=_moved(base))
    b = _sppm().render(base, geometry=base.triangles,
                       geometry_transform=MOTION)
    ref = _sppm().render(rebuilt)
    for f in ("ld", "tau", "radius", "n"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert float(ref.tau.sum()) > 0 and float(ref.ld.sum()) > 0
    np.testing.assert_allclose(a.ld.numpy(), ref.ld.numpy(), atol=ATOL)
    np.testing.assert_allclose(a.tau.numpy(), ref.tau.numpy(), atol=ATOL)


def _frame_entries(k):
    return [TL.point_light(C.transform_from_jax(
        JT.translate([0.5 * k, 8.0 + 0.5 * k, 4.0 - k])),
        (400.0 + 60.0 * k,) * 3)]


def _states_equal(a, b):
    return all(torch.equal(getattr(a, f.name), getattr(b, f.name))
               for f in fields(SPPMState))


@pytest.mark.parametrize("moving", [False, True])
def test_render_frames_matches_sequential_renders(scenes, moving):
    base = scenes["soup"][0]
    xfs = [C.transform_from_jax(JT.translate([0.1 * k, 0.0, 0.2 * k]))
           for k in range(2)]
    geom = dict(geometry=base.triangles, frame_transforms=xfs) if moving \
        else {}
    integ = _sppm(16)
    states = integ.render_frames(base, [_frame_entries(k) for k in range(2)],
                                 **geom)
    assert states.tau.shape[0] == 2
    for k in range(2):
        lights = TL.preprocess(TL.pack_lights(_frame_entries(k),
                                              base.triangles),
                               *base.bounding_sphere())
        st = integ.render(base.with_lights(lights), geometry=(
            base.triangles if moving else None), geometry_transform=(
            xfs[k] if moving else None))
        assert _states_equal(TCM._frame(states, k), st), k
    assert not torch.equal(states.tau[0], states.tau[1])


def _camera16(*_):
    return TMH.build_camera(16, "unused.png")


@pytest.mark.parametrize("motion", [None, "rise"])
def test_render_animation_batches_match_sequential(monkeypatch, tmp_path,
                                                   motion):
    monkeypatch.setattr(TCM, "build_scene",
                        lambda ply_path=None, device="cpu": _port_scene(
                            "soup"))
    monkeypatch.setattr(TCM, "build_camera", _camera16)
    monkeypatch.setattr(TCM, "frame_lights",
                        lambda s: _frame_entries(s))
    move = None if motion is None else (lambda s: C.transform_from_jax(
        JT.translate([0.0, 0.2 * s, 0.0])))

    def run(tag, **kw):
        return list(TCM.render_animation(
            resolution=16, frames=[0.0, 1.0, 2.0], iterations=2,
            photons_per_iteration=256, max_depth=2, motion=move,
            out_pattern=str(tmp_path / (tag + "-f{i}.png")),
            initial_search_radius=0.6, device="cpu", **kw))

    seq = run("seq")
    bat = run("bat", batch_frames=2)   # chunks of 2 + 1
    assert [i for i, _ in bat] == [i for i, _ in seq] == [1, 2, 3]
    for (_, a), (_, b) in zip(seq, bat):
        assert _states_equal(a, b)
    assert float(seq[0][1].ld.abs().max()) > 0
    assert (tmp_path / "bat-f3.png").exists()
    if motion is None:
        # A refit to the scene's own vertices changes nothing.
        for (_, a), (_, b) in zip(seq, run("refit", refit_each_frame=True)):
            assert _states_equal(a, b)
        with pytest.raises(ValueError):
            run("both", batch_frames=2, refit_each_frame=True)


@pytest.mark.parametrize("shift", [0.0, 0.7, 2.5])
def test_frame_lights_match_jax(shift):
    jscene = _jax_scene("small", JT.identity())
    tscene = _port_scene("small")
    np.testing.assert_array_equal(jscene.world_lo, tscene.world_lo)
    np.testing.assert_array_equal(jscene.world_hi, tscene.world_hi)
    JCM.set_frame_lights(jscene, shift)
    rows = tscene.light_rows
    assert TCM.set_frame_lights(tscene, shift) is tscene
    for f in ("kind", "p", "i", "direction", "w2l", "l2w",
              "cos_total_width", "cos_falloff_start", "tri_start",
              "tri_count", "two_sided"):
        np.testing.assert_array_equal(np.asarray(getattr(jscene.lights, f)),
                                      getattr(tscene.lights, f), err_msg=f)
    # The derived tables follow the swap.
    assert tscene.light_rows.shape[0] == 2 and rows.shape[0] == 1
    assert tscene.max_area_tris == 0 and tscene.area_tables == {}


def test_relit_scene_renders_as_one_built_with_the_frame_lights():
    relit = TCM.set_frame_lights(_port_scene("small"), 0.4)
    built = _port_scene("small", lights=TCM.frame_lights(0.4))
    np.testing.assert_array_equal(_render("whitted", relit),
                                  _render("whitted", built))


def test_area_light_follows_the_geometry():
    # An emissive quad over the soup: the area light's sampling tables are
    # rebuilt from the moved triangles in each frame's view.
    def build(xf):
        idx, verts = _mesh("soup")
        b = SceneBuilder()
        matte = b.material(TMat.MatteMaterial())
        b.triangle_mesh(xf, idx, verts, matte)
        quad = np.array([[-3, 6, -3], [3, 6, -3], [3, 6, 3], [-3, 6, 3]],
                        np.float32)
        b.triangle_mesh(xf, np.array([[0, 2, 1], [0, 3, 2]]), quad, matte,
                        emission=(8.0, 8.0, 8.0), two_sided=True)
        return b.build(device="cpu")

    base, rebuilt = build(C.transform_from_jax(JT.identity())), build(MOTION)
    img = _render("path", base, res=16, geometry=_moved(base))
    ref = _render("path", rebuilt, res=16)
    assert ref.max() > 0.01 and base.area_tables == {}
    np.testing.assert_allclose(img, ref, atol=ATOL)


def test_value_errors(scenes):
    base = scenes["soup"][0]
    integ = WhittedIntegrator(TMH.build_camera(8, "unused.png"),
                              UniformSampler(1, seed=0), max_depth=1)
    with pytest.raises(ValueError, match="requires geometry"):
        integ.render(base, geometry_transform=MOTION)
    with pytest.raises(ValueError, match="requires geometry"):
        _sppm(8).render(base, geometry_transform=MOTION)
    with pytest.raises(ValueError, match="geometry_accel"):
        integ.render(base, geometry=base.triangles, geometry_transform=MOTION,
                     geometry_accel=base.accel)
    with pytest.raises(ValueError, match="topology"):
        integ.render(base, geometry=scenes["small"][0].triangles)
    with pytest.raises(ValueError, match="topology"):
        _sppm(8).render(base, geometry=scenes["small"][0].triangles)
    with pytest.raises(ValueError, match="frame transform"):
        _sppm(8).render_frames(base, [_frame_entries(0)],
                               geometry=base.triangles)
