"""The dryrun scene, whole, through the port's three integrators on the
CPU: __graft_entry__.py's _dryrun_scene (flat spheres and triangles, an
instanced mesh, instanced spheres; an area, a point and an environment
light), built by chip_smoke.py's dryrun_builder with the port's
SceneBuilder, against goldens that the JAX package rendered once on the
CPU with its single-chip integrators as _dryrun_body configures them
(pbrt camera, Lanczos filter; JAX renders this scene on its packed li)::

    import numpy as np, __graft_entry__ as GE, chip_smoke as CS
    import test_torch_lights_mixed
    from trace_tpu.integrators.whitted import WhittedIntegrator
    from trace_tpu.integrators.path import PathIntegrator
    from trace_tpu.integrators.sppm import SPPMIntegrator
    from trace_tpu.sampler.uniform import UniformSampler
    scene = GE._dryrun_scene().build()
    cam = GE._dryrun_camera("unused.png", 16)
    for name, cls in (("whitted", WhittedIntegrator),
                      ("path", PathIntegrator)):
        st = cls(cam, UniformSampler(1, seed=0), max_depth=2).render(scene)
        np.save(f"tests/goldens/dryrun16_{name}.npy",
                np.asarray(cam.film.to_image(st)))
    integ = SPPMIntegrator(cam, **CS.DRYRUN_SPPM)   # r 0.2, depth 2,
    np.save("tests/goldens/dryrun16_sppm.npy",      # 1 iteration,
            np.asarray(integ.to_image(integ.render(scene), 1)))  # 1024
    ns = test_torch_lights_mixed.jax_modules()
    scene = CS.dryrun_builder(ns, textured=True).build()
    cam = CS.dryrun_camera(ns, 32)
    st = WhittedIntegrator(cam, UniformSampler(1, seed=0),
                           max_depth=2).render(scene)
    np.save("tests/goldens/dryrun32_tex_whitted.npy",
            np.asarray(cam.film.to_image(st)))

The last is the scene with the floor's Kd a mip-mapped 16 x 16 image and
the red sphere's Kd a mix of two colours by a bilinear ramp. Gate: MSE <
5e-4 each. The SPPM golden (1024 photons at 16^2) moves a pixel by ~0.26
for each photon that lands elsewhere: photons leave the one-sided area
light from exactly its surface, and whether the panel's self-hit at t ~
1e-8 registers follows the last bit of the emitted direction, which
XLA's and torch's sin/cos round differently (ROADMAP C); one pixel
differs, MSE 2.7e-4.

Scenes of delta lights only keep their images bit for bit now that the
per-lane pick traces one shadow-ray call for every light: the
``delta_*`` goldens are this port's own renders made before that change
(the commit before it, unpacked with ``git archive``) by
``_delta_render`` below, and the images must stay within 1e-6 (they
stay exact: 0 pixels differ). sphere_field (n = 6: a distant and a point
light, instanced spheres) and caustic_moving's first frame lights (a
point and a spot) around chip_smoke.py's glass stand-in at 24 x 12
(530 triangles: the sweep's plain version), each through the path tracer
and SPPM (2 iterations).
"""
import os

import numpy as np
import pytest
import torch

import chip_smoke as CS
from torch_jax_arrays import jax_rules, mse
from trace_tpu_torch.models import caustic_glass, caustic_moving, sphere_field
from trace_tpu_torch.integrators.path import PathIntegrator
from trace_tpu_torch.integrators.sppm import SPPMIntegrator
from trace_tpu_torch.integrators.whitted import WhittedIntegrator
from trace_tpu_torch.materials import textures as TX
from trace_tpu_torch.sampler.uniform import UniformSampler

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
MSE_GATE = 5e-4


def _render(name: str) -> np.ndarray:
    ns = CS.port_modules()
    textured = name == "dryrun32_tex_whitted"
    scene = CS.dryrun_builder(ns, textured=textured).build(device="cpu")
    cam = CS.dryrun_camera(ns, 32 if textured else 16)
    if name.endswith("sppm"):
        integ = SPPMIntegrator(cam, device="cpu", **CS.DRYRUN_SPPM)
        return integ.to_image(integ.render(scene), 1).numpy()
    cls = PathIntegrator if name.endswith("path") else WhittedIntegrator
    integ = cls(cam, UniformSampler(1, seed=0), max_depth=2)
    img = cam.film.to_image(integ.render(scene)).numpy()
    if textured:
        mips = [t.mip for m in scene.materials for tex in m.textures()
                for t in TX.walk(tex) if isinstance(t, TX.ImageTexture)]
        assert len(mips) == 1 and "cpu" in mips[0]._device_tables
    return img


@pytest.mark.parametrize("name", sorted(CS.DRYRUN_GOLDENS))
def test_dryrun_golden(name):
    img = _render(name)
    ref = np.load(CS.DRYRUN_GOLDENS[name])
    err = mse(img, ref)
    diff = np.abs(img - ref).max(-1)
    worst = np.unravel_index(int(np.argmax(diff)), diff.shape)
    print(f"{name}: MSE {err:.3e}, pixels off by > 1e-3: "
          f"{int((diff > 1e-3).sum())}, the worst {worst}: port "
          f"{img[worst].tolist()}, golden {ref[worst].tolist()}")
    assert img.shape == ref.shape and np.isfinite(img).all()
    assert err < MSE_GATE
    assert (ref.max(-1) > 1e-3).mean() > 0.5


def test_texture_lookup_card_contract_on_cpu():
    """chip_smoke.py's texture check (card against CPU) runs its lanes
    through the same function here, CPU against CPU: no lane differs."""
    a = CS.texture_lanes(torch.device("cpu"), 4096)
    b = CS.texture_lanes(torch.device("cpu"), 4096)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[1].unique().numel() > 2


def _delta_render(name: str) -> np.ndarray:
    if name.startswith("delta_sphere_field6"):
        scene = sphere_field.build_scene(n=6, device="cpu")
        cam = sphere_field.build_camera(32, "unused.png")
        path = dict(spp=2, depth=3)
        sppm = dict(initial_search_radius=0.3, max_depth=3,
                    photons_per_iteration=2048)
    else:
        scene = caustic_glass.scene_around(CS.glass_standin(24, 12), "cpu")
        caustic_moving.set_frame_lights(scene, 0.1)
        cam = caustic_glass.build_camera(16, "unused.png", showcase=True)
        path = dict(spp=1, depth=3)
        sppm = dict(initial_search_radius=0.055, max_depth=3,
                    photons_per_iteration=1024)
    if "_path" in name:
        integ = PathIntegrator(cam, UniformSampler(path["spp"], seed=1),
                               max_depth=path["depth"])
        return cam.film.to_image(integ.render(scene)).numpy()
    integ = SPPMIntegrator(cam, n_iterations=2, device="cpu", **sppm)
    return integ.to_image(integ.render(scene), 2).numpy()


DELTA = ["delta_sphere_field6_path32", "delta_sphere_field6_sppm32",
         "delta_standin_path16", "delta_standin_sppm16"]


@pytest.mark.parametrize("name", DELTA)
def test_delta_light_scenes_unchanged(name):
    # The goldens predate the port's own spawn and sphere rules.
    with jax_rules():
        img = _delta_render(name)
    ref = np.load(os.path.join(GOLDENS, f"{name}.npy"))
    diff = np.abs(img - ref)
    print(f"{name}: max abs {diff.max():.3e}, pixels that differ "
          f"{int((diff.max(-1) > 0).sum())}")
    assert img.shape == ref.shape and diff.max() <= 1e-6
    assert ref.max() > 0.01


@pytest.mark.parametrize("name", DELTA)
def test_delta_light_scenes_on_the_port_rules(name):
    """The same scenes on the port's own rules, the route the program
    takes (the SPPM walks' and, from the path tracer's repair, the path
    continuations' normal-offset spawn, the sphere's non-cancelling
    discriminant), against goldens rendered on those rules
    (``<name>_port.npy``; the two path goldens rendered again with the
    path tracer's repair)."""
    img = _delta_render(name)
    ref = np.load(os.path.join(GOLDENS, f"{name}_port.npy"))
    diff = np.abs(img - ref)
    assert img.shape == ref.shape and diff.max() <= 1e-6
    assert ref.max() > 0.01
