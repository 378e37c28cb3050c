"""The port's SPPM slice: whole renders against the JAX package's jitted
renders, the committed goldens, chunk invariance, and resume.

Settings (the goldens, and chip_smoke.py phase 6a on the card):
- ``mesh5k``: mesh_heavy(target_tris=5000) through the sweep, 32^2, 2
  iterations, 16384 photons, depth 8, initial radius 1.0, seed 0 (config
  3's radius 0.075 gathers no photon at 32^2: a pixel spans about a unit
  of terrain) -> tests/goldens/sppm_mesh5k_32.npy;
- ``shadows``: the shadows scene (brute-force triangles), 16^2, 2
  iterations, 1024 photons, depth 4, radius 0.25, seed 1 ->
  tests/goldens/sppm_shadows16.npy.

Gates: images by the repo's MSE gate (< 5e-4) against the jitted JAX
render (which parts from op-by-op JAX on the camera rays' last bit on
half the lanes, ROADMAP C; the port follows op-by-op JAX,
test_torch_sppm.py); a golden equals the JAX render made in the same test
to 1e-5; chunk settings change only the association of the pair sums
(rtol 1e-5); resume and reruns are bit-exact. One port render per case at
its default settings (the ``port_renders`` fixture) serves the render,
chunk and resume tests; the rerun that must repeat it is a render of its
own. Fused blocks (``fused_iterations``; the ``fused_renders`` fixture,
each run once) equal ``port_renders`` bit for bit and meet the same gate
against the jitted JAX render; they run pair chunks of 4096 (a fused block
runs whole chunks, and on the CPU the pair sums do not depend on the
chunking: the deterministic scatter adds the pairs in pair order).
"""
import os

import numpy as np
import pytest
import torch

from torch_jax_arrays import mse, port_scene
from trace_tpu.integrators.sppm import SPPMIntegrator as JSPPM
from trace_tpu.models import mesh_heavy as JMH
from trace_tpu.models import spheres as JSph
from trace_tpu.utils import checkpoint as JCk
from trace_tpu_torch import convert as C
from trace_tpu_torch.integrators.sppm import SPPMIntegrator
from trace_tpu_torch.models import mesh_heavy as TMH
from trace_tpu_torch.models import spheres as TSph
from trace_tpu_torch.ops import sweep as TS
from trace_tpu_torch.utils import checkpoint as TCk
from trace_tpu_torch.utils.stats import RenderStats

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
MSE_GATE = 5e-4
CASES = {
    "mesh5k": dict(res=32, golden="sppm_mesh5k_32.npy", pixel_chunk=1000,
                   kw=dict(initial_search_radius=1.0, max_depth=8,
                           n_iterations=2, photons_per_iteration=16384,
                           seed=0)),
    "shadows": dict(res=16, golden="sppm_shadows16.npy", pixel_chunk=100,
                    kw=dict(initial_search_radius=0.25, max_depth=4,
                            n_iterations=2, photons_per_iteration=1024,
                            seed=1)),
}


def _mods(name):
    return (JMH, TMH) if name == "mesh5k" else (JSph, TSph)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Per case: the jitted JAX render (2 iterations, as 1 + a resumed
    1), its image, and a JAX checkpoint of iteration 1."""
    out = {}
    for name, case in CASES.items():
        jm = _mods(name)[0]
        js = (jm.build_scene(target_tris=5000) if name == "mesh5k"
              else jm.build_scene())
        integ = JSPPM(jm.build_camera(case["res"], "unused.png"),
                      **case["kw"])
        st1 = integ.render(js, n_iterations=1)
        path = str(tmp_path_factory.mktemp("jax") / f"{name}_it1.npz")
        JCk.save_pytree(path, st1, metadata={"iteration": 1})
        st2 = integ.render(js, state=st1, start_iteration=2)
        out[name] = dict(scene=js, state=st2, ckpt=path,
                         img=np.asarray(integ.to_image(st2, 2)))
    return out


@pytest.fixture(scope="module")
def port_scenes():
    return {"mesh5k": TMH.build_scene(5000, device="cpu"),
            "shadows": TSph.build_scene(device="cpu")}


def _port(name, **over):
    case = CASES[name]
    kw = dict(case["kw"], **over)
    cam = _mods(name)[1].build_camera(case["res"], "unused.png")
    return SPPMIntegrator(cam, device="cpu", **kw)


def _render(name, scene, **over):
    integ = _port(name, **over)
    state = integ.render(scene)
    return integ, state, integ.to_image(state, 2).numpy()


@pytest.fixture(scope="module")
def port_renders(port_scenes):
    """Per case, one port render at the case's settings, with stats: the
    render test's, the chunk test's reference and the resume test's full
    run (each a fresh render with the same inputs before)."""
    out = {}
    for name in CASES:
        stats = RenderStats()
        integ, state, img = _render(name, port_scenes[name], stats=stats)
        out[name] = dict(state=state, img=img, stats=stats.as_dict())
    return out


# (case, fused_block, fused_unroll): mesh5k's two iterations in one
# block, unrolled; shadows' in blocks of one and of two.
FUSED = [("mesh5k", 2, True), ("shadows", 1, False), ("shadows", 2, False)]


@pytest.fixture(scope="module")
def fused_renders(port_scenes):
    out = {}
    for name, block, unroll in FUSED:
        integ, state, img = _render(name, port_scenes[name],
                                    fused_iterations=True, fused_block=block,
                                    fused_unroll=unroll, pair_chunk=4096)
        out[name, block] = dict(state=state, img=img,
                                totals=integ.last_pair_totals)
    return out


def _fields_equal(a, b):
    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("ld", "tau", "radius", "n", "phi", "m"))


@pytest.mark.parametrize("name", list(CASES))
def test_render_matches_jitted_jax(jax_runs, port_renders, name):
    launches = TS.sweep_kernel.launches
    run = port_renders[name]
    state, img, stats = run["state"], run["img"], run["stats"]
    assert TS.sweep_kernel.launches == launches   # CPU: the plain version
    jimg = jax_runs[name]["img"]
    m = mse(img, jimg)
    gathered = int((state.tau.sum(-1) > 0).sum())
    print(f"{name}: MSE {m:.3e}, max abs {np.abs(img - jimg).max():.4f}, "
          f"pixels with tau > 0: {gathered} (JAX "
          f"{int((np.asarray(jax_runs[name]['state'].tau).sum(-1) > 0).sum())}"
          f"), stats {stats}")
    assert img.shape == jimg.shape and np.isfinite(img).all()
    assert gathered > 0 and stats["photon_vp_pairs"] > 0
    assert m < MSE_GATE


@pytest.mark.parametrize("name", list(CASES))
def test_golden_equals_live_jax(jax_runs, name):
    golden = np.load(os.path.join(GOLDENS, CASES[name]["golden"]))
    # Same call, same package; only XLA's code generation for another host
    # CPU could move the last bits.
    np.testing.assert_allclose(jax_runs[name]["img"], golden, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_chunk_settings_change_only_association(port_scenes, port_renders,
                                                name):
    a, img_a = port_renders[name]["state"], port_renders[name]["img"]
    _, b, img_b = _render(name, port_scenes[name],
                          pixel_chunk=CASES[name]["pixel_chunk"],
                          pair_chunk=333)
    np.testing.assert_array_equal(a.m.numpy(), b.m.numpy())
    np.testing.assert_array_equal(a.n.numpy(), b.n.numpy())
    np.testing.assert_allclose(b.ld.numpy(), a.ld.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(img_b, img_a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_resume_is_bit_exact_and_reruns_repeat(port_scenes, port_renders,
                                               name, tmp_path):
    scene = port_scenes[name]
    full = port_renders[name]["state"]
    _, again, _ = _render(name, scene)
    assert _fields_equal(full, again)
    integ = _port(name)
    path = str(tmp_path / "state.npz")
    st1 = integ.render(scene, n_iterations=1, checkpoint_path=path)
    assert int(TCk.load_metadata(path)["iteration"]) == 1
    loaded = TCk.load_pytree(path, st1)
    assert _fields_equal(loaded, st1)
    resumed = integ.render(scene, state=loaded, start_iteration=2)
    assert _fields_equal(resumed, full)
    assert _fields_equal(loaded, st1)   # resuming left its input as it was


@pytest.mark.parametrize("name", list(CASES))
def test_jax_checkpoint_resumes_in_the_port(jax_runs, port_scenes, name):
    """Iteration 1 from the JAX package's checkpoint, iteration 2 in the
    port, against JAX's two iterations."""
    jr = jax_runs[name]
    integ = _port(name)
    st1 = C.sppm_state_from_numpy(jr["ckpt"], "cpu")
    st2 = integ.render(port_scenes[name], state=st1, start_iteration=2)
    img = integ.to_image(st2, 2).numpy()
    m = mse(img, jr["img"])
    print(f"{name}: JAX iteration 1 + port iteration 2 vs JAX: MSE {m:.3e}")
    assert m < MSE_GATE
    # Iteration 1's radii carried across and shrank where photons landed.
    r1 = st1.radius.numpy()
    assert (r1 < CASES[name]["kw"]["initial_search_radius"]).any()
    assert (st2.radius.numpy() <= r1).all()


def test_sweep_scene_of_the_jax_package_renders_alike(jax_runs):
    """The JAX scene carried across (convert.scene_from_numpy) renders as
    the port's own build of it."""
    ported = port_scene(jax_runs["mesh5k"]["scene"])
    own = TMH.build_scene(5000, device="cpu")
    _, a, _ = _render("mesh5k", ported, n_iterations=1)
    _, b, _ = _render("mesh5k", own, n_iterations=1)
    assert _fields_equal(a, b)


@pytest.mark.parametrize("name,block,unroll", FUSED)
def test_fused_blocks_equal_stepwise(port_renders, fused_renders, name,
                                     block, unroll):
    run = fused_renders[name, block]
    assert _fields_equal(run["state"], port_renders[name]["state"])
    assert run["totals"].shape == (block,) and int(run["totals"][-1]) > 0


@pytest.mark.parametrize("name,block,unroll", FUSED)
def test_fused_blocks_match_jitted_jax(jax_runs, fused_renders, name, block,
                                       unroll):
    img = fused_renders[name, block]["img"]
    assert np.isfinite(img).all()
    assert mse(img, jax_runs[name]["img"]) < MSE_GATE
