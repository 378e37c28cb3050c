"""``correct`` at a size a CPU test can hold: a sound run passes where the
reference agrees, and the control (the sweep's bf16 panel) and each fault
planted under the timed path (a step that returns its state unchanged,
half of the batch left out, an answer altered where it is produced) come
out not correct, through the harness's whole run without the look for a
card. The SPPM driver, whose cells wait on a fault of the program and
have no limits yet, is run for its numbers alone."""
import copy
import math
import os
import time

import pytest
import torch

from perfbench import control, harness

ROOT = os.path.dirname(harness.HERE)
# CPU sizes; SPPM's radius is widened so that a 32x32 film's visible
# points gather photons at all.
SIZES = {"mesh1m_whitted_256": dict(tris=20000, resolution=64),
         "iterations_1024_fused": dict(tris=2000, resolution=32,
                                       photons=32768, radius=0.25),
         "iterations_1024_stepwise": dict(tris=2000, resolution=32,
                                          photons=32768, radius=0.25)}
CELLS = [c for c in SIZES
         if c in {w["name"] for w in harness.CellSpec(
             ROOT, "mesh1m_whitted_256").bench["workloads"]}]
SPPM_LIMITS = {"ld_gap": math.inf, "tau_gap": math.inf, "r_gap": math.inf,
               "m_gap": math.inf, "sample_pixels": 1024}


def shrink(spec, size):
    spec.config = copy.deepcopy(spec.config)
    spec.config["scene"]["heightfield_tris"] = size["tris"]
    if "photons" in size:
        args = spec.config["integrator_args"]
        args["photons_per_iteration"] = size["photons"]
        args["initial_search_radius"] = size["radius"]
    spec.traffic = dict(spec.traffic, resolution=size["resolution"])
    return spec


def small_spec(name):
    return shrink(harness.CellSpec(ROOT, name), SIZES[name])


def sppm_spec(traffic):
    """An SPPM cell of the mesh1m_sppm configuration that BENCHMARK.json
    does not hold: no metrics, limits that pass any number."""
    spec = object.__new__(harness.CellSpec)
    spec.bench = {"end_to_end": [], "per_layer": []}
    spec.name = traffic
    spec.config = harness.load_json(
        os.path.join(harness.HERE, "configs", "mesh1m_sppm.json"))
    spec.traffic = harness.load_json(
        os.path.join(harness.HERE, "traffic", traffic + ".json"))
    spec.limits = dict(SPPM_LIMITS)
    return shrink(spec, SIZES[traffic])


def run(spec, cell=None, seed=2 ** 31 + 11):
    result, checks, _ = harness.run(spec, seed, 0.0, False, "cpu",
                                    time.perf_counter(), cell=cell)
    return result


def cell_of(spec, seed=2 ** 31 + 11, **kw):
    return spec.driver().Cell(spec.config, spec.traffic, seed, "cpu", **kw)


def unchanged(cell):
    """Every step hands back the state it was given (the film's empty
    state for a frame)."""
    integ = cell.integ
    if hasattr(integ, "pixel_grid"):       # Whitted: a frame's film
        integ.render = lambda scene, **k: integ.camera.film.initial_state(
            "cpu")
    else:
        from trace_tpu_torch.integrators.sppm import initial_state

        integ.render = lambda scene, state=None, **k: (
            state if state is not None else initial_state(
                integ.n_pixels, integ.initial_search_radius, "cpu"))


def half_left_out(cell):
    """Half of the lanes (Whitted) or photons (SPPM) never reach the
    output, and the mean is taken over the rest: the film normalises by
    the weights left, the photons left count twice."""
    integ = cell.integ
    if hasattr(integ, "pixel_grid"):
        sample = integ.sample

        def halved(*a, **k):
            p, l, w, aux = sample(*a, **k)
            keep = torch.arange(w.shape[0]) % 2 == 0
            return p, l, torch.where(keep, w, 0.0), aux
        integ.sample = halved
    else:
        walk = integ._photon_walk_all

        def halved(*a, **k):
            rec = walk(*a, **k)
            odd = torch.arange(rec["count"].shape[0]) % 2 == 1
            rec["count"] = torch.where(odd, 0, rec["count"])
            rec["beta"] = torch.where(odd[:, None], 0.0, 2.0 * rec["beta"])
            return rec
        integ._photon_walk_all = halved


def altered(cell):
    """One lane (Whitted) or pixel (SPPM) in 8 has its answer doubled where
    it is produced."""
    integ = cell.integ
    if hasattr(integ, "pixel_grid"):
        li = integ.li

        def scaled(scene, rd, key):
            l, aux = li(scene, rd, key)
            hit = (torch.arange(l.shape[0]) % 8 == 0)[:, None]
            return torch.where(hit, l * 2.0, l), aux
        integ.li = scaled
    else:
        cam = integ._camera_pass_all

        def scaled(*a, **k):
            ld, vp = cam(*a, **k)
            hit = (torch.arange(ld.shape[0]) % 8 == 0)[:, None]
            return torch.where(hit, ld * 2.0, ld), vp
        integ._camera_pass_all = scaled


class Faulty:
    """A driver cell whose program is broken by ``fault`` after set-up's
    scene and integrator exist, before its warm steps."""

    def __new__(cls, spec, fault):
        cell = cell_of(spec)
        steps = int(spec.traffic["warm_steps"])
        spec.traffic = dict(spec.traffic, warm_steps=0)
        cell.traffic = spec.traffic
        setup = cell.setup

        def broken_setup():
            setup()
            fault(cell)
            for _ in range(max(steps, 2)):
                cell.step()
        cell.setup = broken_setup
        return cell


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    spec = small_spec(name)
    r = run(spec)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    spec = small_spec(name)
    r = run(spec, cell_of(spec, control=control.panel_bf16))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    spec = small_spec(name)
    r = run(spec, Faulty(spec, fault))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("traffic", ["iterations_1024_fused",
                                     "iterations_1024_stepwise"])
def test_sppm_numbers(traffic):
    """Every number of the SPPM check is read; a state left unchanged
    reads 1 on each, a sound run less."""
    sound = run(sppm_spec(traffic))["checks"]
    spec = sppm_spec(traffic)
    stuck = run(spec, Faulty(spec, unchanged))["checks"]
    assert set(sound) == set(stuck) == {"ld_gap", "tau_gap", "r_gap",
                                        "m_gap"}
    for name in sound:
        assert sound[name]["value"] < 0.9, (name, sound)
        assert stuck[name]["value"] == pytest.approx(1.0), (name, stuck)
