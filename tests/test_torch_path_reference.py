"""The port's path tracer against the benchmark's float64 reference
(perfbench/reference/path.py), on the CPU.

- The ``cornell_mis_512`` cell's box at 24x24, 2 spp, depth 5, on three
  seeds: ``PathIntegrator.render`` and the reference draw the same
  numbers, so their films differ by float32 rounding alone; each number
  of ``film_checks`` sits far inside the cell's limits and inside the
  tolerances below.
- Planted faults and the control each come out not correct under the
  cell's limits: the balance heuristic in place of the power heuristic,
  the BSDF-sampling MIS leg dropped, roulette without its 1 / (1 - q)
  reweight, and the bf16 directions of perfbench/control_path.py.
- The continuation's spawn: the JAX package's rule (1e-6 along wi)
  re-meets the primitive it left on the box, the port's does not, and
  only the port's agrees with the reference.
- The driver's box (perfbench/scenes/box.py) is models/cornell.py's,
  table for table, and so is its camera; the reference's frames are the
  program's.
- The cell's own files run through the harness at 16x16, in a fresh
  process that loads neither JAX nor the JAX package.
"""
import ast
import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import control_path, harness
from perfbench.drivers import scene as DS
from perfbench.reference import box as RB
from perfbench.reference import compare
from perfbench.reference import film as FILM
from perfbench.reference import path as ref
from perfbench.scenes import box as SB
from torch_jax_arrays import spawn_along
from trace_tpu_torch.core.vec import V3
from trace_tpu_torch.models import cornell
from trace_tpu_torch.utils.stats import RenderStats
from trace_tpu_torch.wavefront import path as WP

ROOT = os.path.dirname(harness.HERE)
CELL = "cornell_mis_512"
RES, SPP = 24, 2
SEEDS = [3, 2 ** 31 + 17, 4_000_000_007]
# Float32 against float64 on the same draws: the paths agree, and the
# films differ by float32's rounding of the hit points, frames and
# throughputs, 4e-6 to 9e-6 of the image's RMS here (on the CPU). 1e-4
# leaves ten times that; a path that takes another turn moves a pixel of
# 2 spp by tens of percent, which shows as a bad pixel at 1e-3 of the
# mean luminance.
IMG_REL_RMS = 1e-4
BAD_PX_TOL = 1e-3


def spec_at(res=RES, spp=SPP):
    spec = harness.CellSpec(ROOT, CELL)
    spec.config = json.loads(json.dumps(spec.config))
    spec.config["integrator_args"]["spp"] = spp
    spec.traffic = dict(spec.traffic, resolution=res, warm_steps=0)
    return spec


def render(seed, control=None, fault=None):
    """The port's film and the reference's for ``seed``: the driver cell
    set up (with ``control``), one frame (inside ``fault``, a context
    manager)."""
    spec = spec_at()
    cell = spec.driver().Cell(spec.config, spec.traffic, seed, "cpu",
                              control=control)
    cell.setup()
    with fault or contextlib.nullcontext():
        cell.step()
    got = cell.output()
    cell.release()
    want, mask = ref.render(spec.config["scene"], RES, seed, cell.args,
                            "cpu")
    return got, want, mask, spec.limits


def checks(got, want, mask, limits):
    return {n: (v, lim) for n, v, lim in ref.checks(got, want, mask,
                                                    limits)}


@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_the_reference(seed):
    got, want, mask, limits = render(seed)
    cell = checks(got, want, mask, limits)
    assert all(v <= lim for v, lim in cell.values()), cell
    # No camera lane of this small frame lies on the light's outline.
    assert not mask.any()
    tight = checks(got, want, mask, dict(limits, bad_px_tol=BAD_PX_TOL))
    assert tight["img_rel_rms"][0] < IMG_REL_RMS, tight
    assert tight["bad_px"][0] == 0.0, tight
    # Both films hold light, and the same filter weights.
    assert compare.normalized(*want)[..., 1].mean() > 0.05
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


class patched:
    """Module attributes replaced for a block."""

    def __init__(self, mod, **attrs):
        self.mod, self.attrs = mod, attrs

    def __enter__(self):
        self.saved = {k: getattr(self.mod, k) for k in self.attrs}
        for k, v in self.attrs.items():
            setattr(self.mod, k, v)
        return self

    def __exit__(self, *a):
        for k, v in self.saved.items():
            setattr(self.mod, k, v)
        return False


def _balance(nf, f_pdf, ng, g_pdf):
    f, g = nf * f_pdf, ng * g_pdf
    return torch.where(f + g > 0, f / (f + g), 0.0)


def _no_reweight(beta, u):
    return beta, u < (1.0 - WP.to_y(beta)).clamp_min(0.05)


FAULTS = {
    "balance_heuristic": patched(WP, power_heuristic=_balance),
    "mis_leg_dropped": patched(WP, has_mis_leg=lambda scene: False),
    "roulette_unweighted": patched(WP, russian_roulette=_no_reweight),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_is_not_correct(fault):
    c = checks(*render(SEEDS[0], fault=FAULTS[fault]))
    assert any(v > lim for v, lim in c.values()), (fault, c)


@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(seed):
    c = checks(*render(seed, control=control_path.wi_bf16))
    assert all(v > lim for v, lim in c.values()), c
    # The control undoes itself with the cell.
    from trace_tpu_torch.wavefront import shade as S
    assert S.sample_f.__name__ == "sample_f"


def test_jax_spawn_rehits_and_misses_the_reference():
    """The JAX package's continuation (1e-6 along wi) re-meets the
    primitive it left on some lanes of the box; those paths leave the
    reference's, which the port's rule (core/ray.py::spawn) does not."""
    seed = 5
    spec = spec_at(spp=4)
    reads = {}
    for rule, li in (("port", WP.li),
                     ("jax", functools.partial(WP.li, spawn=spawn_along))):
        cell = spec.driver().Cell(spec.config, spec.traffic, seed, "cpu")
        cell.setup()
        cell.integ.stats = RenderStats()
        with patched(WP, li=li):
            cell.step()
        got = cell.output()
        want, mask = ref.render(spec.config["scene"], RES, seed, cell.args,
                                "cpu")
        reads[rule] = (cell.integ.stats.as_dict()["path_self_hits"],
                       checks(got, want, mask, dict(spec.limits,
                                                    bad_px_tol=BAD_PX_TOL)))
    assert reads["port"][0] == 0 and reads["jax"][0] > 0, reads
    assert reads["port"][1]["bad_px"][0] == 0.0, reads
    assert reads["jax"][1]["bad_px"][0] > 0.0, reads


def test_ambiguous_lanes_are_the_lights_outline():
    """A camera ray aimed at the light panel's edge is marked, one aimed
    10^-4 inside or outside it, or at its middle, is not; the mask holds
    the pixels its film point splats into."""
    desc = harness.CellSpec(ROOT, CELL).config["scene"]
    bx = RB.Box(desc, "cpu")
    eye = torch.tensor(desc["camera"]["position"], dtype=torch.float64)
    aims = torch.tensor([[0.35, 0.98, 0.0], [0.35 - 1e-4, 0.98, 0.0],
                         [0.35 + 1e-4, 0.98, 0.0], [0.0, 0.98, 0.1],
                         [0.1, -0.2, -1.0]], dtype=torch.float64)
    d = torch.nn.functional.normalize(aims - eye, dim=1)
    o = eye.expand_as(d).clone()
    got = ref.ambiguous(bx, o, d).tolist()
    assert got == [True, False, False, False, False]
    assert ref.emitting(bx, o, d).tolist()[1:4] == [True, False, True]
    p = np.array([[10.25, 20.5], [1.2, 31.9]], np.float32)
    mask = ref.footprint_mask(p, 32, (1.0, 1.0))
    _, wsum = FILM.splat(p, np.ones((2, 3)), (32, 32), (1.0, 1.0), 3.0)
    assert (mask >= (wsum != 0)).all() and 0 < mask.sum() <= 2 * 16


def _material_params(m):
    return {k: np.asarray(v.value) for k, v in vars(m).items()
            if hasattr(v, "value")} | {
        k: v for k, v in vars(m).items() if isinstance(v, bool)}


def test_driver_box_is_the_models_box():
    desc = harness.CellSpec(ROOT, CELL).config["scene"]
    ours = SB.build_scene(desc, "cpu")
    theirs = cornell.build_scene(device="cpu")
    for table in ("triangles", "spheres", "lights"):
        a, b = getattr(ours, table), getattr(theirs, table)
        assert type(a) is type(b), table
        fields = (a._fields if hasattr(a, "_fields")
                  else list(dataclasses.asdict(a)))
        for field in fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, field)), np.asarray(getattr(b, field)),
                err_msg=f"{table}.{field}")
    assert torch.equal(ours.tri_light_id, theirs.tri_light_id)
    assert [type(m) for m in ours.materials] == [type(m) for m in
                                                 theirs.materials]
    for m0, m1 in zip(ours.materials, theirs.materials):
        p0, p1 = _material_params(m0), _material_params(m1)
        assert p0.keys() == p1.keys()
        for k in p0:
            np.testing.assert_array_equal(p0[k], p1[k])
    assert ours.accel is None and theirs.accel is None
    # The camera: the same rays from the same film points.
    cams = (DS.build_camera(desc, 32), cornell.build_camera(32, "unused"))
    g = torch.Generator().manual_seed(0)
    p_film = torch.rand((64, 2), generator=g) * 34
    u = torch.rand((64, 3), generator=g)
    rays = [c.generate_ray_differentials(p_film, u[:, :2], u[:, 2])[0]
            for c in cams]
    for f in ("o", "d", "rx_direction", "ry_direction"):
        assert torch.equal(getattr(rays[0], f), getattr(rays[1], f)), f


def test_reference_frames_are_the_programs():
    """box.py's hits, normals and shading frames agree with the port's
    closest-hit records and lobe frames on the same rays."""
    from trace_tpu_torch.wavefront import geom as G
    from trace_tpu_torch.wavefront import materials as WM
    from trace_tpu_torch.wavefront import shade as S
    from trace_tpu_torch.wavefront import whitted as WW

    desc = harness.CellSpec(ROOT, CELL).config["scene"]
    scene = SB.build_scene(desc, "cpu")
    bx = RB.Box(desc, "cpu")
    g = torch.Generator().manual_seed(1)
    n = 512
    o = (torch.rand((n, 3), generator=g) * 1.6 - 0.8)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=1)
    hit = WW.closest_hit(scene, V3.of(o), V3.of(d),
                         torch.full((n,), float("inf")), torch.zeros(n))
    lobes = WM.compute_scattering(scene.materials, hit,
                                  allow_multiple_lobes=True)
    t, prim = bx.closest(o.double(), d.double())
    ok = hit.valid.numpy()
    assert ok.mean() > 0.7   # the box is open toward +z
    # Triangles come after the spheres in the program's primitive ids.
    ns = scene.n_spheres
    pid = hit.prim_id.long()
    mine = torch.where(pid >= ns, pid - ns, pid + bx.n_tris)
    assert torch.equal(mine[ok], prim[ok])
    np.testing.assert_allclose(hit.t[ok], t[ok], rtol=1e-5, atol=1e-6)
    p = o.double() + d.double() * t[:, None]
    frame = bx.frame(prim.clamp_min(0), p)
    for got, want in zip((lobes.ns, lobes.ss, lobes.ts), frame):
        np.testing.assert_allclose(got.arr()[ok], want[ok], atol=2e-5)
    np.testing.assert_allclose(hit.n.arr()[ok], frame[0][ok], atol=2e-5)
    assert isinstance(lobes, S.LobesP) and isinstance(hit, G.HitP)


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for name in ("path.py", "box.py"):
        for mod in _imports(os.path.join(harness.HERE, "reference", name)):
            assert mod.split(".")[0] not in (
                "trace_tpu_torch", "trace_tpu", "jax", "jaxlib", "flax",
                "perfbench"), (name, mod)
    code = ("import sys; sys.path.insert(0, '.');"
            "import perfbench.reference.path, perfbench.reference.box;"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('trace_tpu_torch', 'trace_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


CHILD = """
import json, sys, time
sys.path.insert(0, ".")
from perfbench import harness
spec = harness.CellSpec(".", "cornell_mis_512")
spec.traffic = dict(spec.traffic, resolution=16, warm_steps=1)
r, checks, found = harness.run(spec, 2**31 + 7, 0.2, bool(int(sys.argv[1])),
                               "cpu", time.perf_counter())
r["forbidden_modules"] = found
r["late_forbidden"] = harness.forbidden_modules(sys.modules)
print(json.dumps(r))
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_dry(trace):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", CHILD, str(trace)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["attempted"] >= 1
    assert set(r["checks"]) == {"img_rel_rms", "bad_px"}
    want = ({"step_ms", "step_p90_ms", "peak_device_gib", "setup_s"}
            if not trace else set())
    assert set(r["metrics"]) == want
    assert r["forbidden_modules"] == [] and r["late_forbidden"] == []


def test_phase_readers_sum_over_the_frames():
    from perfbench.metrics import path_direct_ms_per_step as PD
    from perfbench.metrics import path_li_ms_per_step as PL
    from perfbench.profiling import Trace

    tr = Trace([], [], [], n_steps=2)
    assert PL.read(tr) is None and PD.read(tr) is None
    tr.phase_ms = {"li": [1.0, 2.0, 3.0, 4.0] * 2, "direct": [0.5] * 40}
    assert PL.read(tr) == 10.0 and PD.read(tr) == 10.0
    assert spec_at().per_layer()
