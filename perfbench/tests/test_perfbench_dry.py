"""A cell added as new files only (a configuration, a traffic mix, a
limits file and BENCHMARK.json entries) runs the harness's dry path on
the CPU, in a fresh process, and leaves no module of JAX or of the JAX
package loaded; the reference imports nothing of the program."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

ROOT = os.path.dirname(harness.HERE)

DUMMY_CONFIG = {
    "name": "dummy_whitted", "integrator": "whitted",
    "integrator_args": {"max_depth": 2, "spp": 1}, "reduced": [],
}
DUMMY_TRAFFIC = {"name": "dummy_frames", "loop": "closed",
                 "resolution": 16, "integrator_args": {}, "warm_steps": 1,
                 "trace_steps": 1, "why": "a test cell"}
DUMMY_LIMITS = {"img_rel_rms": 0.2, "bad_px": 0.2, "bad_px_tol": 0.01}

CHILD = """
import json, sys
sys.path.insert(0, ".")
from perfbench import harness
r = harness.dry_run(".", "dummy_cell", 2**31 + 7, 0.2,
                    trace=bool(int(sys.argv[1])))
r["late_forbidden"] = harness.forbidden_modules(sys.modules)
r["has_port"] = "trace_tpu_torch" in sys.modules
print(json.dumps(r))
"""


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A checkout with the benchmark, the port, and one more cell added as
    files and entries."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(harness.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "trace_tpu_torch"), root / "trace_tpu_torch")
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    scene = harness.load_json(os.path.join(
        ROOT, "perfbench/configs/mesh1m_whitted.json"))["scene"]
    cfg = dict(DUMMY_CONFIG, scene=dict(scene, heightfield_tris=2000))
    (root / "perfbench/configs/dummy_whitted.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/dummy_frames.json").write_text(
        json.dumps(DUMMY_TRAFFIC))
    (root / "perfbench/limits/dummy_cell.json").write_text(
        json.dumps(DUMMY_LIMITS))
    bench["configs"].append({"name": "dummy_whitted", "source": "a test",
                             "file": "perfbench/configs/dummy_whitted.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy_cell", "config": "dummy_whitted",
                               "traffic": "dummy_frames", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "mesh1m_whitted_256" in m.get("workloads", ()):
            m["workloads"].append("dummy_cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_added_cell_runs_dry(checkout, trace):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", CHILD, str(trace)],
                         cwd=checkout, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["attempted"] >= 1
    assert set(r["checks"]) == {"img_rel_rms", "bad_px"}
    want = ({"step_ms", "step_p90_ms", "peak_device_gib", "setup_s"}
            if not trace else set())
    assert set(r["metrics"]) == want
    assert ("host" in r) == (not trace)
    assert r["forbidden_modules"] == [] and r["late_forbidden"] == []
    assert r["has_port"]


def test_run_refuses_without_a_card(checkout):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "dummy_cell",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=checkout, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_compared_whole():
    mods = ["trace_tpu_torch", "trace_tpu_torch.scene", "jaxtyping",
            "numpy", "trace_tpu", "jax.numpy", "flax.linen"]
    assert harness.forbidden_modules(mods) == ["flax.linen", "jax.numpy",
                                               "trace_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(harness.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(ref, name)):
                assert mod.split(".")[0] not in (
                    "trace_tpu_torch", "trace_tpu", "jax", "jaxlib", "flax",
                    "perfbench"), (name, mod)
    code = ("import sys; sys.path.insert(0, '.');"
            "import perfbench.reference.whitted, perfbench.reference.sppm;"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('trace_tpu_torch', 'trace_tpu', 'jax')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
