"""The port stands alone: it and its scripts (chip_smoke.py, scripts/torch_*)
import torch and numpy, never JAX and never the JAX package (the machine
with the GPU has no JAX)."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import trace_tpu_torch

PKG_DIR = os.path.dirname(trace_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
MODULES = sorted(m.name for m in pkgutil.walk_packages([PKG_DIR],
                                                       "trace_tpu_torch."))


def test_every_module_is_listed():
    for name in ("accel.mxu", "ops.sweep", "ops.intersect",
                 "wavefront.whitted", "sampler.halton", "integrators.common",
                 "integrators.sppm", "wavefront.sppm_camera",
                 "wavefront.sppm_photon", "utils.checkpoint", "io.ply",
                 "models.sphere", "models.caustic_glass",
                 "models.env_studio", "accel.instances",
                 "models.sphere_field", "io.png", "materials.textures",
                 "wavefront.lights", "film.png", "sampler.distribution",
                 "sampler.stratified", "utils.stats", "utils.compare",
                 "io.obj", "accel.bvh", "accel.wbvh", "ops.bvh_walk",
                 "parallel.render", "parallel.sppm", "core.bounds",
                 "ops.splat", "ops.threefry"):
        assert "trace_tpu_torch." + name in MODULES


# The port's scripts outside the package: they run on the GPU machine too.
SCRIPTS = ["chip_smoke.py", "scripts/torch_sweep_launches.py",
           "scripts/torch_sweep_warps.py", "scripts/torch_intersect_tiles.py",
           "scripts/torch_walk_calls.py", "scripts/torch_sweep_tilings.py",
           "scripts/torch_config6_leg.py", "scripts/torch_frame_spans.py",
           "scripts/torch_threefry_images.py"]


def _assert_no_jax_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not {"jax", "jaxlib", "trace_tpu"} & set(roots), (path, roots)


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_neither_jax_nor_trace_tpu(name):
    path = os.path.join(REPO, *name.split(".")) + ".py"
    if not os.path.exists(path):
        path = os.path.join(REPO, *name.split("."), "__init__.py")
    _assert_no_jax_imports(path)


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_imports_neither_jax_nor_trace_tpu(script):
    _assert_no_jax_imports(os.path.join(REPO, script))


def test_package_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['trace_tpu'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_package_import_builds_nothing_and_leaves_cuda_alone():
    # The top-level package with JAX blocked and no card visible: its
    # exports import, no kernel library is built or loaded, CUDA is not
    # initialised.
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['trace_tpu'] = None\n"
            "import torch, trace_tpu_torch as T\n"
            "from trace_tpu_torch.ops import sweep, intersect, bvh_walk\n"
            "assert all(hasattr(T, n) for n in T.__all__)\n"
            "libs = (sweep.sweep_kernel, sweep.block_entry_kernel, "
            "intersect.intersect_kernel, bvh_walk.walk_kernel)\n"
            "assert all(k.lib._dll is None for k in libs)\n"
            "assert not torch.cuda.is_initialized()\n"
            "print(len(T.__all__))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(trace_tpu_torch.__all__)


def _path_strings(path):
    """(line, string) of every string constant in a Python file, docstrings
    apart, that names a path under the JAX package: the bare directory
    name "trace_tpu" (a path component, as os.path.join takes it) or
    "trace_tpu/..."."""
    tree = ast.parse(open(path).read())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs
            and (node.value == "trace_tpu" or "trace_tpu/" in node.value
                 or "trace_tpu\\" in node.value)]


def test_no_file_of_the_port_reads_the_jax_package(tmp_path):
    # The port keeps its own copy of everything it needs: no string in its
    # code names a path under trace_tpu/ to open or compile, and the SAH
    # builder compiles the port's own source. (chip_smoke.py's kernel line
    # names the TPU kernels each one replaces, as labels.)
    from trace_tpu_torch.accel import native

    paths = []
    for dirpath, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    bad = {p: _path_strings(p) for p in paths if _path_strings(p)}
    assert not bad, bad
    assert len(paths) > 60
    assert os.path.samefile(native.SOURCE, os.path.join(
        PKG_DIR, "csrc", "bvh_builder.cpp"))
    # The check sees the route the port used to take.
    probe = tmp_path / "_path_probe.py"
    probe.write_text('"""trace_tpu/native is named here only."""\n'
                     'import os\n'
                     'SOURCE = os.path.join("..", "trace_tpu", "native")\n')
    assert [line for line, _ in _path_strings(str(probe))] == [3]


def test_exports_are_the_jax_packages():
    import trace_tpu

    assert trace_tpu_torch.__all__ == trace_tpu.__all__
    for name in trace_tpu_torch.__all__:
        assert getattr(trace_tpu_torch, name).__name__.rsplit(".")[-1] == \
            getattr(trace_tpu, name).__name__.rsplit(".")[-1], name


def _default_devices():
    import inspect

    from trace_tpu_torch.integrators.sppm import SPPMIntegrator, initial_state
    from trace_tpu_torch.models import (_run, caustic_glass, cornell,
                                        env_studio, mesh_heavy, sphere,
                                        sphere_field, spheres)
    from trace_tpu_torch.film.film import Film
    from trace_tpu_torch.scene import SceneBuilder

    dflt = lambda f: inspect.signature(f).parameters["device"].default
    out = {f"{m.__name__}.build_scene": dflt(m.build_scene)
           for m in (mesh_heavy, spheres, cornell, sphere, caustic_glass,
                     env_studio, sphere_field)}
    out["models.sphere.render"] = dflt(sphere.render)
    out["SceneBuilder.build"] = dflt(SceneBuilder.build)
    out["Film.initial_state"] = dflt(Film.initial_state)
    out["SPPMIntegrator"] = dflt(SPPMIntegrator)
    out["sppm.initial_state"] = dflt(initial_state)
    out["_run.parser --device"] = _run.parser(
        "", resolution=8, spp=1, depth=1, output="x.png").get_default("device")
    # The mesh's device type, when make_mesh is given no devices; a
    # sharded render runs where its mesh and scene are.
    from trace_tpu_torch.parallel import render

    out["parallel.render.make_mesh"] = render.mesh_devices(
        inspect.signature(render.make_mesh).parameters["devices"].default,
        0, 1)[0]
    out["_run.sppm_main --device"] = _run.sppm_parser(
        "", resolution=8, iterations=1, depth=1,
        output="x.png").get_default("device")
    return out


@pytest.mark.parametrize("entry", sorted(_default_devices()))
def test_entry_points_default_to_the_card(entry):
    assert _default_devices()[entry] == "cuda"


def _scene_builds_without_a_device(path):
    """(line, call) of every call in a test file that builds a port scene
    (``<port module>.build_scene(...)``, or ``.build(...)`` on a name bound
    to the port's ``SceneBuilder()`` in the same function) and passes no
    device; and the number of such calls."""
    tree = ast.parse(open(path).read())
    mods, builders = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module.split(".")[0] == "trace_tpu_torch":
            for a in node.names:
                (builders if a.name == "SceneBuilder" else mods).add(
                    a.asname or a.name)
        elif isinstance(node, ast.Import):
            mods |= {a.asname for a in node.names
                     if a.asname and a.name.startswith("trace_tpu_torch.")}
    bad, n = [], 0
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        made = {t.id for node in ast.walk(fn) if isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Name)
                and node.value.func.id in builders
                for t in node.targets if isinstance(t, ast.Name)}
        for call in ast.walk(fn):
            if not (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and isinstance(call.func.value, ast.Name)):
                continue
            owner, attr = call.func.value.id, call.func.attr
            kws = {k.arg for k in call.keywords}
            if attr == "build_scene" and owner in mods:
                ok = "device" in kws
            elif attr == "build" and owner in made:
                ok = "device" in kws or bool(call.args)
            else:
                continue
            n += 1
            if not ok:
                bad.append((call.lineno, ast.unparse(call)))
    return bad, n


def test_port_tests_build_scenes_with_an_explicit_device():
    # The entry points run on the card by default; a test that builds a
    # scene on the CPU says so.
    tests = os.path.join(REPO, "tests")
    bad, total = {}, 0
    for name in sorted(os.listdir(tests)):
        if name.startswith("test_torch_") and name.endswith(".py"):
            b, n = _scene_builds_without_a_device(os.path.join(tests, name))
            total += n
            if b:
                bad[name] = b
    assert not bad, bad
    assert total >= 15
