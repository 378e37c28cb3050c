"""The port stands alone: it imports torch and numpy, never JAX and never
the JAX package (the machine with the GPU has no JAX)."""
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
                 "wavefront.whitted"):
        assert "trace_tpu_torch." + name in MODULES


@pytest.mark.parametrize("name", MODULES)
def test_module_imports_neither_jax_nor_trace_tpu(name):
    path = os.path.join(REPO, *name.split(".")) + ".py"
    if not os.path.exists(path):
        path = os.path.join(REPO, *name.split("."), "__init__.py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not {"jax", "jaxlib", "trace_tpu"} & set(roots), (name, roots)


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
