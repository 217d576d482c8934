"""Nothing of the benchmark imports JAX or the JAX package: module names
are compared by their whole top-level name, so that the port's
``ar_orbslam2_tpu_torch`` passes."""
import ast
import os
import subprocess
import sys

import pytest

from slambench.bench import FORBIDDEN, forbidden_modules
from slambench.catalog import ROOT


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, _, files in os.walk(os.path.join(ROOT, "slambench")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    found = {(os.path.relpath(p, ROOT), m) for p in _sources()
             for m in _imports(p) if m.split(".")[0] in FORBIDDEN}
    assert not found


@pytest.mark.parametrize("names,want", [
    (["ar_orbslam2_tpu_torch", "ar_orbslam2_tpu_torch.system.slam",
      "jaxtyping", "numpy"], []),
    (["jax.numpy", "numpy"], ["jax"]),
    (["ar_orbslam2_tpu.core.lie"], ["ar_orbslam2_tpu"]),
    (["flax.linen", "jaxlib.xla_client"], ["flax", "jaxlib"]),
])
def test_names_are_compared_whole(names, want):
    assert forbidden_modules(names) == want


def test_importing_the_harness_loads_no_jax():
    code = ("import sys; import slambench.run, slambench.bench, "
            "slambench.control, slambench.faults; "
            "import ar_orbslam2_tpu_torch.apps.common; "
            "from slambench.bench import forbidden_modules; "
            "print(forbidden_modules())")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
