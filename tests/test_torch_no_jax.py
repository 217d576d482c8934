"""The port never imports jax or the JAX package.

tests/conftest.py imports jax into the test process, so the check runs in
a fresh interpreter: jax and ar_orbslam2_tpu are blocked at import, every
module of ar_orbslam2_tpu_torch is imported, and no jax module may appear.
"""
import os
import subprocess
import sys

_CHECK = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ar_orbslam2_tpu"):
            raise ImportError(f"the port imported {name}")
        return None

for mod in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")]:
    del sys.modules[mod]
sys.meta_path.insert(0, _Block())
import ar_orbslam2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    ar_orbslam2_tpu_torch.__path__, "ar_orbslam2_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "ar_orbslam2_tpu")]
assert not bad, bad
print(len(names))
"""


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", _CHECK], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip().splitlines()[-1]) >= 20
