"""The port never imports jax or the JAX package.

tests/conftest.py imports jax into the test process, so the check runs in
a fresh interpreter: jax and ar_orbslam2_tpu are blocked at import, every
module of ar_orbslam2_tpu_torch is imported (and chip_smoke.py, and the
ranks of the multi-process tests, tests/torch_dist_workers.py), and no
jax module may appear.
"""
import os
import subprocess
import sys

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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
for new in ("loop.place_recognition", "estimation.pnp",
            "estimation.relocalization", "loop.loop_closing",
            "loop.vocab_train", "estimation.sim3_solver",
            "estimation.pose_graph", "mapping.global_ba",
            "mapping.background_gba", "frontend.stereo",
            "utils.config", "data.datasets", "apps.common",
            "apps.run_dataset", "apps.run_eval", "apps.run_stream",
            "apps.run_ar", "apps.run_multi", "ar.plane", "ar.marker",
            "ar.viewer", "viz.frame_drawer", "viz.map_drawer",
            "loop.recall_study", "parallel.partition", "parallel.dist_ba",
            "parallel.multihost", "parallel.scaling_bench"):
    assert "ar_orbslam2_tpu_torch." + new in names, new
import chip_smoke
sys.path.insert(0, "tests")
import torch_dist_workers
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
