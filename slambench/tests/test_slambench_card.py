"""The command end to end. Without a card it must fail without a result;
on a card (``-m cuda``) one short run of a cell must print a result line
that keeps to the schema. Whether a card is there is decided inside the
fixture, never at import."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from slambench.catalog import ROOT


def _run(cwd, *args, timeout=900):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-m", "slambench.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_without_the_program_there_is_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and slambench/."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "slambench"), tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = _run(tmp_path, "--workload", "tum1_mono.xyz_sway", "--seed",
               "2147483653", "--seconds", "2", "--trace", "0", timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = _run(ROOT, "--workload", "tum1_mono.xyz_sway", "--seed",
               "4294967311", "--seconds", "5", "--trace", "0")
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["device"]["platform"] == "gpu" and line["correct"]
    assert set(line["metrics"]) == {"track_fps", "setup_s"}
