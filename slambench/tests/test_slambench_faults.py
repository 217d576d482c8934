"""A run with its timed path broken must come out not correct. The
harness's look for a card is skipped: the tiny cell runs on the CPU
(without precompile, which captures CUDA graphs) through the rest of a
run, with each fault the cells can have planted where the answer is
produced: a step that returns its state unchanged, half of each call
left out, an answer altered, and the mapping stage's state left
unchanged. The tiny cell's limits are set at three times its sound
run's readings (the real cells' come from readings on the card)."""
import json
import os

import pytest

from slambench import bench, faults

CELL = "tiny_mono.tiny_sway"
SEED = 2 ** 31 + 11


def _run(cat, fault=None):
    cell = bench.load_cell(CELL, cat)
    return bench.Run(cell, SEED, 2.0, False, device="cpu", precompile=False,
                     fault=fault).execute()


@pytest.fixture(scope="module")
def sound(tiny):
    cat, base = tiny
    out = _run(cat)
    numbers = {k: {"limit": 0 if k == "failed_frames" else 3 * v}
               for k, v in out["readings"].items()}
    with open(os.path.join(base, "limits", f"{CELL}.json"), "w") as f:
        json.dump({"numbers": numbers}, f)
    return out


def test_a_sound_run_reads_every_number(sound):
    assert sound["failed"] == 0 and sound["attempted"] >= 8
    assert set(sound["readings"]) == {
        "failed_frames", "ate_mm", "rpe_mm", "rot_deg", "kf_ate_mm",
        "landmark_err_mm", "orb_bit_err_pct"}


@pytest.mark.parametrize("name,numbers", [
    ("frozen_pose", {"ate_mm", "rpe_mm", "rot_deg"}),
    ("half_batch", {"failed_frames"}),
    ("altered_pose", {"ate_mm", "rpe_mm", "rot_deg"})])
def test_a_pose_fault_is_not_correct(tiny, sound, name, numbers):
    out = _run(tiny[0], fault=lambda slam: faults.plant_pose_fault(
        slam, faults.POSE_FAULTS[name]))
    assert not out["correct"], out["readings"]
    failed = {n for n, v, lim, ok in out["lines"] if not ok}
    assert failed & numbers, (out["readings"], sound["readings"])


def test_a_frozen_map_is_not_correct(tiny, sound):
    undo = faults.frozen_map()
    try:
        out = _run(tiny[0])
    finally:
        undo()
    assert not out["correct"], out["readings"]
    assert out["readings"]["landmark_err_mm"] \
        > sound["readings"]["landmark_err_mm"]
