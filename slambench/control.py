"""The readings that the check's limits are set from, on the card.

    python -m slambench.control --workload <cell> --seeds 11,12,13 \
        [--seconds 8] [--frozen-map]

For each seed, one sound run of the cell (set-up as in a benchmark run,
a short window at the cell's own load) gives the program's readings;
then, on that run's own outputs:

  * the control: the reference ORB computed in bfloat16, the precision
    below the program's float32, in the program's place, on the same
    sampled frames;
  * the pose faults of ``faults.py`` (``frozen_pose``, ``half_batch``,
    ``altered_pose``) applied to every call's returned poses.

With ``--frozen-map`` a second run per seed plants ``faults.frozen_map``
(local BA returns its state unchanged). One JSON line per reading set on
standard output, then a summary: per number, the largest sound reading
and the smallest reading of each fault and of the control. The benchmark's
own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import bench, faults
from .reference import check as CHK


def _emit(seed, kind, readings):
    print(json.dumps(dict(seed=seed, kind=kind, readings=readings)),
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--frozen-map", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = bench.load_cell(args.workload)
    table: dict = {}

    def note(kind, readings):
        for k, v in readings.items():
            table.setdefault(k, {}).setdefault(kind, []).append(v)

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with bench.stdout_to_stderr():
            run = bench.Run(cell, seed, args.seconds, False)
            out = run.execute()
        w0 = out["window_frames"][0]
        _emit(seed, "program", out["readings"])
        note("program", out["readings"])
        low = dict(orb_bit_err_pct=CHK.orb_reading(
            out["orb_frames"], run.seq.images, cell.settings.camera,
            cell.orb_params, low_dtype=torch.bfloat16))
        _emit(seed, "control_bf16", low)
        note("control_bf16", low)
        for name, fn in faults.POSE_FAULTS.items():
            poses = [p for ps in out["calls"] for p in fn(ps)]
            r = bench.check_readings(cell, run.seq, w0, poses, out["map"],
                                     [])
            _emit(seed, name, r)
            note(name, r)
        if args.frozen_map:
            undo = faults.frozen_map()
            try:
                with bench.stdout_to_stderr():
                    r = bench.Run(cell, seed, args.seconds, False).execute()
            finally:
                undo()
            _emit(seed, "frozen_map", r["readings"])
            note("frozen_map", r["readings"])
        print(f"[control] seed {seed} done in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    summary = {}
    for number, kinds in table.items():
        row = {}
        for kind, vals in kinds.items():
            row[kind] = max(vals) if kind == "program" else min(vals)
        summary[number] = row
    print(json.dumps(dict(summary=summary)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
