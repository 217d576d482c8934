"""Multi-sequence runner: N sequences interleaved on one device.

Port of ar_orbslam2_tpu/apps/run_multi.py. The reference has no
multi-sequence story (one process, one map); here each sequence gets its
own SlamSystem (own map, own device-resident tracking state, own captured
frame-step graph with its own search workspace) and sequences are
interleaved in chunk-sized slices on one card, so one sequence's mapping
work overlaps another's tracking.

Sources: dataset directories (TUM/KITTI/EuRoC autodetected, comma
separated) or --synthetic N for N rendered plane sequences.

  python -m ar_orbslam2_tpu_torch.apps.run_multi <settings.yaml> \
      --synthetic 2 --frames 120 [--chunk 8] [--out-prefix traj_]
  python -m ar_orbslam2_tpu_torch.apps.run_multi <settings.yaml> \
      --seqs /data/kitti/00,/data/kitti/05 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from ..utils.config import load_settings
from .common import build_system


def load_sources(args, settings):
    """Returns a list of dicts: name, frames (list of gray u8), ts."""
    out = []
    if args.synthetic:
        from ..data import synthetic
        cam = settings.camera
        for k in range(args.synthetic):
            imgs, _, _ = synthetic.render_plane_sequence(
                cam, n_frames=args.frames, seed=k, motion=0.6)
            out.append(dict(name=f"synthetic{k}", frames=list(imgs),
                            ts=[i / 30.0 for i in range(len(imgs))]))
        return out
    from ..data import datasets
    for path in args.seqs.split(","):
        path = path.strip()
        if os.path.exists(os.path.join(path, "rgb.txt")):
            ts, paths = datasets.load_tum_monocular(path)
        elif os.path.isdir(os.path.join(path, "image_0")):
            ts, paths = datasets.load_kitti(path)
        else:
            ts, paths = datasets.load_euroc(path)
        if args.frames:
            ts, paths = ts[:args.frames], paths[:args.frames]
        frames = list(datasets.iter_images(paths))
        out.append(dict(name=path.rstrip("/").split("/")[-1],
                        frames=frames, ts=list(ts)))
    return out


def main(argv=None):
    """Returns dict(fps, wall_s, sources, systems)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("--seqs", default="", help="comma-separated seq dirs")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--out-prefix", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    args = ap.parse_args(argv)

    st = load_settings(args.settings)
    sources = load_sources(args, st)
    systems = [build_system(st, sensor="MONOCULAR", device=args.device)
               for _ in sources]
    cursors = [0] * len(sources)
    n_total = sum(len(s["frames"]) for s in sources)

    t0 = time.perf_counter()
    done = False
    while not done:
        done = True
        # round-robin: one chunk per sequence per pass — mapping work of
        # one sequence overlaps tracking of the next
        for k, (src, slam) in enumerate(zip(sources, systems)):
            i = cursors[k]
            if i >= len(src["frames"]):
                continue
            done = False
            j = min(i + args.chunk, len(src["frames"]))
            slam.track_monocular_batch(src["frames"][i:j],
                                       timestamps=src["ts"][i:j],
                                       chunk=args.chunk)
            cursors[k] = j
    for slam in systems:            # inside the wall: the device finishes
        slam.shutdown()
    wall = time.perf_counter() - t0

    for src, slam in zip(sources, systems):
        ok = sum(1 for m in slam.tracking.metrics if m.get("ok"))
        print(f"[{src['name']}] tracked {ok}/{len(src['frames'])} "
              f"kf={slam.store.n_keyframes()} "
              f"mp={slam.store.n_map_points()}", file=sys.stderr)
        if args.out_prefix:
            slam.save_trajectory_tum(f"{args.out_prefix}{src['name']}.txt")
    fps = n_total / max(wall, 1e-9)
    print(f"[multi] {len(sources)} sequences, {n_total} frames in "
          f"{wall:.1f}s = {fps:.1f} aggregate fps", file=sys.stderr)
    return dict(fps=fps, wall_s=wall, sources=sources, systems=systems)


if __name__ == "__main__":
    main()
