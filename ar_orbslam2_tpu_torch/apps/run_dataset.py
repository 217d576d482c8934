"""Dataset runner CLI — mono/stereo/RGB-D over TUM / KITTI / EuRoC.

Port of ar_orbslam2_tpu/apps/run_dataset.py. Parity with the reference
example executables (mono_tum, mono_kitti, mono_euroc, stereo_kitti,
rgbd_tum), one CLI:

  python -m ar_orbslam2_tpu_torch.apps.run_dataset tum <settings> <seq_dir>
  python -m ar_orbslam2_tpu_torch.apps.run_dataset kitti <settings> <seq_dir> \
      [--stereo]
  python -m ar_orbslam2_tpu_torch.apps.run_dataset tum-rgbd <settings> <seq>
  python -m ar_orbslam2_tpu_torch.apps.run_dataset euroc <settings> <seq_dir>

Runs on the GPU; ``--device cpu`` runs on the CPU (with
``--no-precompile``: precompile captures CUDA graphs).
"""
from __future__ import annotations

import argparse

from ..data import datasets
from ..utils.config import load_settings
from .common import build_system, precompile, run_sequence


def _frames(args, st):
    """(timestamp, track kwargs) per frame of the dataset directory."""
    gray = datasets.imread_gray
    if args.dataset == "tum-rgbd":
        ts, rgb, dep = datasets.load_tum_rgbd(args.seq_dir)
        items = zip(ts, rgb, dep)

        def read(p, q):
            return dict(image_u8=gray(p), depth_m=datasets.imread_depth(
                q, st.depth_map_factor))
    elif args.dataset == "kitti" and args.stereo:
        items = zip(*datasets.load_kitti(args.seq_dir, stereo=True))

        def read(left, right):
            return dict(left_u8=gray(left), right_u8=gray(right))
    else:
        load = {"tum": datasets.load_tum_monocular,
                "kitti": datasets.load_kitti,
                "euroc": datasets.load_euroc}[args.dataset]
        items = zip(*load(args.seq_dir))

        def read(p):
            return dict(image_u8=gray(p))
    for i, (t, *paths) in enumerate(items):
        if args.max_frames and i >= args.max_frames:
            return
        yield t, read(*paths)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=["tum", "kitti", "tum-rgbd", "euroc"])
    ap.add_argument("settings")
    ap.add_argument("seq_dir")
    ap.add_argument("--stereo", action="store_true")
    ap.add_argument("--out", default="trajectory")
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--no-loops", action="store_true")
    ap.add_argument("--chunk", type=int, default=8,
                    help="fused chunk size for mono tracking (0/1 = "
                         "per-frame)")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run the mapping stage on a worker thread "
                         "(reference-style pipeline)")
    ap.add_argument("--no-precompile", action="store_true",
                    help="skip the startup warm-up and graph capture (the "
                         "first frames then pay the kernel build and the "
                         "captures)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; no GPU raises)")
    args = ap.parse_args(argv)

    st = load_settings(args.settings)
    sensor = ("STEREO" if args.stereo else
              "RGBD" if args.dataset == "tum-rgbd" else "MONOCULAR")
    slam = build_system(st, sensor=sensor, enable_loops=not args.no_loops,
                        async_mapping=args.async_mapping,
                        device=args.device)
    if not args.no_precompile and sensor == "MONOCULAR":
        precompile(slam)
    times = run_sequence(slam, _frames(args, st), metrics_path=args.metrics,
                         traj_prefix=args.out,
                         chunk=args.chunk if sensor == "MONOCULAR" else 0)
    slam.shutdown()
    print(f"keyframes: {slam.store.n_keyframes()} "
          f"map points: {slam.store.n_map_points()}")
    return slam, times


if __name__ == "__main__":
    main()
