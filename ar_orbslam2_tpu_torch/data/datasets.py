"""Dataset loaders: TUM RGB-D, KITTI odometry, EuRoC MAV.

Port of ar_orbslam2_tpu/data/datasets.py (plain Python and numpy, copied so
that the port imports nothing of the JAX package). Parity with the
reference example mains' LoadImages functions (Examples/Monocular/
mono_tum.cc, mono_kitti.cc, mono_euroc.cc, Examples/RGB-D/rgbd_tum.cc +
associate.py): image lists + timestamps; TUM rgb<->depth association
reimplements associate.py's nearest-timestamp matching.
"""
from __future__ import annotations

import os

import numpy as np


def imread_gray(path):
    import cv2
    im = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if im is None:
        raise FileNotFoundError(path)
    return im


def imread_depth(path, depth_map_factor):
    """A 16-bit depth PNG in meters: raw values over DepthMapFactor (TUM
    stores 5000 per meter)."""
    import cv2
    d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if d is None:
        raise FileNotFoundError(path)
    d = d.astype(np.float32)
    d /= max(depth_map_factor, 1e-9)
    return d


def _read_list(path):
    """(timestamps, names) of a TUM list file (rgb.txt, depth.txt)."""
    ts, names = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, p = line.split()[:2]
            ts.append(float(t))
            names.append(p)
    return ts, names


def load_tum_monocular(seq_dir):
    """rgb.txt -> (timestamps, image paths). Parity: LoadImages in
    mono_tum.cc."""
    ts, names = _read_list(os.path.join(seq_dir, "rgb.txt"))
    return np.asarray(ts), [os.path.join(seq_dir, p) for p in names]


def associate(ts_a, ts_b, max_dt=0.02):
    """Nearest-timestamp association, greedy per entry of ts_a (an entry
    of ts_b may be taken twice). Parity: Examples/RGB-D/associate.py."""
    ia, ib = [], []
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(np.asarray(ts_b) - t)))
        if abs(ts_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return ia, ib


def load_tum_rgbd(seq_dir, max_dt=0.02):
    """(timestamps, rgb paths, depth paths) associated."""
    ts_rgb, rgb = load_tum_monocular(seq_dir)
    ts_d, names = _read_list(os.path.join(seq_dir, "depth.txt"))
    dep = [os.path.join(seq_dir, p) for p in names]
    ia, ib = associate(ts_rgb, np.asarray(ts_d), max_dt)
    return (ts_rgb[ia], [rgb[i] for i in ia], [dep[j] for j in ib])


def load_kitti(seq_dir, stereo=False):
    """KITTI odometry sequence dir (image_0 [, image_1], times.txt).
    Parity: LoadImages in mono_kitti.cc / stereo_kitti.cc."""
    with open(os.path.join(seq_dir, "times.txt")) as f:
        ts = np.asarray([float(x) for x in f.read().split()])
    left = [os.path.join(seq_dir, "image_0", f"{i:06d}.png")
            for i in range(len(ts))]
    if not stereo:
        return ts, left
    right = [os.path.join(seq_dir, "image_1", f"{i:06d}.png")
             for i in range(len(ts))]
    return ts, left, right


def load_euroc(seq_dir, cam="cam0"):
    """EuRoC MAV mav0/camN/data + data.csv timestamps.
    Parity: LoadImages in mono_euroc.cc."""
    base = os.path.join(seq_dir, "mav0", cam)
    ts, paths = [], []
    with open(os.path.join(base, "data.csv")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t_ns, name = line.split(",")[:2]
            ts.append(float(t_ns) * 1e-9)
            paths.append(os.path.join(base, "data", name.strip()))
    return np.asarray(ts), paths


def iter_images(paths):
    for p in paths:
        yield imread_gray(p)


def write_tum_sequence(seq_dir, images, R_cw, t_cw, fps=30.0, depth=None,
                       depth_map_factor=5000.0):
    """Write a sequence in the TUM RGB-D layout: rgb/*.png + rgb.txt and
    groundtruth.txt (camera-to-world, TUM format); with `depth` (meters,
    one map per image) also depth/*.png as 16-bit PNGs holding
    depth * depth_map_factor, as TUM stores them, + depth.txt. Frame i is
    stamped i / fps."""
    import cv2

    from ..eval.trajectory import save_tum
    R_cw = np.asarray(R_cw, np.float64)
    t_cw = np.asarray(t_cw, np.float64)
    ts = np.arange(len(images)) / fps
    lists = {"rgb": images} if depth is None else \
        {"rgb": images, "depth": depth}
    for kind, maps in lists.items():
        os.makedirs(os.path.join(seq_dir, kind), exist_ok=True)
        with open(os.path.join(seq_dir, f"{kind}.txt"), "w") as f:
            f.write(f"# {kind} images\n")
            for t, im in zip(ts, maps):
                name = f"{kind}/{t:.6f}.png"
                if kind == "depth":
                    im = np.round(np.asarray(im) * depth_map_factor
                                  ).clip(0, 65535).astype(np.uint16)
                cv2.imwrite(os.path.join(seq_dir, name), im)
                f.write(f"{t:.6f} {name}\n")
    R_wc = np.swapaxes(R_cw, -1, -2)
    t_wc = -(R_wc @ t_cw[..., None])[..., 0]
    save_tum(os.path.join(seq_dir, "groundtruth.txt"), ts, R_wc, t_wc)
