"""Settings loader with field-name parity to the reference YAML files.

Port of ar_orbslam2_tpu/utils/config.py (plain Python, copied so that the
port imports nothing of the JAX package). The reference parses per-camera
settings via cv::FileStorage (Tracking ctor, src/Tracking.cc:≈40-150):
Camera.fx..k3, Camera.bf, Camera.fps, Camera.RGB, ThDepth, DepthMapFactor,
ORBextractor.nFeatures/scaleFactor/nLevels/iniThFAST/minThFAST, Viewer.*.
The same YAML files (e.g. TUM1.yaml, KITTI00-02.yaml, EuRoC.yaml) load
here unchanged — this parser handles the cv::FileStorage dialect
("%YAML:1.0" header, "Key.Sub: value" flat keys) without OpenCV.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core.camera import Camera


def _parse_scalar(txt: str):
    """A number without '.' or an exponent is an int; other numbers are
    floats; anything else stays a string."""
    txt = txt.strip().strip('"')
    try:
        v = float(txt)
        return int(v) if v == int(v) and "." not in txt and "e" not in \
            txt.lower() else v
    except ValueError:
        return txt


def parse_filestorage(path: str) -> dict:
    """Parse the flat key:value subset of cv::FileStorage YAML."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].rstrip()
            if not line or line.startswith("%YAML") or line.startswith("---"):
                continue
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            key = key.strip()
            val = val.strip()
            if not val:
                continue
            out[key] = _parse_scalar(val)
    return out


@dataclass
class Settings:
    camera: Camera = field(default_factory=lambda: Camera(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0))
    fps: float = 30.0
    rgb: bool = True
    th_depth: float = 40.0          # ThDepth (in units of baseline)
    depth_map_factor: float = 1.0   # DepthMapFactor (RGB-D depth scaling)
    n_features: int = 1000          # ORBextractor.nFeatures
    scale_factor: float = 1.2       # ORBextractor.scaleFactor
    n_levels: int = 8               # ORBextractor.nLevels
    ini_th_fast: int = 20           # ORBextractor.iniThFAST
    min_th_fast: int = 7            # ORBextractor.minThFAST
    raw: dict = field(default_factory=dict)


def load_settings(path: str, width: int = 640, height: int = 480) -> Settings:
    d = parse_filestorage(path)

    def g(key, default):
        return d.get(key, default)

    cam = Camera(
        fx=float(g("Camera.fx", 500.0)), fy=float(g("Camera.fy", 500.0)),
        cx=float(g("Camera.cx", width / 2)),
        cy=float(g("Camera.cy", height / 2)),
        k1=float(g("Camera.k1", 0.0)), k2=float(g("Camera.k2", 0.0)),
        p1=float(g("Camera.p1", 0.0)), p2=float(g("Camera.p2", 0.0)),
        k3=float(g("Camera.k3", 0.0)), bf=float(g("Camera.bf", 0.0)),
        width=int(g("Camera.width", width)),
        height=int(g("Camera.height", height)))
    dmf = float(g("DepthMapFactor", 1.0))
    return Settings(
        camera=cam,
        fps=float(g("Camera.fps", 30.0)),
        rgb=bool(int(g("Camera.RGB", 1))),
        th_depth=float(g("ThDepth", 40.0)),
        # the reference treats a 0 factor as "depth already in meters"
        depth_map_factor=1.0 if dmf == 0 else dmf,
        n_features=int(g("ORBextractor.nFeatures", 1000)),
        scale_factor=float(g("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(g("ORBextractor.nLevels", 8)),
        ini_th_fast=int(g("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(g("ORBextractor.minThFAST", 7)),
        raw=d)


def write_settings(path, cam: Camera, fps=30.0, n_features=1000,
                   depth_map_factor=None):
    """Write a settings file in the reference's cv::FileStorage dialect
    (the keys load_settings reads)."""
    keys = {"Camera.fx": cam.fx, "Camera.fy": cam.fy, "Camera.cx": cam.cx,
            "Camera.cy": cam.cy, "Camera.k1": cam.k1, "Camera.k2": cam.k2,
            "Camera.p1": cam.p1, "Camera.p2": cam.p2, "Camera.k3": cam.k3,
            "Camera.width": int(cam.width), "Camera.height": int(cam.height),
            "Camera.fps": float(fps), "Camera.bf": cam.bf, "Camera.RGB": 1,
            "ORBextractor.nFeatures": int(n_features)}
    if depth_map_factor is not None:
        keys["DepthMapFactor"] = float(depth_map_factor)
    with open(path, "w") as f:
        f.write("%YAML:1.0\n")
        for k, v in keys.items():
            f.write(f"{k}: {float(v)!r}\n" if isinstance(v, float)
                    else f"{k}: {v}\n")
