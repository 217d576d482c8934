"""SlamSystem — the public facade, parity with the reference System API.

Port of ar_orbslam2_tpu/system/slam.py, per-frame monocular path: the
constructor, frame construction (ORB on the system's device),
track_monocular / track_monocular_batch, shutdown and the trajectory
exports. Tracking -> LocalMapper run synchronously, in that order, around
torch stages on ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..core.camera import Camera
from ..frontend.orb import OrbConfig, extract_orb
from ..mapping.local_mapping import LocalMapper, LocalMapperConfig
from ..mapstore.map import MapConfig, MapStore
from .frame import Frame
from .tracking import Tracking, TrackingConfig

MONOCULAR = "MONOCULAR"
STEREO = "STEREO"
RGBD = "RGBD"

_ROADMAP = "ROADMAP.md, 'Modules still to port'"


@dataclass
class SlamConfig:
    """The JAX package's SlamConfig, defaults included. Options this port
    does not implement yet raise NotImplementedError at construction — they
    are never silently switched off. The runnable configuration is

        SlamConfig(use_fused_tracking=False, async_mapping=False,
                   enable_loop_closing=False, enable_relocalization=False)
    """
    sensor: str = MONOCULAR
    map: MapConfig = field(default_factory=MapConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapper: LocalMapperConfig = field(default_factory=LocalMapperConfig)
    orb_n_features: int = 1000
    enable_loop_closing: bool = True
    enable_relocalization: bool = True
    depth_threshold: float = 40.0      # ThDepth * baseline gate (stereo)
    use_fused_tracking: bool = True
    async_mapping: bool = False

    def __post_init__(self):
        unported = [
            (self.use_fused_tracking, "use_fused_tracking=True",
             "item 1: system/fused.py"),
            (self.async_mapping, "async_mapping=True",
             "item 1: mapping/async_mapper.py"),
            (self.enable_relocalization, "enable_relocalization=True",
             "item 2: relocalization"),
            (self.enable_loop_closing, "enable_loop_closing=True",
             "item 3: loop closing"),
            (self.sensor != MONOCULAR, f"sensor={self.sensor}",
             "item 5: stereo/RGB-D"),
        ]
        for on, what, item in unported:
            if on:
                raise NotImplementedError(
                    f"{what} is not ported to ar_orbslam2_tpu_torch yet "
                    f"({_ROADMAP}, {item})")


def per_frame_config(**kw) -> SlamConfig:
    """The configuration this port runs: the per-frame synchronous
    monocular path (keyword overrides go to SlamConfig)."""
    base = dict(use_fused_tracking=False, async_mapping=False,
                enable_loop_closing=False, enable_relocalization=False)
    base.update(kw)
    return SlamConfig(**base)


class SlamSystem:
    """End-to-end SLAM pipeline with the reference System's API surface."""

    def __init__(self, cam: Camera, cfg: SlamConfig | None = None,
                 device="cpu", seed=0):
        self.cam = cam
        self.device = torch.device(device)
        cfg = per_frame_config() if cfg is None else cfg
        # keep the map's scale-band parameters in sync with the tracker's
        # pyramid config (one source of truth: TrackingConfig); copy first,
        # never mutate the caller's config
        if (cfg.map.scale_factor != cfg.tracking.scale_factor
                or cfg.map.n_levels != cfg.tracking.n_levels):
            cfg = replace(cfg, map=replace(
                cfg.map, scale_factor=cfg.tracking.scale_factor,
                n_levels=cfg.tracking.n_levels))
        self.cfg = cfg
        self.store = MapStore(cfg.map)
        self.mapper = LocalMapper(self.store, cam, cfg.mapper,
                                  device=self.device)
        self.tracking = Tracking(self.store, self.mapper, cam, cfg.tracking,
                                 device=self.device, seed=seed)
        self._orb_cfg = OrbConfig(n_features=cfg.tracking.max_kp)
        self._next_frame_id = 0
        self.last_frame = None

    # ------------------------------------------------------------------
    # frame construction
    # ------------------------------------------------------------------
    def _extract(self, image_u8):
        """Run the ORB frontend on a grayscale image (on the device); one
        batched readback."""
        img = torch.as_tensor(np.ascontiguousarray(image_u8),
                              device=self.device)
        out = extract_orb(img, self._orb_cfg)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def make_frame(self, image_u8=None, features=None, timestamp=0.0) -> Frame:
        """Build a Frame from an image (ORB extraction) or a feature dict
        (uv / desc (bits) / octave / valid [/ angle]) padded to max_kp."""
        if features is None:
            if image_u8 is None:
                raise ValueError("make_frame needs an image or features")
            f = self._extract(image_u8)
            features = dict(uv=f["uv"], desc=f["desc_bits"],
                            octave=f["octave"], valid=f["valid"],
                            angle=f["angle"])
        P = self.cfg.tracking.max_kp

        def pad(a, fill=0.0):
            a = np.asarray(a)
            if a.shape[0] == P:
                return a
            out = np.full((P,) + a.shape[1:], fill, a.dtype)
            out[:a.shape[0]] = a[:P]
            return out

        uv = pad(features["uv"].astype(np.float32))
        if self.cam.has_distortion:
            from ..core.camera import undistort_points
            uv = undistort_points(self.cam, torch.as_tensor(uv)).numpy()
        frame = Frame(
            uv=uv,
            desc_bits=pad(features["desc"].astype(np.uint8)),
            octave=pad(features["octave"].astype(np.int32)),
            valid=pad(features["valid"].astype(bool), False),
            angle=pad(features.get("angle",
                                   np.zeros(P, np.float32)).astype(np.float32)),
            timestamp=timestamp, frame_id=self._next_frame_id,
            device=self.device)
        self._next_frame_id += 1
        return frame

    # ------------------------------------------------------------------
    # reference API surface
    # ------------------------------------------------------------------
    def track_monocular(self, image_u8=None, timestamp=0.0, features=None):
        """Parity: System::TrackMonocular — returns Tcw (4x4) or None."""
        frame = self.make_frame(image_u8, features, timestamp)
        rec = self.tracking.track(frame)
        self.last_frame = frame
        if rec.get("ok") and frame.R is not None:
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = frame.R
            T[:3, 3] = frame.t
            return T
        return None

    def track_monocular_batch(self, images, timestamps=None, chunk=8):
        """Throughput API of the JAX package. With fused tracking not
        ported, every frame takes the per-frame path (the JAX package's
        loop when no fused frontend exists); `chunk` is accepted for API
        parity. Returns a list of Tcw (4x4) or None."""
        n = len(images)
        if timestamps is None:
            timestamps = [i / 30.0 for i in range(n)]
        return [self.track_monocular(images[i], timestamp=timestamps[i])
                for i in range(n)]

    def reset(self):
        """Parity: System::Reset."""
        self.tracking.reset()

    def shutdown(self):
        """Parity: System::Shutdown. Mapping runs synchronously, so there is
        no worker to join; waits for the device's queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # map checkpoint (the JAX package's format)
    # ------------------------------------------------------------------
    def save_map(self, path):
        from ..mapstore.checkpoint import save_map
        save_map(self.store, path)

    # ------------------------------------------------------------------
    # trajectory export (System::SaveTrajectory* parity)
    # ------------------------------------------------------------------
    def keyframe_trajectory(self):
        """(timestamps, R_wc, t_wc) over live keyframes, id order."""
        s = self.store
        ids = s.keyframe_ids()
        R_cw = s.kf_R[ids]
        t_cw = s.kf_t[ids]
        R_wc = np.swapaxes(R_cw, -1, -2)
        t_wc = -(R_wc @ t_cw[..., None])[..., 0]
        return s.kf_timestamp[ids], R_wc, t_wc

    def frame_trajectory(self):
        """Per-frame camera-to-world poses for all tracked frames,
        re-composed against the FINAL (BA-refined) reference-KF poses.
        Parity: System::SaveTrajectoryTUM's Tcr * Trw recomposition."""
        s = self.store
        ts, Rs, tss = [], [], []
        for rec in self.tracking.metrics:
            if "R" not in rec or not rec["ok"]:
                continue
            if "R_cr" in rec and rec.get("ref_kf", -1) >= 0:
                ref = rec["ref_kf"]
                R_cw = rec["R_cr"] @ s.kf_R[ref]
                t_cw = rec["R_cr"] @ s.kf_t[ref] + rec["t_cr"]
            else:
                R_cw, t_cw = rec["R"], rec["t"]
            R_wc = R_cw.T
            ts.append(rec["timestamp"])
            Rs.append(R_wc)
            tss.append(-(R_wc @ t_cw))
        return (np.asarray(ts), np.asarray(Rs), np.asarray(tss))

    def save_keyframe_trajectory_tum(self, path):
        from ..eval.trajectory import save_tum
        save_tum(path, *self.keyframe_trajectory())

    def save_trajectory_tum(self, path):
        from ..eval.trajectory import save_tum
        save_tum(path, *self.frame_trajectory())

    def save_trajectory_kitti(self, path):
        from ..eval.trajectory import save_kitti
        _, R_wc, t_wc = self.frame_trajectory()
        save_kitti(path, R_wc, t_wc)
