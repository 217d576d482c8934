"""SlamSystem — the public facade, parity with the reference System API.

Port of ar_orbslam2_tpu/system/slam.py: the constructor, frame
construction (ORB on the system's device), track_monocular,
track_monocular_batch (per-frame, fused chunks, or the double-buffered
pipeline with the mapping stage on a worker thread), track_stereo and
track_rgbd (per-frame: the fused path is monocular, as in the JAX
package), localization mode, load_map, precompile, shutdown and the
trajectory exports. Everything runs on ``device``: the GPU unless the
caller asks for the CPU.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..frontend.orb import OrbConfig, extract_orb
from ..mapping.local_mapping import LocalMapper, LocalMapperConfig
from ..mapstore.map import MapConfig, MapStore
from ..ops import hamming as H
from .frame import Frame
from .tracking import Tracking, TrackingConfig

MONOCULAR = "MONOCULAR"
STEREO = "STEREO"
RGBD = "RGBD"

SENSORS = (MONOCULAR, STEREO, RGBD)


@dataclass
class SlamConfig:
    """The JAX package's SlamConfig, defaults included. Every option of it
    runs; an unknown sensor name raises at construction. Depth sensors
    (STEREO, RGBD) track per frame (``use_fused_tracking`` applies to the
    monocular image path only, as in the JAX package) and close loops with
    the scale fixed.
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
        if self.sensor not in SENSORS:
            raise ValueError(f"unknown sensor {self.sensor!r}: one of "
                             f"{', '.join(SENSORS)}")


def per_frame_config(**kw) -> SlamConfig:
    """The per-frame synchronous monocular path (keyword overrides go to
    SlamConfig)."""
    base = dict(use_fused_tracking=False, async_mapping=False,
                enable_loop_closing=False, enable_relocalization=False)
    base.update(kw)
    return SlamConfig(**base)


class SlamSystem:
    """End-to-end SLAM pipeline with the reference System's API surface."""

    def __init__(self, cam: Camera, cfg: SlamConfig | None = None,
                 device=None, seed=0):
        self.cam = cam
        self.device = resolve_device(device)
        self.seed = seed
        cfg = per_frame_config() if cfg is None else cfg
        # keep the map's scale-band parameters in sync with the tracker's
        # pyramid config (one source of truth: TrackingConfig); copy first,
        # never mutate the caller's config
        if (cfg.map.scale_factor != cfg.tracking.scale_factor
                or cfg.map.n_levels != cfg.tracking.n_levels):
            cfg = replace(cfg, map=replace(
                cfg.map, scale_factor=cfg.tracking.scale_factor,
                n_levels=cfg.tracking.n_levels))
        # stereo/RGB-D close-point threshold: ThDepth * baseline meters
        # (parity: mThDepth = mbf * ThDepth / fx, Tracking ctor), derived
        # from THIS camera on a copy of the caller's config
        if cfg.sensor != MONOCULAR:
            th_m = cfg.depth_threshold * (cam.bf / cam.fx) \
                if cam.bf > 0 else cfg.depth_threshold
            cfg = replace(cfg, tracking=replace(
                cfg.tracking, depth_threshold_m=float(th_m)))
        self.cfg = cfg
        self.store = MapStore(cfg.map)
        self.mapper = LocalMapper(self.store, cam, cfg.mapper,
                                  device=self.device)
        self.tracking = Tracking(self.store, self.mapper, cam, cfg.tracking,
                                 device=self.device, seed=seed)
        # one place-recognition database, shared by the loop closer and
        # the relocalizer (through resets too)
        self.kfdb = None
        if cfg.enable_loop_closing or cfg.enable_relocalization:
            from ..loop.place_recognition import KeyFrameDatabase
            self.kfdb = KeyFrameDatabase(self.store, device=self.device)
        if cfg.enable_loop_closing:
            from ..loop.loop_closing import LoopCloser, LoopCloserConfig
            self.tracking.loop_closer = LoopCloser(
                self.store, self.mapper, cam,
                cfg=LoopCloserConfig(
                    fix_scale=cfg.sensor != MONOCULAR,
                    scale_factor=cfg.tracking.scale_factor),
                kfdb=self.kfdb, device=self.device)
        if cfg.enable_relocalization:
            from ..estimation.relocalization import Relocalizer
            self.tracking.relocalizer = Relocalizer(
                self.store, self.mapper, cam, cfg.tracking, kfdb=self.kfdb,
                device=self.device)
        self._orb_cfg = OrbConfig(n_features=cfg.tracking.max_kp)
        if cfg.use_fused_tracking and cfg.sensor == MONOCULAR:
            from .fused import FusedFrontend
            self.tracking.fused = FusedFrontend(
                self.store, cam, cfg.tracking, self._orb_cfg, self.device)
        if cfg.async_mapping:
            from ..mapping.async_mapper import AsyncMapper
            self.tracking.async_mapper = AsyncMapper(
                self.mapper, loop_closer=self.tracking.loop_closer,
                relocalizer=self.tracking.relocalizer)
        self._next_frame_id = 0
        self.last_frame = None
        self.captures_at_warmup = None      # set by precompile()

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

    def make_frame(self, image_u8=None, features=None, timestamp=0.0,
                   uvr=None, depth=None) -> Frame:
        """Build a Frame from an image (ORB extraction) or a feature dict
        (uv / desc (bits) / octave / valid [/ angle]) padded to max_kp,
        with optional per-keypoint stereo right-u and depth (-1 where
        unknown)."""
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
            uv = undistort_points(
                self.cam, torch.as_tensor(uv, device=self.device)
            ).cpu().numpy()
        frame = Frame(
            uv=uv,
            desc_bits=pad(features["desc"].astype(np.uint8)),
            octave=pad(features["octave"].astype(np.int32)),
            valid=pad(features["valid"].astype(bool), False),
            angle=pad(features.get("angle",
                                   np.zeros(P, np.float32)).astype(np.float32)),
            uvr=None if uvr is None else pad(uvr.astype(np.float32), -1.0),
            depth=None if depth is None else pad(depth.astype(np.float32),
                                                 -1.0),
            timestamp=timestamp, frame_id=self._next_frame_id,
            device=self.device)
        self._next_frame_id += 1
        return frame

    # ------------------------------------------------------------------
    # reference API surface
    # ------------------------------------------------------------------
    @staticmethod
    def _pose_matrix(R, t):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        return T

    def _rebuild_from_last_frame(self) -> bool:
        """Build the fused device state from the last tracked frame, when
        there is one with a pose and a valid reference keyframe."""
        t = self.tracking
        lf = t.last_frame
        if lf is None or lf.R is None or t.ref_kf < 0 \
                or not self.store.kf_valid[t.ref_kf]:
            return False
        t.fused.rebuild(t.ref_kf, lf.mp, lf.R, lf.t,
                        velocity=t.velocity, prev_oct=lf.octave)
        t._fused_prev_pose = (lf.R.copy(), lf.t.copy())
        return True

    def track_monocular(self, image_u8=None, timestamp=0.0, features=None):
        """Parity: System::TrackMonocular — returns Tcw (4x4) or None."""
        t = self.tracking
        fe = t.fused
        if image_u8 is not None and features is None and fe is not None \
                and t.state == "OK":
            if not fe.ready():
                self._rebuild_from_last_frame()
            if fe.ready():
                fid = self._next_frame_id
                self._next_frame_id += 1
                rec = t.track_fused(image_u8, timestamp, fid)
                if rec.get("ok") and rec.get("R") is not None:
                    return self._pose_matrix(rec["R"], rec["t"])
                return None
        frame = self.make_frame(image_u8, features, timestamp)
        rec = self.tracking.track(frame)
        self.last_frame = frame
        if rec.get("ok") and frame.R is not None:
            return self._pose_matrix(frame.R, frame.t)
        return None

    def _consumed_poses(self, consumed):
        metrics = self.tracking.metrics
        return [self._pose_matrix(rec["R"], rec["t"])
                for rec in metrics[len(metrics) - consumed:]]

    def track_monocular_batch(self, images, timestamps=None, chunk=8):
        """Throughput API: track a sequence of mono images, processing
        OK-state stretches as fused device chunks (one upload, `chunk`
        frame steps and one readback — see system/fused.py).
        Initialization and keyframe events fall back to the per-frame
        paths. Returns a list of Tcw (4x4) or None.

        With async mapping the chunks are double-buffered while the
        mapping worker's queue holds a keyframe: the next chunk is
        dispatched BEFORE the previous one's records are read back, so the
        device never idles between chunks. When the pending chunk may
        bring a keyframe, its records are read first, and a soft keyframe's
        local mapping finishes on the worker before the next chunk is
        dispatched against the map that holds it (loop closing stays on
        the worker). Without a fused frontend every frame takes the
        per-frame path."""
        t = self.tracking
        fe = t.fused
        n = len(images)
        if timestamps is None:
            timestamps = [i / 30.0 for i in range(n)]
        if fe is not None and t.async_mapper is not None:
            return self._track_batch_pipelined(images, timestamps, chunk)
        poses: list = []
        am = t.async_mapper
        i = 0
        while i < n:
            if fe is not None and t.state == "OK" and n - i >= chunk:
                mapper_idle = am is None or not am.busy()
                if fe.state is None:
                    self._rebuild_from_last_frame()
                elif not fe.ready() and mapper_idle \
                        and t.ref_kf >= 0 \
                        and self.store.kf_valid[t.ref_kf]:
                    # async mapping finished: re-anchor the bundle
                    with self.store.lock:
                        fe.refresh_bundle(t.ref_kf, rel_pose=t.last_rel)
                # a stale-but-usable bundle still tracks (the reference's
                # tracking thread rides the old map while mapping runs)
                if fe.state is not None:
                    base = self._next_frame_id
                    consumed = t.track_fused_chunk(
                        np.stack(images[i:i + chunk]),
                        timestamps[i:i + chunk], base)
                    self._next_frame_id = base + consumed
                    poses.extend(self._consumed_poses(consumed))
                    i += consumed
                    if consumed == chunk or (consumed > 0
                                             and t.state == "OK"):
                        continue    # full chunk, or mid-chunk KF event
                    # mid-chunk failure: fall through to per-frame path
            poses.append(self.track_monocular(images[i],
                                              timestamp=timestamps[i]))
            i += 1
        return poses

    def _track_batch_pipelined(self, images, timestamps, chunk):
        """Double-buffered chunk pipeline (async-mapping mode).

        Invariants: at most one chunk in flight beyond the one being
        processed, and none while the one being processed may bring a
        keyframe; a chunk is never dispatched before the local mapping of
        a soft keyframe decided in the chunks before it has finished (a
        chunk that rode the map without it drifted 0.4 m against the room
        loop's young map, where the keyframe ATE was 7 mm); frame-id
        assignment advances at dispatch and REWINDS
        on a mid-chunk tracking failure (the prefetched chunk's results
        are discarded and its frames re-enter the per-frame path); the
        device bundle refresh never drains the pipeline — it chains after
        the chunk in flight on the tracking stream."""
        t = self.tracking
        fe = t.fused
        s = self.store
        n = len(images)
        poses: list = []
        i = 0
        pending = None      # (start_i, base_fid, count, handle, ts_slice)

        def can_rebuild():
            # one consistent snapshot vs the worker's atomic publish of
            # (ref_kf, last_kf_frame_id, last_frame) under store.lock
            with s.lock:
                lf = t.last_frame
                return (lf is not None and lf.R is not None
                        and t.ref_kf >= 0 and s.kf_valid[t.ref_kf])

        def refresh_if_stale():
            with s.lock:
                if not fe.ready() and t.ref_kf >= 0 \
                        and s.kf_valid[t.ref_kf]:
                    fe.refresh_bundle_device(t.ref_kf)

        def dispatch(at):
            base = self._next_frame_id
            handle = fe.dispatch_chunk(np.stack(images[at:at + chunk]))
            self._next_frame_id = base + chunk
            return (at, base, chunk, handle, timestamps[at:at + chunk])

        while i < n or pending is not None:
            if pending is None:
                can = t.state == "OK" and n - i >= chunk
                if can and fe.state is None and can_rebuild():
                    with s.lock:
                        self._rebuild_from_last_frame()
                elif can and fe.state is not None:
                    refresh_if_stale()
                if can and fe.state is not None:
                    pending = dispatch(i)
                    i += chunk
                    continue
                poses.append(self.track_monocular(
                    images[i], timestamp=timestamps[i]))
                i += 1
                continue

            # prefetch the next chunk while the pending one cannot bring a
            # keyframe (the worker's queue holds one already): a chunk
            # dispatched before a keyframe it follows is mapped rides a map
            # without it, and tracked against a young map it drifts
            # decimetres in 8 frames. Refresh BEFORE the prefetch dispatch
            # whenever the mapper published.
            nxt = None
            kf_possible = not t.only_tracking and t.async_mapper.queue_idle()
            if n - i >= chunk and not kf_possible:
                refresh_if_stale()
                nxt = dispatch(i)
                i += chunk

            start_p, base_p, cnt_p, handle_p, ts_p = pending
            t0 = time.perf_counter()
            recs = fe.collect_chunk(handle_p)
            ms = (time.perf_counter() - t0) * 1e3 / cnt_p
            epoch0 = fe._bundle_epoch
            consumed = t.track_fused_chunk_async(
                recs, ts_p, base_p, ms_per_frame=ms)
            # a soft keyframe of this chunk: the next chunk tracks against
            # the map with it (its loop closing stays on the worker)
            t.wait_for_keyframe_mapping()
            poses.extend(self._consumed_poses(consumed))
            if consumed < cnt_p:
                # tracking failed mid-chunk (or a hard keyframe broke it):
                # discard the prefetched chunk (its device state mutations
                # die with the rebuild) and re-enter the per-frame path at
                # that frame
                self._next_frame_id = base_p + consumed
                i = start_p + consumed
                pending = None
                continue
            if fe._bundle_epoch != epoch0 and nxt is not None:
                # a HARD keyframe event rebuilt the device bundle while
                # the prefetched chunk was in flight: that chunk rode the
                # PRE-rebuild map mid-collapse. Discard it and re-dispatch
                # against the fresh bundle.
                self._next_frame_id = nxt[1]
                i = nxt[0]
                nxt = None
            # mapping wrote since this bundle was built: swap in the
            # current map (device-side, chains after the chunk in flight)
            refresh_if_stale()
            pending = nxt
        return poses

    def track_stereo(self, left_u8, right_u8, timestamp=0.0):
        """Parity: System::TrackStereo — ORB on both images, the stereo
        match and its subpixel refinement, then per-frame tracking.
        Returns Tcw (4x4) or None. The ms of the feature stage (both
        extractions, the match and the refinement; a readback ends it)
        lands in the frame's metrics record as t_features_ms."""
        from ..frontend.stereo import stereo_frame_features
        t0 = time.perf_counter()
        feats, uvr, depth = stereo_frame_features(self, left_u8, right_u8)
        self.tracking._dbg["t_features_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 2)
        frame = self.make_frame(features=feats, timestamp=timestamp,
                                uvr=uvr, depth=depth)
        return self._track_with_depth(frame)

    def track_rgbd(self, image_u8=None, depth_m=None, timestamp=0.0,
                   features=None, kp_depth=None):
        """Parity: System::TrackRGBD — depth in meters (already scaled).
        kp_depth: optional per-keypoint depth (skips depth-map sampling,
        for feature-level synthetic pipelines). The depth map is sampled
        on the host at the rounded keypoint (numpy's round half to even),
        as in the JAX package. The ORB extraction's ms (a readback ends
        it) lands in the frame's metrics record as t_features_ms."""
        t0 = time.perf_counter()
        frame = self.make_frame(image_u8, features, timestamp)
        if features is None:
            self.tracking._dbg["t_features_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 2)
        if kp_depth is not None:
            z = np.asarray(kp_depth, np.float32)[:len(frame.uv)]
        else:
            # sample depth at keypoint locations -> stereo-equivalent uvr
            d = np.asarray(depth_m)
            ui = np.clip(frame.uv[:, 0].round().astype(int), 0,
                         d.shape[1] - 1)
            vi = np.clip(frame.uv[:, 1].round().astype(int), 0,
                         d.shape[0] - 1)
            z = d[vi, ui].astype(np.float32)
        if len(z) < len(frame.uv):
            z = np.pad(z, (0, len(frame.uv) - len(z)),
                       constant_values=-1.0)
        good = frame.valid & (z > 0)
        frame.depth = np.where(good, z, -1.0).astype(np.float32)
        if self.cam.bf > 0:
            frame.uvr = np.where(good, frame.uv[:, 0] - self.cam.bf
                                 / np.maximum(z, 1e-6), -1.0
                                 ).astype(np.float32)
        return self._track_with_depth(frame)

    def _track_with_depth(self, frame):
        rec = self.tracking.track(frame)
        self.last_frame = frame
        if rec.get("ok") and frame.R is not None:
            return self._pose_matrix(frame.R, frame.t)
        return None

    def activate_localization_mode(self):
        """Parity: System::ActivateLocalizationMode — track against the
        map without extending it."""
        self.tracking.only_tracking = True

    def deactivate_localization_mode(self):
        self.tracking.only_tracking = False
        self.tracking.vo = False

    def precompile(self, n_frames=40):
        """Build every kernel, warm every device code path and capture
        every CUDA graph the live system can hit, ON THE CALLING THREAD,
        before the mapping worker does any device work.

        Why: the first call of a torch operator loads its CUDA module and
        may allocate or synchronise; the Hamming kernel is compiled by nvcc
        at its first use; a graph capture must not meet either, nor an
        allocation racing in from the worker's stream. After this runs the
        steady state replays graphs only (``compiles_after_warmup`` reads
        0).

        Strategy: drive a THROWAWAY synchronous twin system through a
        short synthetic sequence (the frontend, the initializer, the fused
        chunk and per-frame steps, the whole mapping stage; a depth sensor's
        twin tracks a rendered stereo pair sequence through track_stereo,
        or track_rgbd with the stereo depth per keypoint, so the second
        extraction, the stereo match and the depth keyframe path run on
        this thread too), touch the
        async-only paths with dummy-shaped calls (the pipelined device
        refresh, the deferred-keyframe pose re-alignment), then capture
        this system's own frame step. With a relocalizer the twin is sent
        LOST once on its last image, so the whole relocalization path
        (vocabulary matmul, scoring, brute-force search, the batched
        eigh/svd of the PnP and their cuSOLVER handles, both pose
        optimizations, the top-up search) has run eagerly before the steady
        state; none of it is captured. With a loop closer the twin also
        runs the loop stages on dummy inputs of the real shapes (Sim3
        RANSAC, both searches, the Sim3 Gauss-Newton), the vocabulary
        assignment, a background global BA over its map (dispatch thread,
        side stream, write-back) and the essential graph at the first edge
        bucket; and the live system's mapping worker runs the loop stages
        once on its own thread and stream, whose cuBLAS and cuSOLVER
        handles are its own."""
        from ..data import synthetic
        from ..frontend.stereo import stereo_frame_features
        from .tracking import _bound_pose_opt

        cfg = copy.copy(self.cfg)
        cfg.async_mapping = False
        twin = SlamSystem(self.cam, cfg, device=self.device, seed=self.seed)
        if cfg.sensor == MONOCULAR:
            imgs, _, _ = synthetic.render_plane_sequence(
                self.cam, n_frames=n_frames, seed=123, motion=0.45)
            twin.track_monocular_batch(
                list(imgs), timestamps=[i / 30.0 for i in range(n_frames)],
                chunk=8)
            track = twin.track_monocular
        else:
            imgs, right, _, _ = synthetic.render_stereo_plane_sequence(
                self.cam, n_frames=n_frames, seed=123, motion=0.45)

            def track(img, timestamp):
                i = min(int(round(timestamp * 30.0)), n_frames - 1)
                if cfg.sensor == STEREO:
                    return twin.track_stereo(img, right[i], timestamp)
                _, _, depth = stereo_frame_features(twin, img, right[i])
                return twin.track_rgbd(img, timestamp=timestamp,
                                       kp_depth=depth)
            for i in range(n_frames):
                track(imgs[i], i / 30.0)
        # per-frame fused step
        track(imgs[-1], timestamp=n_frames / 30.0)
        fe = twin.tracking.fused
        if fe is not None and fe.state is not None \
                and twin.tracking.ref_kf >= 0:
            with twin.store.lock:
                fe.refresh_bundle_device(twin.tracking.ref_kf)
        # deferred/hard keyframe pose re-alignment: async-only, so the
        # synchronous twin never runs it
        P = self.cfg.tracking.max_kp
        dev = self.device
        _bound_pose_opt(
            self.cam, torch.eye(3, device=dev), torch.zeros(3, device=dev),
            torch.zeros((P, 3), device=dev), torch.zeros((P, 2), device=dev),
            torch.zeros(P, dtype=torch.int32, device=dev),
            torch.zeros(P, dtype=torch.bool, device=dev))
        # the per-frame (non-fused) stages: the live system falls back to
        # them on any tracking failure
        t = twin.tracking
        t.fused = None
        for j in range(2):       # motion-model path (static camera: OK)
            track(imgs[-1], timestamp=(n_frames + 1 + j) / 30.0)
        t.velocity = None        # forces the reference-keyframe fallback
        track(imgs[-1], timestamp=(n_frames + 3) / 30.0)
        if t.relocalizer is not None and twin.store.n_keyframes() > 0:
            t.state = "LOST"     # the relocalization path, eagerly
            t.velocity = None
            track(imgs[-1], timestamp=(n_frames + 4) / 30.0)
        if twin.tracking.loop_closer is not None:
            self._warm_loop_legs(twin)
        twin.shutdown()
        del twin, fe
        am = self.tracking.async_mapper
        if self.tracking.loop_closer is not None and am is not None:
            am.submit_task(self._warm_worker)
            am.join()
        if self.tracking.fused is not None:
            self.tracking.fused.warm()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.captures_at_warmup = self.n_captures

    @staticmethod
    def _warm_loop_legs(twin):
        """The loop closer's legs of precompile, run on a twin system."""
        from ..estimation.pose_graph import optimize_essential_graph
        from ..loop.vocab_train import assign_words
        lc = twin.tracking.loop_closer
        lc.precompile()
        assign_words(np.zeros((1, H.DESC_BITS), np.int8), lc.kfdb.vocab.signs)
        lc.gba.launch()
        lc.gba.poll(block=True)
        dev = twin.device
        K = twin.store.cfg.max_keyframes
        E = 64                      # first edge-axis bucket
        eye = torch.eye(3, device=dev)
        ar_k = torch.arange(K, device=dev)
        optimize_essential_graph(
            eye.expand(K, 3, 3), torch.zeros((K, 3), device=dev),
            torch.ones(K, device=dev), ar_k < 2, ar_k == 0,
            torch.zeros(E, dtype=torch.int32, device=dev),
            torch.ones(E, dtype=torch.int32, device=dev),
            eye.expand(E, 3, 3), torch.zeros((E, 3), device=dev),
            torch.ones(E, device=dev), torch.arange(E, device=dev) < 1,
            n_iters=20, fix_scale=lc.cfg.fix_scale)

    def _warm_worker(self):
        """Run on the mapping worker by precompile: the loop stages on its
        thread and stream. Returns None (no keyframe to map)."""
        self.tracking.loop_closer.precompile()
        return None

    @property
    def n_captures(self) -> int:
        """CUDA graphs captured so far (0 on the CPU)."""
        fe = self.tracking.fused
        return 0 if fe is None else fe.n_captures

    @property
    def captures_after_warmup(self):
        """Graphs captured since precompile(): the port's counterpart of
        the JAX bench's ``compiles_after_warmup``. None before precompile."""
        if self.captures_at_warmup is None:
            return None
        return self.n_captures - self.captures_at_warmup

    def reset(self):
        """Parity: System::Reset."""
        self.tracking.reset()

    def shutdown(self):
        """Parity: System::Shutdown — joins the mapping worker (raising
        what it died of, if it did), waits for (and applies) a pending
        background global BA, and waits for the device's queued work."""
        am = self.tracking.async_mapper
        if am is not None:
            am.join()
        lc = self.tracking.loop_closer
        if lc is not None:
            lc.gba.poll(block=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # map checkpoint (the JAX package's format)
    # ------------------------------------------------------------------
    def save_map(self, path):
        from ..mapstore.checkpoint import save_map
        save_map(self.store, path)

    def load_map(self, path, localization_only=True):
        """Restore a saved map (either package's file) into the live store;
        by default enter localization-only mode (track against the loaded
        map without extending it). Parity with the JAX package's load_map
        (slam.py:554-573), which swaps the store's whole ``__dict__`` (its
        lock included, under a running worker) and rebuilds the database
        only with a loop closer. Here the mapping worker is drained and a
        background BA dropped first, the arrays are copied into the live
        store under its own lock and its version bumped; every cache of the
        old map goes (the local-bundle cache, the mapper's recent
        landmarks, the last frame and the velocity, the fused state,
        rebuilt after the first relocalization); and the shared
        place-recognition database is rebuilt from the loaded keyframes
        whenever the system has one, so a relocalizer without a loop
        closer searches the loaded map too (ROADMAP.md §3)."""
        from ..mapstore.checkpoint import _ARRAYS, load_map
        loaded = load_map(path)
        s, t = self.store, self.tracking
        if loaded.cfg.max_keyframes != s.cfg.max_keyframes \
                or loaded.cfg.max_map_points != s.cfg.max_map_points \
                or loaded.cfg.max_kp != s.cfg.max_kp \
                or loaded.cfg.max_obs != s.cfg.max_obs:
            raise ValueError(f"{path}: map capacities {loaded.cfg} do not "
                             f"match this system's {s.cfg}")
        if t.async_mapper is not None:
            t.async_mapper.join()
        if t.loop_closer is not None:
            t.loop_closer.gba.abort()
        with s.lock:
            for name in _ARRAYS:
                getattr(s, name)[...] = getattr(loaded, name)
            s.mp_replaced[...] = loaded.mp_replaced
            s.mp_free = list(loaded.mp_free)
            s.next_kf = loaded.next_kf
            s.kf_loop_edges = loaded.kf_loop_edges
            s.kf_seq[...] = loaded.kf_seq
            s.n_kf_created = loaded.n_kf_created
            s.kf_free = list(loaded.kf_free)
            s.kf_erased_parent = {}
            s.kf_tombs = {}
            s.bump()
            self.mapper.recent.clear()
            t._local_bundle_cache = None
            if t.fused is not None:
                t.fused.state = None
                t.fused.version = -1
            t.state = "LOST"
            t.velocity = None
            t.last_frame = self.last_frame = None
            t.init_frame = None
            t.vo = False
            t.last_rel = None
            t._fused_prev_pose = None
            t.ref_kf = s.newest_keyframe()
        if t.loop_closer is not None:
            t.loop_closer.reset()       # empties the shared database
        elif self.kfdb is not None:
            self.kfdb.reset()
        if self.kfdb is not None:
            for kf in s.keyframe_ids():
                self.kfdb.add(int(kf))
        if localization_only:
            self.activate_localization_mode()

    # ------------------------------------------------------------------
    # trajectory export (System::SaveTrajectory* parity)
    # ------------------------------------------------------------------
    def keyframe_trajectory(self):
        """(timestamps, R_wc, t_wc) over live keyframes in creation order
        (id order until a keyframe slot is reused)."""
        s = self.store
        ids = s.keyframe_ids()
        ids = ids[np.argsort(s.kf_seq[ids], kind="stable")]
        R_cw = s.kf_R[ids]
        t_cw = s.kf_t[ids]
        R_wc = np.swapaxes(R_cw, -1, -2)
        t_wc = -(R_wc @ t_cw[..., None])[..., 0]
        return s.kf_timestamp[ids], R_wc, t_wc

    def frame_trajectory(self):
        """Per-frame camera-to-world poses for all tracked frames,
        re-composed against the FINAL (BA-refined) reference-KF poses.
        Parity: System::SaveTrajectoryTUM's Tcr * Trw recomposition; a
        frame whose reference keyframe's slot was reused goes through the
        erased keyframe's parent (SaveTrajectoryTUM's walk over bad
        keyframes, ``MapStore.keyframe_pose``)."""
        s = self.store
        ts, Rs, tss = [], [], []
        for rec in self.tracking.metrics:
            if "R" not in rec or not rec["ok"]:
                continue
            anchor = None
            if "R_cr" in rec and rec.get("ref_kf", -1) >= 0:
                anchor = s.keyframe_pose(rec["ref_kf"], rec["ref_seq"])
            if anchor is not None:
                R_rw, t_rw = anchor
                R_cw = rec["R_cr"] @ R_rw
                t_cw = rec["R_cr"] @ t_rw + rec["t_cr"]
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
