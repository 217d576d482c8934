"""The reference fault behind the async leg's exported trajectory, shown on
the JAX package (ROADMAP.md §3, "Reference faults repaired in the port"),
on tests/test_torch_async.py's sequence (in a file of its own so that the
two run on two test workers).
"""
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.mapping.local_mapping import (
    LocalMapperConfig as JMapperConfig)
from ar_orbslam2_tpu.mapstore.map import MapConfig as JMapConfig
from ar_orbslam2_tpu.system.slam import SlamConfig as JSlamConfig
from ar_orbslam2_tpu.system.slam import SlamSystem as JSlamSystem
from ar_orbslam2_tpu.system.tracking import TrackingConfig as JTrackingConfig
from ar_orbslam2_tpu_torch.data import synthetic
from ar_orbslam2_tpu_torch.eval.ate import align_umeyama
from test_torch_async import CAM, CHUNK, EXPORT_GATE, N_FRAMES


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def seq():
    imgs, R_cw, t_cw = synthetic.render_plane_sequence(
        CAM, n_frames=N_FRAMES, seed=7, motion=0.35)
    gt = -(np.swapaxes(R_cw, -1, -2) @ t_cw[..., None])[..., 0]
    return list(imgs), gt


def test_jax_pipeline_tracks_past_a_keyframe_on_the_old_bundle(seq):
    """The reference fault behind the async leg's exported trajectory,
    shown on the JAX package (ROADMAP.md §3, "Reference faults repaired in
    the port"): its pipelined path dispatches the next chunk before it
    reads the current one back, and its worker publishes a soft keyframe's
    landmarks a chunk later still, so on this sequence the chunk after the
    one that decided the first soft keyframe rides the first two
    keyframes' bundle (triangulated on a 2-frame baseline) and its exported
    poses drift past EXPORT_GATE, which the port's runs keep
    (test_frames_after_a_keyframe_track_the_map_that_holds_it)."""
    imgs, gt = seq
    cfg = JSlamConfig(
        map=JMapConfig(max_keyframes=64, max_map_points=20_000, max_kp=512),
        tracking=JTrackingConfig(max_kp=512, n_local_mp=1024,
                                 max_frames_between_kf=30),
        mapper=JMapperConfig(ba_max_points=1024, n_triangulation_neighbors=5,
                             n_fuse_neighbors=5),
        enable_loop_closing=False, enable_relocalization=False,
        use_fused_tracking=True, async_mapping=True)
    slam = JSlamSystem(JCamera(*CAM), cfg)
    slam.track_monocular_batch(imgs, chunk=CHUNK)
    slam.shutdown()
    ts_k, _, t_k = slam.keyframe_trajectory()
    kf_frame = np.round(np.asarray(ts_k) * 30.0).astype(int)
    first = int(kf_frame[2])             # after the two initial keyframes
    s, R, t = align_umeyama(np.asarray(t_k), gt[kf_frame])
    ts, _, t_wc = slam.frame_trajectory()
    idx = np.round(np.asarray(ts) * 30.0).astype(int)
    err = np.linalg.norm(s * np.asarray(t_wc, np.float64) @ R.T + t
                         - gt[idx], axis=1)
    after = (idx > first) & (idx <= first + 2 * CHUNK)
    assert after.sum() == 2 * CHUNK
    # the chunk after the keyframe's rides the initial keyframes' bundle
    init_ref = slam.tracking.metrics[2]["ref_kf"]
    refs = {r["frame_id"]: r.get("ref_kf") for r in slam.tracking.metrics}
    assert [refs[f] for f in range(first + 1, first + 1 + CHUNK)] \
        == [init_ref] * CHUNK
    print("JAX exported error, frames", first + 1, "to", first + 2 * CHUNK,
          np.round(err[after], 4))        # pytest -s shows it
    assert err[after].max() > EXPORT_GATE, np.round(err[after], 4)
