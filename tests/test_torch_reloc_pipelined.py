"""The port's relocalization on the pipelined path (fused tracking + async
mapping), from pixels on the CPU: the tracker loses a rendered scene by
itself and relocalizes when it comes back (split from
tests/test_torch_reloc.py so that the two run on two test workers).
"""
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.mapping.local_mapping import LocalMapperConfig
from ar_orbslam2_tpu_torch.mapstore.map import MapConfig
from ar_orbslam2_tpu_torch.system.slam import SlamConfig, SlamSystem
from ar_orbslam2_tpu_torch.system.tracking import TrackingConfig


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    """The port's steps are chains of tiny ops: more intra-op threads buy
    nothing and fight the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_pipelined_path_loses_the_scene_and_relocalizes():
    """From pixels, fused tracking + async mapping, chunks of 4: grey frames
    make the tracker lose the scene by itself (a fused chunk fails, its
    frames re-enter the per-frame path and stay LOST, the map is kept);
    resuming at an earlier viewpoint relocalizes on the first frame, the
    fused state is rebuilt from the relocalized frame and chunks resume."""
    from ar_orbslam2_tpu_torch.data import synthetic as tsyn
    from ar_orbslam2_tpu_torch.eval.ate import align_umeyama
    cam = Camera(fx=375.0, fy=375.0, cx=240.0, cy=180.0, width=480,
                 height=360)
    cfg = SlamConfig(
        map=MapConfig(max_keyframes=64, max_map_points=20_000, max_kp=512),
        tracking=TrackingConfig(max_kp=512, n_local_mp=1024,
                                reset_if_lost_before_kfs=1),
        mapper=LocalMapperConfig(ba_max_points=1024,
                                 n_triangulation_neighbors=5,
                                 n_fuse_neighbors=5),
        enable_loop_closing=False, enable_relocalization=True,
        use_fused_tracking=True, async_mapping=True)
    imgs, R_cw, t_cw = tsyn.render_plane_sequence(cam, n_frames=40, seed=7,
                                                  motion=0.35)
    grey = np.full_like(imgs[0], 128)
    src = list(range(24)) + [-1] * 4 + list(range(12, 40))
    feed = [grey if i < 0 else imgs[i] for i in src]
    slam = SlamSystem(cam, cfg, device="cpu")
    poses = slam.track_monocular_batch(feed, chunk=4)
    slam.shutdown()
    t = slam.tracking
    by_fid = {r["frame_id"]: r for r in t.metrics}
    assert [by_fid[i]["state"] for i in range(24, 28)] == ["LOST"] * 4
    assert all(p is None for p in poses[24:28])
    assert t.n_resets == 0 and t.state == "OK"
    assert poses[28] is not None and by_fid[28]["reloc"]["ok"]
    assert by_fid[28]["reloc"]["final_inliers"] >= 50
    assert t.last_reloc_frame_id == 28
    assert all(p is not None for p in poses[28:])
    assert any(by_fid[i].get("chunked") for i in range(29, len(feed)))
    am = t.async_mapper
    assert am.error is None and am.n_processed >= 1
    assert slam.kfdb.has_bow[slam.store.keyframe_ids()].all()
    # the relocalized centre under the alignment fitted before the gap. At
    # this small size (512 keypoints, 24 frames of map) the pre-gap poses
    # themselves are up to 0.09 off under that alignment, so the gate is
    # 0.15 of a 0.35 sweep: it tells the right place from a wrong one
    gt = -(np.swapaxes(R_cw, -1, -2) @ t_cw[..., None])[..., 0]
    pre = [i for i in range(24) if poses[i] is not None]
    est = np.array([-(poses[i][:3, :3].T @ poses[i][:3, 3]) for i in pre])
    sc, Ra, ta = align_umeyama(est, gt[pre], with_scale=True)
    c = -(poses[28][:3, :3].T @ poses[28][:3, 3])
    assert np.linalg.norm(sc * Ra @ c + ta - gt[src[28]]) < 0.15
