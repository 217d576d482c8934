"""The port's AR layer and drawers against the JAX package.

- plane_ransac on the JAX package's own draw (injected): the inlier mask
  exact, normal and offset within 1e-5; detect_plane's T_pw within 1e-5;
- marker detection on a cv2.aruco-drawn marker: the corners exact; the
  refined marker pose within 1e-4 of the JAX refinement;
- ViewerAR.render, draw_frame and draw_map: the images bit-identical to
  the JAX package's on the same inputs (draw_map on a map the JAX package
  saved and the port loaded).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ar_orbslam2_tpu.ar import marker as jmarker
from ar_orbslam2_tpu.ar import plane as jplane
from ar_orbslam2_tpu.ar.viewer import ViewerAR as JViewerAR
from ar_orbslam2_tpu.core.camera import Camera as JCamera
from ar_orbslam2_tpu.mapstore.checkpoint import save_map as jax_save_map
from ar_orbslam2_tpu.mapstore.map import MapConfig as JMapConfig
from ar_orbslam2_tpu.mapstore.map import MapStore as JMapStore
from ar_orbslam2_tpu.viz.frame_drawer import draw_frame as jax_draw_frame
from ar_orbslam2_tpu.viz.map_drawer import draw_map as jax_draw_map
from ar_orbslam2_tpu_torch.ar import marker, plane
from ar_orbslam2_tpu_torch.ar.viewer import ViewerAR
from ar_orbslam2_tpu_torch.core.camera import Camera
from ar_orbslam2_tpu_torch.mapstore.checkpoint import load_map
from ar_orbslam2_tpu_torch.system.frame import Frame
from ar_orbslam2_tpu_torch.viz import draw_frame, draw_map

TOL_PLANE = 1e-5
TOL_MARKER = 1e-4
CAM = Camera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
JCAM = JCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _plane_points(seed, n_in=200, n_out=60, noise=0.005, n_invalid=15):
    """A noisy plane y = 0.5 with outliers above it, some rows invalid
    (tests/test_ar.py's scene)."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((n_in + n_out, 3), np.float32)
    pts[:n_in, 0] = rng.uniform(-2, 2, n_in)
    pts[:n_in, 2] = rng.uniform(2, 6, n_in)
    pts[:n_in, 1] = 0.5 + rng.normal(0, noise, n_in)
    pts[n_in:] = rng.uniform([-2, -2, 2], [2, 0.3, 6], (n_out, 3))
    valid = np.ones(len(pts), bool)
    valid[rng.choice(len(pts), n_invalid, replace=False)] = False
    return pts, valid


@jax.jit
def _jax_draw(valid, key):
    """The draw inside the JAX plane_ransac (ar/plane.py:29-31)."""
    p = valid.astype(jnp.float32)
    p = p / jnp.maximum(p.sum(), 1.0)
    return jax.random.choice(key, valid.shape[0], (64, 3), replace=True,
                             p=p)


@pytest.mark.parametrize("seed,noise", [(0, 0.005), (1, 0.02), (2, 0.0)])
def test_plane_ransac_matches_jax_on_its_draw(seed, noise):
    pts, valid = _plane_points(seed, noise=noise)
    key = jax.random.PRNGKey(seed)
    ref = jplane.plane_ransac(jnp.asarray(pts), jnp.asarray(valid), key)
    samples = np.array(_jax_draw(jnp.asarray(valid), key))
    got = plane.plane_ransac(torch.as_tensor(pts), torch.as_tensor(valid),
                             torch.as_tensor(samples))
    np.testing.assert_array_equal(got["inlier"].numpy(),
                                  np.asarray(ref["inlier"]))
    np.testing.assert_allclose(got["normal"].numpy(),
                               np.asarray(ref["normal"]), atol=TOL_PLANE)
    np.testing.assert_allclose(float(got["d"]), float(ref["d"]),
                               atol=TOL_PLANE)
    np.testing.assert_allclose(float(got["th"]), float(ref["th"]),
                               atol=TOL_PLANE)


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_plane_matches_jax(seed):
    pts, valid = _plane_points(seed)
    centre = np.array([0, -3.0, 0])
    ref = jplane.detect_plane(pts, valid, cam_center=centre, seed=seed)
    samples = np.array(_jax_draw(jnp.asarray(valid),
                                 jax.random.PRNGKey(seed)))
    got = plane.detect_plane(pts, valid, cam_center=centre, device="cpu",
                             samples=samples)
    np.testing.assert_allclose(got.T_pw, ref.T_pw, atol=TOL_PLANE)
    np.testing.assert_allclose(got.normal, ref.normal, atol=TOL_PLANE)
    # the port's own draw finds the plane too, facing the camera
    own = plane.detect_plane(pts, valid, cam_center=centre, seed=seed,
                             device="cpu")
    assert abs(own.normal[1] + 1.0) < 0.02
    assert abs(own.origin[1] - 0.5) < 0.05
    assert plane.detect_plane(pts, np.zeros_like(valid), device="cpu") \
        is None


def test_draw_samples_only_draws_valid_points():
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 17, 40]] = True
    gen = torch.Generator().manual_seed(0)
    s = plane.draw_samples(valid, 64, gen)
    assert s.shape == (64, 3)
    assert set(s.unique().tolist()) <= {3, 17, 40}


def _marker_image(R, t, size=0.2, marker_id=7):
    """A DICT_4X4_50 marker drawn by cv2.aruco, warped into a 640x480 view
    of the marker plane at pose (R, t)."""
    import cv2
    aruco = cv2.aruco
    px = 200
    img = aruco.generateImageMarker(
        aruco.getPredefinedDictionary(aruco.DICT_4X4_50), marker_id, px)
    img = cv2.copyMakeBorder(img, 40, 40, 40, 40, cv2.BORDER_CONSTANT,
                             value=255)
    # marker pixel (x, y) -> marker-plane point; corners of the black
    # square at +-size/2 (TL, TR, BR, BL as marker_object_points)
    s = size / px
    A = np.array([[s, 0, -size / 2 - 40 * s],
                  [0, -s, size / 2 + 40 * s],
                  [0, 0, 1.0]])
    K = CAM.K.astype(np.float64)
    H = K @ np.column_stack([R[:, 0], R[:, 1], t]) @ A
    return cv2.warpPerspective(img, H, (640, 480), flags=cv2.INTER_LINEAR,
                               borderValue=128)


def test_marker_pose_matches_jax_refinement():
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec([0.25, -0.15, 0.1]).as_matrix() \
        @ np.diag([1.0, -1.0, -1.0])        # the marker faces the camera
    t = np.array([0.05, -0.03, 1.2])
    im = _marker_image(R, t)
    found = marker.detect_markers(im)
    ref_found = jmarker.detect_markers(im)
    assert [m for m, _ in found] == [7] == [m for m, _ in ref_found]
    np.testing.assert_array_equal(found[0][1], ref_found[0][1])
    corners = found[0][1]
    obj = marker.marker_object_points(0.2)
    Rh, th = marker.pose_from_homography(CAM, obj[:, :2], corners)
    Rj, tj = jmarker.pose_from_homography(JCAM, obj[:, :2], corners)
    np.testing.assert_array_equal(Rh, Rj)
    np.testing.assert_array_equal(th, tj)
    got = marker.marker_pose(CAM, corners, 0.2, device="cpu")
    ref = jmarker.marker_pose(JCAM, corners, 0.2)
    np.testing.assert_allclose(got, ref, atol=TOL_MARKER)
    # and the pose is the one the image was drawn at, to the corner
    # detector's accuracy (a fraction of a pixel: under 1 % of the depth)
    np.testing.assert_allclose(got[:3, 3], t, atol=1e-2)
    np.testing.assert_allclose(got[:3, :3], R, atol=2e-2)
    Tcw = np.eye(4, dtype=np.float32)
    Tcw[:3, 3] = [0.1, 0.0, 0.2]
    anchor = marker.MarkerAnchor(CAM, marker_size=0.2, device="cpu")
    janchor = jmarker.MarkerAnchor(JCAM, marker_size=0.2)
    assert anchor.update(im, Tcw) == janchor.update(im, Tcw) == [7]
    np.testing.assert_allclose(anchor.anchors[7], janchor.anchors[7],
                               atol=TOL_MARKER)
    assert anchor.update(im, None) == []


def _coplanar(n=150, seed=1):
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-1, 1, n)
    pts[:, 1] = 0.8
    pts[:, 2] = rng.uniform(3, 5, n)
    return pts


def test_viewer_render_is_bit_identical_to_jax():
    from scipy.spatial.transform import Rotation
    pts = _coplanar()
    valid = np.ones(len(pts), bool)
    Tcw = np.eye(4, dtype=np.float32)
    # exactly coplanar points: every hypothesis keeps all of them, so both
    # draws give the JAX package's plane
    viewer = ViewerAR(cam=CAM, device="cpu")
    jviewer = JViewerAR(cam=JCAM)
    assert viewer.add_cube(pts, valid, Tcw=Tcw, size=0.2) is not None
    assert jviewer.add_cube(pts, valid, Tcw=Tcw, size=0.2) is not None
    viewer.add_cube(pts, valid, Tcw=Tcw, size=0.1, seed=3)
    jviewer.add_cube(pts, valid, Tcw=Tcw, size=0.1, seed=3)
    np.testing.assert_array_equal(viewer.cubes[0].T_ow, jviewer.cubes[0].T_ow)
    rng = np.random.default_rng(4)
    im = rng.integers(0, 256, (480, 640), dtype=np.uint8)
    uv = rng.uniform([-5, -5], [645, 485], (300, 2))
    for k, state in enumerate(["OK", "OK", "LOST", "NOT_INITIALIZED"]):
        T = Tcw.copy()
        T[:3, :3] = Rotation.from_rotvec([0.05 * k, -0.03, 0.02]).as_matrix()
        T[:3, 3] = [0.1 * k, -0.05, 0.3]
        for pose, dots in ((T, uv), (None, None), (T, None)):
            a = viewer.render(im, pose, tracked_uv=dots, state=state,
                              n_tracked=k * 11)
            b = jviewer.render(im, pose, tracked_uv=dots, state=state,
                               n_tracked=k * 11)
            assert a.shape == (502, 640, 3)
            np.testing.assert_array_equal(a, b)
            assert viewer.status == jviewer.status
    viewer.clear()
    assert not viewer.cubes and viewer.plane is None


def test_draw_frame_is_bit_identical_to_jax():
    rng = np.random.default_rng(5)
    P = 512
    uv = rng.uniform(-3, 643, (P, 2)).astype(np.float32)
    valid = rng.random(P) < 0.8
    mp = np.where(rng.random(P) < 0.4, rng.integers(0, 999, P), -1)
    frame = Frame(uv=uv, desc_bits=np.zeros((P, 256), np.uint8),
                  octave=np.zeros(P, np.int32), valid=valid, mp=mp)
    jframe = types.SimpleNamespace(uv=uv, valid=valid, mp=mp)
    im = rng.integers(0, 256, (480, 640), dtype=np.uint8)
    for state in ("OK", "LOST"):
        a = draw_frame(im, frame, state=state, n_kf=4, n_mp=812)
        b = jax_draw_frame(im, jframe, state=state, n_kf=4, n_mp=812)
        assert a.shape == (502, 640, 3)
        np.testing.assert_array_equal(a, b)


def _jax_map(tmp_path):
    """A JAX MapStore with 6 keyframes along a path, shared landmarks and
    covisibility, one keyframe erased; saved by the JAX package."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(6)
    P = 64
    s = JMapStore(JMapConfig(max_keyframes=16, max_map_points=512,
                             max_kp=P, max_obs=8))
    kfs = []
    for k in range(6):
        R = Rotation.from_rotvec([0, 0.2 * k, 0]).as_matrix().astype(
            np.float32)
        t = np.array([0.3 * k, 0.0, 0.1 * k], np.float32)
        kfs.append(s.add_keyframe(
            R, t, rng.uniform(0, 640, (P, 2)).astype(np.float32),
            rng.integers(0, 256, (P, 32)).astype(np.uint8),
            np.zeros(P, np.int32), np.ones(P, bool), timestamp=k / 30.0))
    ids = s.add_map_points(rng.normal([0, 0, 4], 1.5, (200, 3)).astype(
        np.float32), rng.integers(0, 256, (200, 32)).astype(np.uint8))
    for k in kfs:
        sel = rng.choice(200, 40, replace=False)
        s.add_observations(ids[sel], k, np.arange(40))
    for k in kfs:
        s.update_connections(k)
    s.erase_keyframe(kfs[3])
    path = str(tmp_path / "jax_map.npz")
    jax_save_map(s, path)
    return s, path


def test_draw_map_is_bit_identical_to_jax_on_a_jax_saved_map(tmp_path):
    jstore, path = _jax_map(tmp_path)
    store = load_map(path)
    np.testing.assert_array_equal(store.keyframe_ids(), jstore.keyframe_ids())
    for kw in (dict(), dict(current_kf=4), dict(axes=(0, 1), size=320),
               dict(draw_covis=False)):
        a = draw_map(store, **kw)
        b = jax_draw_map(jstore, **kw)
        np.testing.assert_array_equal(a, b)
    assert (a != 255).any()
