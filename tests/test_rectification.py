"""Stereo rectification from a raw K1/K2/R/T rig + dense undistort/remap
(ops/rectify.py): rigs that are not pre-rectified, and the dense
undistortion path."""
import numpy as np
import pytest

from visual_slam_tpu.io.calibration import MonoCalibration, StereoCalibration
from visual_slam_tpu.ops.rectify import (
    rectify_pixels,
    remap_bilinear,
    stereo_rectify,
    undistort_rectify_map,
)


def _rot(axis, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    if axis == "x":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


@pytest.fixture()
def rig():
    """Unrectified EuRoC-style rig: right camera slightly rotated, both
    cameras mildly distorted; x2 = R x1 + T convention."""
    K1 = np.array([[320.0, 0, 160], [0, 320.0, 120], [0, 0, 1]])
    K2 = np.array([[330.0, 0, 165], [0, 330.0, 118], [0, 0, 1]])
    D1 = np.array([-0.12, 0.03, 0.0005, -0.0004, 0.0])
    D2 = np.array([-0.10, 0.025, -0.0003, 0.0005, 0.0])
    R = _rot("y", 1.5) @ _rot("x", -0.8) @ _rot("z", 0.5)
    C2 = np.array([0.11, 0.002, -0.004])  # right camera center in left frame
    T = -R @ C2
    return K1, D1, K2, D2, R, T


def _project_raw(K, D, pts_cam):
    """Ground-truth raw-image projection incl. distortion (host math)."""
    from visual_slam_tpu.ops.projection import denormalize_points, distort_normalized

    xy = pts_cam[:, :2] / pts_cam[:, 2:3]
    xy_d = np.asarray(distort_normalized(D.astype(np.float32), xy.astype(np.float32)))
    return np.asarray(denormalize_points(K.astype(np.float32), xy_d))


def _assert_rows_align_and_disparity_is_metric(K1, D1, K2, D2, R, T):
    rect = stereo_rectify(K1, D1, K2, D2, R, T)
    rng = np.random.default_rng(0)
    pts1 = np.stack(
        [rng.uniform(-1.5, 1.5, 64), rng.uniform(-1.0, 1.0, 64), rng.uniform(4, 25, 64)], 1
    )
    pts2 = pts1 @ R.T + T
    assert (pts2[:, 2] > 0).all()
    uv1 = _project_raw(K1, D1, pts1)
    uv2 = _project_raw(K2, D2, pts2)
    r1 = np.asarray(rectify_pixels(
        K1.astype(np.float32), D1.astype(np.float32),
        np.asarray(rect["R1"], np.float32), np.asarray(rect["K_new"], np.float32),
        uv1.astype(np.float32),
    ))
    r2 = np.asarray(rectify_pixels(
        K2.astype(np.float32), D2.astype(np.float32),
        np.asarray(rect["R2"], np.float32), np.asarray(rect["K_new"], np.float32),
        uv2.astype(np.float32),
    ))
    # Row alignment: the whole point of rectification.
    assert np.abs(r1[:, 1] - r2[:, 1]).max() < 0.1, np.abs(r1[:, 1] - r2[:, 1]).max()
    # Metric disparity: z in the RECTIFIED left frame.
    z_rect = pts1 @ np.asarray(rect["R1"])[2]
    disparity = r1[:, 0] - r2[:, 0]
    f_new = rect["K_new"][0, 0]
    z_from_d = f_new * rect["baseline"] / disparity
    assert np.abs(z_from_d - z_rect).max() < 0.05 * z_rect.max()


def test_rectified_rows_align_and_disparity_is_metric(rig):
    """After sparse rectification, corresponding points land on the SAME row
    in both rectified images, and disparity = f_new * baseline / z_rect."""
    K1, D1, K2, D2, R, T = rig
    _assert_rows_align_and_disparity_is_metric(K1, D1, K2, D2, R, T)


def test_negative_x_rig_disparity_is_metric(rig):
    """A rig whose second camera sits at NEGATIVE x in left-camera
    coordinates (swapped wiring) must still yield positive metric disparity:
    rectified +x rides the actual baseline direction so camera 2 always
    lands at +baseline, as P2/Q encode (ADVICE r3: an e1 sign flip put such
    rigs' second camera at -baseline and broke the disparity sign)."""
    K1, D1, K2, D2, R, _ = rig
    C2 = np.array([-0.11, 0.002, -0.004])
    T = -R @ C2
    _assert_rows_align_and_disparity_is_metric(K1, D1, K2, D2, R, T)


def test_dense_remap_matches_sparse_rectification(rig):
    """Dense path: remapping the raw image through undistort_rectify_map
    must place a bright blob where sparse rectification says its center
    goes."""
    K1, D1, K2, D2, R, T = rig
    rect = stereo_rectify(K1, D1, K2, D2, R, T)
    H, W = 240, 320
    pt_cam = np.array([[0.35, -0.2, 6.0]])
    uv_raw = _project_raw(K1, D1, pt_cam)[0]
    img = np.zeros((H, W), np.float32)
    iy, ix = int(round(uv_raw[1])), int(round(uv_raw[0]))
    img[iy - 2 : iy + 3, ix - 2 : ix + 3] = 255.0
    smap = undistort_rectify_map(
        K1.astype(np.float32), D1.astype(np.float32),
        np.asarray(rect["R1"], np.float32), np.asarray(rect["K_new"], np.float32),
        H, W,
    )
    out = np.asarray(remap_bilinear(img, smap))
    peak = np.unravel_index(np.argmax(out), out.shape)
    expect = np.asarray(rectify_pixels(
        K1.astype(np.float32), D1.astype(np.float32),
        np.asarray(rect["R1"], np.float32), np.asarray(rect["K_new"], np.float32),
        uv_raw[None].astype(np.float32),
    ))[0]
    assert abs(peak[0] - expect[1]) <= 2 and abs(peak[1] - expect[0]) <= 2


def test_identity_rig_is_noop():
    """A KITTI-style already-rectified rig must pass through unchanged (up
    to the shared-K averaging)."""
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    rect = stereo_rectify(K, np.zeros(5), K, np.zeros(5), np.eye(3),
                          np.array([-0.5, 0, 0]))
    assert np.allclose(rect["R1"], np.eye(3), atol=1e-9)
    assert np.allclose(rect["R2"], np.eye(3), atol=1e-9)
    assert abs(rect["baseline"] - 0.5) < 1e-12
    assert np.allclose(rect["K_new"], K)
    calib = StereoCalibration(
        left=MonoCalibration(K=K), right=MonoCalibration(K=K),
        R=np.eye(3), T=np.array([-0.5, 0, 0]),
    )
    assert calib.is_rectified


def test_unrectified_rig_stereo_depth_end_to_end(rig):
    """The full scenario: an unrectified synthetic rig loaded
    as io.calibration.StereoCalibration -> dense rectify_images -> detector
    -> row-gated stereo matcher recovers METRIC depth."""
    import jax

    from visual_slam_tpu.ops.detector import detect_and_describe
    from visual_slam_tpu.ops.stereo import stereo_feature_depths

    K1, D1, K2, D2, R, T = rig
    calib = StereoCalibration(
        left=MonoCalibration(K=K1, D=D1), right=MonoCalibration(K=K2, D=D2),
        R=R, T=T,
    )
    assert not calib.is_rectified
    H, W = 240, 320
    rng = np.random.default_rng(5)
    # Sprite world rendered through BOTH raw (distorted, rotated) cameras.
    pts = np.stack(
        [rng.uniform(-4, 4, 160), rng.uniform(-3, 3, 160), rng.uniform(5, 20, 160)], 1
    )
    intens = rng.uniform(60, 255, 160)

    def render_raw(K, D, pts_cam):
        img = np.full((H, W), 30.0, np.float32)
        uv = _project_raw(K, D, pts_cam)
        s = 320.0 * 0.08 / pts_cam[:, 2]
        order = np.argsort(-pts_cam[:, 2])
        for i in order:
            if pts_cam[i, 2] < 1:
                continue
            x0, x1 = int(uv[i, 0] - s[i]), int(np.ceil(uv[i, 0] + s[i]))
            y0, y1 = int(uv[i, 1] - s[i]), int(np.ceil(uv[i, 1] + s[i]))
            if x1 <= 0 or y1 <= 0 or x0 >= W or y0 >= H:
                continue
            img[max(y0, 0) : y1, max(x0, 0) : x1] = intens[i]
        return img

    img_l = render_raw(K1, D1, pts)
    img_r = render_raw(K2, D2, pts @ R.T + T)
    rl, rr, K_new, baseline = calib.rectify_images(img_l, img_r)
    feats_l = detect_and_describe(rl, num_features=128, threshold=15.0, n_levels=2)
    feats_r = detect_and_describe(rr, num_features=128, threshold=15.0, n_levels=2)
    bf = float(K_new[0, 0]) * baseline
    sd = stereo_feature_depths(
        feats_l.xy, feats_l.desc, feats_l.valid,
        feats_r.xy, feats_r.desc, feats_r.valid,
        bf, row_tolerance=2.0, max_disparity=bf / 0.5,
    )
    z = np.asarray(sd["z"])
    ok = np.asarray(sd["valid"]) & np.asarray(feats_l.valid)
    assert ok.sum() >= 20, int(ok.sum())
    # Measured depths must sit in the world's 5-20 m band. The 0.11 m
    # baseline gives ~1.8 px disparity at 20 m, so a 1 px subpixel error is
    # ~50% depth error at the far end — gate on the fraction in band, not
    # the extremes.
    in_band = (z[ok] > 4.0) & (z[ok] < 26.0)
    assert in_band.mean() > 0.8, (in_band.mean(), z[ok].min(), z[ok].max())
