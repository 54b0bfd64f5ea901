"""Float-descriptor family: SIFT detector (cv2-backed) + L2/FLANN matchers."""
import numpy as np
import pytest

from visual_slam_tpu.frontend import BFMatcherL2, FlannMatcher, feature_factory

from test_features import textured_image


@pytest.fixture(scope="module")
def sift_feats(rng=None):
    rng = np.random.default_rng(8)
    try:
        det = feature_factory("sift", num_features=128)
    except Exception as e:  # pragma: no cover
        pytest.skip(f"cv2 SIFT unavailable: {e}")
    img = textured_image(rng, h=160, w=200)
    f1 = det.detectAndCompute(img)
    img2 = np.roll(img, 5, axis=1)
    f2 = det.detectAndCompute(img2)
    return f1, f2


def test_sift_detect_shapes(sift_feats):
    f1, _ = sift_feats
    assert f1.xy.shape == (128, 2)
    assert f1.desc.shape == (128, 128)  # 128 f32 bit-cast into uint32 block
    assert int(np.asarray(f1.valid).sum()) > 20


def test_l2_matcher_self_identity(sift_feats):
    f1, _ = sift_feats
    m = BFMatcherL2(ratio=0.9)
    res = m.match(f1, f1)
    ti = np.asarray(res["train_idx"])
    ok = np.asarray(res["valid"])
    v = np.asarray(f1.valid)
    assert ok[v].mean() > 0.9
    np.testing.assert_array_equal(ti[ok], np.nonzero(np.ones_like(ti))[0][ok])


def test_l2_matcher_shifted(sift_feats):
    f1, f2 = sift_feats
    res = FlannMatcher(ratio=0.8).match(f1, f2)
    ok = np.asarray(res["valid"])
    ti = np.asarray(res["train_idx"])
    assert ok.sum() > 10
    disp = np.asarray(f2.xy)[ti[ok]] - np.asarray(f1.xy)[ok]
    med = np.median(disp, axis=0)
    assert abs(med[0] - 5.0) < 1.5 and abs(med[1]) < 1.5


def test_gradhist_cross_view_matching():
    """On-device float descriptor (ops/floatdesc.py): L2 matching across a
    real viewpoint change on the rendered world."""
    from render import camera_path, make_world, render
    from visual_slam_tpu.frontend.features import GradHistFeature2D
    from visual_slam_tpu.frontend.matcher import BFMatcherL2

    rng = np.random.default_rng(0)
    world = make_world(rng)
    Ts = camera_path(2, step=0.25)
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1.0]])
    img0 = render(world, Ts[0], K, 320, 240)
    img1 = render(world, Ts[1], K, 320, 240)
    det = GradHistFeature2D(num_features=256, fast_threshold=12.0, n_levels=2, grid=4)
    f0 = det.detectAndCompute(img0)
    f1 = det.detectAndCompute(img1)
    r = BFMatcherL2(ratio=0.8).match(f1, f0)
    assert int(np.asarray(r["valid"]).sum()) > 80  # measured 136/256


def test_gradhist_rotation_invariance():
    """Rotating the image 30 deg must preserve matching, and the matched
    point pairs must encode the rotation."""
    from scipy.ndimage import rotate as ndrotate

    from render import camera_path, make_world, render
    from visual_slam_tpu.frontend.features import GradHistFeature2D
    from visual_slam_tpu.frontend.matcher import BFMatcherL2

    rng = np.random.default_rng(0)
    world = make_world(rng)
    Ts = camera_path(1, step=0.25)
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1.0]])
    img0 = render(world, Ts[0], K, 320, 240)
    imgr = ndrotate(img0, 30, reshape=False, order=1, mode="nearest")
    det = GradHistFeature2D(num_features=256, fast_threshold=12.0, n_levels=2, grid=4)
    f0 = det.detectAndCompute(img0)
    fr = det.detectAndCompute(imgr)
    r = BFMatcherL2(ratio=0.8).match(fr, f0)
    ok = np.asarray(r["valid"])
    assert ok.sum() > 80  # measured 167
    ti = np.asarray(r["train_idx"])
    c = np.array([160.0, 120.0])
    a = np.asarray(fr.xy)[ok] - c
    b = np.asarray(f0.xy)[ti[ok]] - c
    th = np.arctan2(a[:, 1], a[:, 0]) - np.arctan2(b[:, 1], b[:, 0])
    med = np.degrees(np.median(np.arctan2(np.sin(th), np.cos(th))))
    assert abs(med + 30.0) < 2.0, med


def test_gradhist_factory_and_shi_tomasi_variant():
    from visual_slam_tpu.frontend.feature_manager import feature_factory
    from visual_slam_tpu.frontend.features import (
        GradHistFeature2D, ShiTomasiGradHistFeature2D,
    )

    assert isinstance(feature_factory("gradhist", num_features=64), GradHistFeature2D)
    det = feature_factory("shi_tomasi_gradhist", num_features=64, fast_threshold=12.0)
    assert isinstance(det, ShiTomasiGradHistFeature2D)
    assert det.fast_threshold == 0.01
    img = np.zeros((96, 128), np.float32) + 100
    img[30:60, 40:80] = 220.0
    f = det.detectAndCompute(img)
    assert int(np.asarray(f.valid).sum()) >= 4
