"""On-device SIFT (ops/sift.py): DoG scale-space detection, subpixel
refinement, orientation, and descriptor quality — including a cv2.SIFT
location cross-check (the component the reference delegates to cv2,
visual_slam/feature/feature.py:53-83)."""
import numpy as np
import pytest

import jax.numpy as jnp

from visual_slam_tpu.frontend import BFMatcherL2, feature_factory
from visual_slam_tpu.ops.sift import detect_and_describe_sift

from test_features import textured_image


@pytest.fixture(scope="module")
def dog_feats():
    rng = np.random.default_rng(3)
    img = textured_image(rng, h=160, w=200)
    det = feature_factory("sift", num_features=128, n_octaves=3)
    return img, det, det.detectAndCompute(img)


def test_shapes_and_validity(dog_feats):
    _, _, f = dog_feats
    assert f.xy.shape == (128, 2)
    assert f.desc.shape == (128, 128)
    v = np.asarray(f.valid)
    assert v.sum() > 30
    d = np.asarray(f.desc)[v].view(np.float32)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4)


def test_multi_octave_scales(dog_feats):
    _, _, f = dog_feats
    v = np.asarray(f.valid)
    octs = np.asarray(f.octave)[v]
    assert octs.max() >= 1, "no coarse-octave detections"
    sizes = np.asarray(f.size)[v]
    # Keypoint size must grow with octave (scale-space, not corner reuse).
    assert sizes[octs == octs.max()].mean() > sizes[octs == 0].mean()


def test_shift_equivariance(dog_feats):
    """Detections + descriptors must follow a pure translation: the matched
    displacement field is the applied shift (subpixel refinement included)."""
    img, det, f1 = dog_feats
    f2 = det.detectAndCompute(np.roll(img, 7, axis=1))
    res = BFMatcherL2(ratio=0.8).match(f1, f2)
    ok = np.asarray(res["valid"])
    ti = np.asarray(res["train_idx"])
    assert ok.sum() > 15
    disp = np.asarray(f2.xy)[ti[ok]] - np.asarray(f1.xy)[ok]
    med = np.median(disp, axis=0)
    assert abs(med[0] - 7.0) < 1.0 and abs(med[1]) < 1.0
    # Subpixel quality: most matched keypoints land within 1px of the shift.
    err = np.linalg.norm(disp - np.array([7.0, 0.0]), axis=1)
    assert np.median(err) < 1.0


def test_rotation_matching():
    """Orientation assignment: descriptors still match under an in-plane
    rotation (the property the 36-bin histogram + steered GradHist buys)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    img = textured_image(rng, h=192, w=192)
    M = cv2.getRotationMatrix2D((96, 96), 30.0, 1.0)
    rot = cv2.warpAffine(np.asarray(img, np.float32), M, (192, 192))
    det = feature_factory("sift", num_features=128, n_octaves=3)
    f1 = det.detectAndCompute(img)
    f2 = det.detectAndCompute(rot)
    res = BFMatcherL2(ratio=0.8).match(f1, f2)
    ok = np.asarray(res["valid"])
    ti = np.asarray(res["train_idx"])
    assert ok.sum() > 10
    # Matched points must agree with the rotation map (inliers dominate).
    xy1 = np.asarray(f1.xy)[ok]
    xy2 = np.asarray(f2.xy)[ti[ok]]
    pred = xy1 @ M[:, :2].T + M[:, 2]
    err = np.linalg.norm(pred - xy2, axis=1)
    assert np.median(err) < 2.0


def test_cv2_location_overlap():
    """Cross-check against cv2.SIFT on the same image: a solid fraction of
    our strongest detections sit within 2.5 px of a cv2 SIFT keypoint."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(11)
    img = textured_image(rng, h=160, w=200)
    sift = cv2.SIFT_create(nfeatures=300)
    kps = sift.detect(np.clip(img, 0, 255).astype(np.uint8), None)
    assert len(kps) > 30
    ref = np.array([kp.pt for kp in kps], np.float32)
    f = detect_and_describe_sift(
        jnp.asarray(img, jnp.float32), num_features=128, n_octaves=3
    )
    v = np.asarray(f.valid)
    xy = np.asarray(f.xy)[v]
    resp = np.asarray(f.response)[v]
    top = xy[np.argsort(-resp)[:40]]
    d = np.linalg.norm(top[:, None] - ref[None], axis=2).min(axis=1)
    assert (d < 2.5).mean() > 0.5, f"overlap {(d < 2.5).mean():.2f}"


def test_low_texture_rejection():
    """A flat image yields (almost) no valid detections — the contrast and
    edge gates hold with fixed-K padding."""
    img = np.full((160, 200), 128.0, np.float32)
    f = detect_and_describe_sift(jnp.asarray(img), num_features=64, n_octaves=2)
    assert int(np.asarray(f.valid).sum()) == 0
