"""Float-descriptor family END TO END: the full host SLAM pipeline running
on on-device SIFT (DoG detector + GradHist descriptors, L2-matched).

The reference runs cv2.SIFT through the same SLAM machinery as ORB
(visual_slam/feature/feature_manager.py factory -> tracking); here the
metric dispatch is by descriptor width (ops.matching.is_binary_desc), so
guided matching, stereo gating, and place-recognition signatures all follow
the family with no configuration beyond detector/matcher names."""
import numpy as np
import jax.numpy as jnp
import pytest

from visual_slam_tpu.camera import PinholeCamera
from visual_slam_tpu.config import Config
from visual_slam_tpu.slam import SLAM

from render import render_sequence


def sift_config():
    cfg = Config()
    cfg.feature.detector_name = "sift"
    cfg.feature.matcher_name = "l2"
    cfg.feature.num_features = 384
    cfg.feature.detector_params = dict(n_octaves=3, contrast_threshold=0.02)
    cfg.initialization.min_inliers = 40
    cfg.initialization.min_parallax_deg = 0.5
    cfg.initialization.essential_hypotheses = 128
    cfg.tracking.min_inliers = 10
    cfg.tracking.keyframe_interval = 2
    cfg.tracking.kf_min_matches = 25
    cfg.tracking.pnp_hypotheses = 128
    cfg.optimization.n_iter = 12
    cfg.optimization.window_size = 8
    cfg.local_mapping.max_neighbors = 2
    cfg.local_mapping.min_parallax_deg = 0.3
    return cfg


def test_sift_slam_e2e():
    """Initializes and tracks a 10-frame sprite sequence; guided matching
    and BA run on 128-word float descriptor blocks throughout."""
    rng = np.random.default_rng(42)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=10, step=0.35)
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    slam = SLAM(cam, sift_config())
    states = [slam.track([img], timestamp=i * 0.1)["state"]
              for i, img in enumerate(frames)]
    slam.shutdown()
    assert states[-1] == "OK", states
    assert states[-2] == "OK", states
    assert slam.map.num_keyframes() >= 3
    assert slam.map.num_map_points() > 50
    # Landmark descriptors carry the float width end to end.
    mp = next(iter(slam.map.get_map_points()))
    assert np.asarray(mp.descriptor).reshape(-1).shape[0] == 128


def test_float_signature_discriminates():
    """Place-recognition signatures work for float descriptor blocks: same
    keyframe scores itself above a different view."""
    from visual_slam_tpu.frontend import feature_factory
    from visual_slam_tpu.loop_closing.signature import (
        keyframe_signature, score_signatures,
    )

    rng = np.random.default_rng(7)
    frames, _, _, _ = render_sequence(rng, n_frames=6, step=0.8)
    det = feature_factory("sift", num_features=256, n_octaves=3)
    feats = [det.detectAndCompute(f) for f in (frames[0], frames[1], frames[5])]
    sigs = np.stack([np.asarray(keyframe_signature(f.desc, f.valid)) for f in feats])
    # Query with a slightly perturbed view of frame 0 (re-detected frame 0).
    q = sigs[0]
    scores = score_signatures(q, sigs)
    assert np.argmax(scores) == 0
    assert scores[0] > scores[2]


def test_float_guided_match_roundtrip():
    """guided_match on width-128 blocks: landmarks projected at their true
    pixels match their own descriptors under the L2 metric."""
    from visual_slam_tpu.ops.guided_matching import guided_match

    rng = np.random.default_rng(3)
    M, Kp = 64, 64
    desc = rng.normal(size=(M, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    desc_u32 = desc.view(np.uint32)
    K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]], np.float32)
    pts = np.stack([
        rng.uniform(-0.5, 0.5, M), rng.uniform(-0.4, 0.4, M),
        rng.uniform(4, 8, M)
    ], 1).astype(np.float32)
    uv = (pts[:, :2] / pts[:, 2:3]) * 100.0 + np.array([80.0, 60.0])
    res = guided_match(
        jnp.asarray(pts), jnp.asarray(desc_u32), jnp.ones(M, bool),
        jnp.eye(4), jnp.asarray(K),
        jnp.asarray(uv.astype(np.float32)), jnp.asarray(desc_u32),
        jnp.ones(Kp, bool), 160.0, 120.0, radius_px=5.0,
    )
    ok = np.asarray(res["valid"])
    lm = np.asarray(res["lm_idx"])
    assert ok.sum() > M * 0.9
    assert (lm[ok] == np.nonzero(ok)[0]).mean() > 0.95
