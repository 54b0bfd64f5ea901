"""Depth-constrained tracking: stereo disparity / RGB-D depth
as a per-frame PnP residual, so the second modality constrains pose every
frame (the reference never uses it during tracking,
visual_slam/tracking.py:415-444)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from visual_slam_tpu.camera import PinholeCamera
from visual_slam_tpu.ops.pnp import ransac_pnp, ransac_pnp_depth, refine_pose_gn_depth
from visual_slam_tpu.ops.stereo import (
    backproject_depths,
    sample_depth_at,
    stereo_feature_depths,
)
from visual_slam_tpu.slam import SLAM
from visual_slam_tpu.state import State
from visual_slam_tpu.utils.metrics import ate_rmse, trajectory_from_keyframes

from render import camera_path, make_world, render_with_depth, stereo_pair
from test_slam_e2e import small_config


# -- ops -----------------------------------------------------------------


def test_stereo_feature_depths_exact():
    rng = np.random.default_rng(0)
    K, f, bf = 64, 300.0, 150.0
    z = rng.uniform(2, 20, K).astype(np.float32)
    xy_l = rng.uniform(20, 280, (K, 2)).astype(np.float32)
    xy_r = xy_l.copy()
    xy_r[:, 0] -= bf / z
    desc = rng.integers(0, 2**32, (K, 8), dtype=np.uint32)
    perm = rng.permutation(K)
    res = stereo_feature_depths(
        jnp.asarray(xy_l), jnp.asarray(desc), jnp.ones(K, bool),
        jnp.asarray(xy_r[perm]), jnp.asarray(desc[perm]), jnp.ones(K, bool), bf,
    )
    ok = np.asarray(res["valid"])
    assert ok.sum() >= K - 2  # near-total recovery on clean descriptors
    assert np.abs(np.asarray(res["z"])[ok] - z[ok]).max() < 1e-3


def test_stereo_feature_depths_row_gate():
    """A descriptor twin on a different row must not steal the match."""
    rng = np.random.default_rng(1)
    desc = rng.integers(0, 2**32, (2, 8), dtype=np.uint32)
    desc = np.stack([desc[0], desc[0]])  # identical descriptors
    xy_l = np.array([[100.0, 100.0], [200.0, 150.0]], np.float32)
    # right: correct partner on row 100 at disparity 10; twin far off-row
    xy_r = np.array([[90.0, 100.0], [150.0, 30.0]], np.float32)
    res = stereo_feature_depths(
        jnp.asarray(xy_l), jnp.asarray(desc), jnp.ones(2, bool),
        jnp.asarray(xy_r), jnp.asarray(desc), jnp.ones(2, bool),
        bf=100.0, ratio=0.0, cross_check=False,
    )
    assert bool(res["valid"][0])
    assert int(res["right_idx"][0]) == 0
    assert not bool(res["valid"][1])  # no row-consistent partner


def test_sample_depth_at_bounds_and_holes():
    depth = np.zeros((40, 60), np.float32)
    depth[10, 20] = 5.0
    xy = jnp.asarray([[20.0, 10.0], [21.0, 10.0], [-3.0, 10.0], [20.0, 100.0]], jnp.float32)
    res = sample_depth_at(jnp.asarray(depth), xy)
    v = np.asarray(res["valid"])
    assert v.tolist() == [True, False, False, False]  # hole + out-of-bounds
    assert float(res["z"][0]) == 5.0


def test_backproject_depths_roundtrip():
    rng = np.random.default_rng(2)
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    pts = rng.uniform(-2, 2, (32, 3))
    pts[:, 2] += 8
    T_c2w = np.eye(4)
    uv = (pts @ K.T)
    uv = uv[:, :2] / uv[:, 2:]
    out = backproject_depths(
        jnp.asarray(np.linalg.inv(K), jnp.float32), jnp.asarray(T_c2w, jnp.float32),
        jnp.asarray(uv, jnp.float32), jnp.asarray(pts[:, 2], jnp.float32),
    )
    np.testing.assert_allclose(np.asarray(out), pts, atol=1e-3)


def test_depth_residual_pins_scale_direction():
    """With noisy 2D and exact depth, the depth-aware GN recovers t_z better
    than reprojection alone on a shallow (z-ambiguous) configuration."""
    rng = np.random.default_rng(3)
    N = 48
    pts = rng.uniform(-0.5, 0.5, (N, 3))
    pts[:, 2] += 10  # narrow cone: weak t_z observability from 2D
    tg = np.array([0.05, -0.02, 0.8])
    pc = pts + tg
    xy = pc[:, :2] / pc[:, 2:]
    xy_noisy = xy + rng.normal(0, 3.0 / 300, xy.shape)
    z = pc[:, 2].astype(np.float32)
    w = jnp.ones(N, jnp.float32)
    R0, t0 = jnp.eye(3), jnp.zeros(3)
    from visual_slam_tpu.ops.pnp import refine_pose_gn

    R1, t1 = refine_pose_gn(R0, t0, jnp.asarray(pts, jnp.float32),
                            jnp.asarray(xy_noisy, jnp.float32), w, iters=10)
    R2, t2 = refine_pose_gn_depth(
        R0, t0, jnp.asarray(pts, jnp.float32), jnp.asarray(xy_noisy, jnp.float32),
        w, jnp.asarray(z), w, baseline=0.5, iters=10,
    )
    ez1 = abs(float(t1[2]) - tg[2])
    ez2 = abs(float(t2[2]) - tg[2])
    assert ez2 < ez1, (ez1, ez2)
    assert ez2 < 0.1  # mono converges to ~0.67 here; depth to ~0.058


def test_ransac_pnp_depth_matches_mono_on_clean_data():
    rng = np.random.default_rng(4)
    N = 128
    pts = rng.uniform(-3, 3, (N, 3))
    pts[:, 2] += 10
    tg = np.array([0.3, -0.1, 0.5])
    pc = pts + tg
    xy = pc[:, :2] / pc[:, 2:]
    key = jax.random.PRNGKey(0)
    res = ransac_pnp_depth(
        jnp.asarray(pts, jnp.float32), jnp.asarray(xy, jnp.float32),
        jnp.ones(N, bool), jnp.asarray(pc[:, 2], jnp.float32), jnp.ones(N, bool),
        0.5, key, n_hyp=64,
    )
    assert bool(res["ok"]) and int(res["n_inliers"]) >= N - 2
    np.testing.assert_allclose(np.asarray(res["t"]), tg, atol=2e-3)
    np.testing.assert_allclose(np.asarray(res["R"]), np.eye(3), atol=2e-3)


# -- e2e ablation ----------------------------------------------------------


def _run(sensor: str, use_depth: bool, n=20, step=0.35, seed=5):
    rng = np.random.default_rng(seed)
    world = make_world(rng)
    Ts = camera_path(n, step=step, yaw_rate=0.01)
    f, W, H = 260.0, 320, 240
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    cfg = small_config()
    cfg.camera.sensor_type = sensor
    cfg.initialization.min_inliers = 30
    cfg.tracking.use_depth_residual = use_depth
    cam = PinholeCamera(width=W, height=H, K=K, baseline=0.5)
    slam = SLAM(cam, cfg)
    for i, T in enumerate(Ts):
        if sensor == "stereo":
            left, right = stereo_pair(world, T, K, 0.5, W, H)
            slam.track([left, right], timestamp=i * 0.1)
        else:
            img, depth = render_with_depth(world, T, K, W, H)
            slam.track([img], timestamp=i * 0.1, depth=depth)
    assert slam.state == State.OK
    kfs = slam.map.get_keyframes()
    est = trajectory_from_keyframes(kfs)
    idx = [int(round(kf.timestamp / 0.1)) for kf in kfs]
    gt = np.stack([-Ts[i][:3, :3].T @ Ts[i][:3, 3] for i in idx])
    return ate_rmse(est, gt, align_scale=False)["rmse"]


@pytest.mark.slow
def test_stereo_depth_residual_metric_accuracy():
    """Depth-constrained stereo tracking stays metric-accurate end to end
    (NO scale alignment). History: pre-landmark-fusion the ablation margin
    was 2.1x (0.067 vs 0.142 ATE); fusion lifted the mono-core baseline so
    far that the on/off ordering is now inside f32 run-to-run noise on this
    short fixture, so the e2e gate is absolute — the residual's mechanism-
    level superiority stays covered by
    test_depth_residual_pins_scale_direction (11x t_z error reduction)."""
    ate_on = _run("stereo", True)
    assert ate_on < 0.15, ate_on  # ~2% of the 7m path, metric


@pytest.mark.slow
def test_rgbd_depth_residual_metric_accuracy():
    ate_on = _run("rgbd", True)
    assert ate_on < 0.15, ate_on
