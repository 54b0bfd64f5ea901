"""Loopy endurance run: a 100-frame circular trajectory that
revisits its start, with photometric noise + brightness drift and a 3-frame
texture blackout mid-run. One run must survive LOST -> relocalize, close a
real loop, and the loop closure must measurably beat the no-loop-closure
ablation on final ATE.

(The 200-frame variant of the same scenario lives in
scripts/exp_loop_endurance.py; measured there: loop ON 0.46% of path vs
OFF 0.96% post-landmark-fusion, 1 closure after the cooldown fix,
relocalization through the blackout.)"""
import numpy as np
import pytest

from visual_slam_tpu.camera import PinholeCamera
from visual_slam_tpu.config import Config
from visual_slam_tpu.slam import SLAM
from visual_slam_tpu.state import State
from visual_slam_tpu.utils.metrics import ate_rmse, trajectory_from_keyframes

from render import loop_path, make_ring_world, render

N = 100
STEP = 0.25
W, H, F = 320, 240, 260.0
BLACKOUT = range(60, 63)


@pytest.fixture(scope="module")
def loop_sequence():
    rng = np.random.default_rng(11)
    Ts = loop_path(N, step=STEP, closes=1.06)
    yaw_rate = 2 * np.pi * 1.06 / N
    radius = STEP / (2 * np.sin(yaw_rate / 2))
    world = make_ring_world(
        rng, np.array([-radius, 0.0, 0.0]), radius + 3.0, radius + 13.0
    )
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
    frames = []
    for i, T in enumerate(Ts):
        if i in BLACKOUT:
            img = np.full((H, W), 110.0, np.float32)  # texture blackout
        else:
            img = render(world, T, K, W, H)
        img = img * (1.0 + 0.05 * np.sin(2 * np.pi * i / 50.0))  # exposure drift
        img = img + rng.normal(0, 2.0, img.shape)  # sensor noise
        frames.append(np.clip(img, 0, 255).astype(np.float32))
    return frames, Ts, K


def _config(loop_on: bool) -> Config:
    cfg = Config()
    cfg.feature.num_features = 320
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 40
    cfg.tracking.keyframe_interval = 2
    cfg.tracking.kf_min_matches = 25
    cfg.optimization.window_size = 6
    cfg.optimization.ba_every_n_keyframes = 2
    cfg.map.cull_redundant_keyframes = True
    cfg.map.min_keyframes_before_cull = 6
    cfg.map.max_landmarks = 2500
    cfg.loop_closing.enabled = loop_on
    return cfg


def _run(loop_on: bool, seq):
    frames, Ts, K = seq
    cam = PinholeCamera(width=W, height=H, K=K)
    slam = SLAM(cam, _config(loop_on))
    lost = reloc = 0
    for i, img in enumerate(frames):
        info = slam.track([img], timestamp=i * 0.1)
        if info.get("state") == "LOST":
            lost += 1
        if info.get("relocalized"):
            reloc += 1
    slam.shutdown()
    kfs = slam.map.get_keyframes()
    est = trajectory_from_keyframes(kfs)
    idx = [int(round(kf.timestamp / 0.1)) for kf in kfs]
    gt = np.stack([-Ts[i][:3, :3].T @ Ts[i][:3, 3] for i in idx])
    ate = ate_rmse(est, gt, align_scale=True)["rmse"]
    loops = len(slam.loop_closing.closed_loops) if slam.loop_closing else 0
    return {
        "ate": ate, "lost": lost, "reloc": reloc, "loops": loops,
        "final": slam.state, "kfs": len(kfs),
    }


@pytest.fixture(scope="module")
def loop_on_run(loop_sequence):
    return _run(True, loop_sequence)


@pytest.mark.slow
def test_survives_blackout_and_relocalizes(loop_on_run):
    r = loop_on_run
    assert r["final"] == State.OK, r
    assert r["reloc"] >= 1, r  # recovered from the blackout by relocalizing
    # Two legitimate recovery modes. (a) Immediate: relocalize against the
    # pre-blackout keyframes in the 1-2 frames after it ends — this window
    # is razor-thin BY WORLD PHYSICS (render.py matches decay ~40%/frame,
    # so frame 63 vs a KF from frame ~58 yields ~5 descriptor matches,
    # below any PnP minimum); whether a run catches it flips with f32
    # summation order. (b) Global re-entry: the camera traverses the
    # unvisited arc LOST and the signature-shortlist relocalization
    # (tracking._reloc_global_candidates) re-acquires old keyframes when
    # the loop returns to mapped territory at ~frame 94 — ate on these
    # runs measures BETTER than immediate-mode passes (0.05 vs ~0.1).
    # Chronic loss means failing BOTH: never recovering before the mapped
    # arc returns.
    assert r["lost"] <= 36, r


@pytest.mark.slow
def test_closes_a_real_loop(loop_on_run):
    r = loop_on_run
    assert r["loops"] >= 1, r  # the revisit was detected and closed
    path_len = STEP * N
    assert r["ate"] < 0.02 * path_len, r  # measured ~0.4% of path


@pytest.mark.slow
def test_loop_closure_beats_ablation(loop_on_run, loop_sequence):
    r_off = _run(False, loop_sequence)
    assert r_off["final"] == State.OK, r_off
    assert loop_on_run["ate"] < r_off["ate"], (loop_on_run["ate"], r_off["ate"])
