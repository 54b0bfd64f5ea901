"""Tuning experiment for the 200-frame loopy endurance run:
circular revisit trajectory + photometric noise + a texture blackout
(LOST -> relocalize), loop closing ON vs OFF."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests"))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from render import loop_path, make_ring_world, render
from visual_slam_tpu.camera import PinholeCamera
from visual_slam_tpu.config import Config
from visual_slam_tpu.slam import SLAM
from visual_slam_tpu.utils.metrics import ate_rmse, trajectory_from_keyframes

N = int(os.environ.get("N_FRAMES", 200))
STEP = 0.25
W, H, F = 320, 240, 260.0
BLACKOUT = range(60, 63)


def make_frames(seed=11):
    rng = np.random.default_rng(seed)
    Ts = loop_path(N, step=STEP, closes=1.06)
    yaw_rate = 2 * np.pi * 1.06 / N
    radius = STEP / (2 * np.sin(yaw_rate / 2))
    center = np.array([-radius, 0.0, 0.0])
    world = make_ring_world(rng, center, radius + 3.0, radius + 13.0)
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
    frames = []
    for i, T in enumerate(Ts):
        if i in BLACKOUT:
            img = np.full((H, W), 110.0, np.float32)
        else:
            img = render(world, T, K, W, H)
        # photometric stress: noise + slow brightness drift
        img = img * (1.0 + 0.05 * np.sin(2 * np.pi * i / 50.0))
        img = img + rng.normal(0, 2.0, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.float32))
    return frames, Ts, K


def cfg_for_run(loop_on: bool) -> Config:
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


def run(loop_on: bool, frames, Ts, K):
    cam = PinholeCamera(width=W, height=H, K=K)
    slam = SLAM(cam, cfg_for_run(loop_on))
    states, lost, reloc = [], 0, 0
    t0 = time.time()
    for i, img in enumerate(frames):
        info = slam.track([img], timestamp=i * 0.1)
        st = info.get("state", "")
        states.append(st)
        if st == "LOST":
            lost += 1
        if info.get("relocalized"):
            reloc += 1
    wall = time.time() - t0
    slam.shutdown()
    kfs = slam.map.get_keyframes()
    est = trajectory_from_keyframes(kfs)
    idx = [int(round(kf.timestamp / 0.1)) for kf in kfs]
    gt = np.stack([-Ts[i][:3, :3].T @ Ts[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt, align_scale=True)
    loops = len(slam.loop_closing.closed_loops) if slam.loop_closing else 0
    print(
        f"loop={'ON ' if loop_on else 'OFF'} ate={res['rmse']:.4f} "
        f"kfs={len(kfs)} lost={lost} reloc={reloc} loops={loops} "
        f"final={states[-1]} wall={wall:.1f}s",
        flush=True,
    )
    return res["rmse"], lost, reloc, loops, states


if __name__ == "__main__":
    frames, Ts, K = make_frames()
    path_len = STEP * N
    print(f"n={N} path={path_len:.1f}", flush=True)
    ate_on, lost_on, reloc_on, loops_on, st_on = run(True, frames, Ts, K)
    ate_off, lost_off, reloc_off, loops_off, st_off = run(False, frames, Ts, K)
    print(f"ATE on/off: {ate_on:.4f}/{ate_off:.4f} ({ate_on/path_len:.2%} vs {ate_off/path_len:.2%} of path)")
