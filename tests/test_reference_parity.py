"""ATE parity against the ACTUAL reference implementation (/root/reference),
run in-process on the SAME rendered sprite sequence (BASELINE.md north star:
"ATE within 5% of the CPU reference").

The reference needs three environment shims, none touching its code:
* a no-op ``numba.njit`` (numba is not installed; the decorated functions are
  plain Python),
* ``anyio.key = None`` (reference tracking.py:6 has a stray
  ``from anyio import key``),
* ``initializer.viz.show = False`` (it unconditionally cv2.imshow's during
  initialization; headless Qt aborts otherwise).

Measured behavior of the reference on this sequence (documented in
PARITY.md):
* At its DEFAULT config it initializes, tracks 1-2 frames, then goes
  terminally LOST: its local mapping creates almost no landmarks after init
  (the triangulation/culling paths are commented out upstream), so the
  tracked 3D-point count falls under min_inliers=10 and relocalization is a
  stub. Ours tracks the full sequence.
* With min_inliers relaxed to 4 it survives on the few init landmarks;
  its ATE is then compared against ours below.
"""
import sys

import numpy as np
import pytest

from visual_slam_tpu.camera import PinholeCamera
from visual_slam_tpu.slam import SLAM
from visual_slam_tpu.utils.metrics import ate_rmse

from render import render_sequence
from test_slam_e2e import small_config

REF_PATH = "/root/reference"


def _load_reference():
    import os
    import types

    if not os.path.isdir(REF_PATH):
        pytest.skip("reference tree not available")
    if "numba" not in sys.modules:
        numba = types.ModuleType("numba")

        def njit(*args, **kwargs):
            if args and callable(args[0]):
                return args[0]
            return lambda f: f

        numba.njit = njit
        numba.prange = range
        sys.modules["numba"] = numba
    import anyio

    anyio.key = None
    if REF_PATH not in sys.path:
        sys.path.insert(0, REF_PATH)
    try:
        from visual_slam.camera import PinholeCamera as RefCamera
        from visual_slam.config import Config as RefConfig
        from visual_slam.slam import SLAM as RefSLAM
    except Exception as e:  # pragma: no cover
        pytest.skip(f"reference not importable: {e}")
    return RefSLAM, RefConfig, RefCamera


def _run_reference(frames, K, tmp_path, min_inliers):
    RefSLAM, RefConfig, RefCamera = _load_reference()
    cfg = RefConfig()
    cfg.tracking.min_inliers = min_inliers
    cam = RefCamera(
        width=frames[0].shape[1], height=frames[0].shape[0],
        fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
    )
    slam = RefSLAM(cam, cfg, log_dir=str(tmp_path / "reflogs"))
    slam.tracking.initializer.viz.show = False
    poses, states = {}, []
    for i, img in enumerate(frames):
        img8 = np.clip(img, 0, 255).astype(np.uint8)
        slam.track([np.stack([img8] * 3, -1)], timestamp=i * 0.1)
        st = str(slam.tracking.state).split()[1]
        states.append(st)
        cur = slam.tracking.current_frame
        if cur is not None and st == "OK":
            poses[i] = np.asarray(cur.pose)  # reference Pose exposes __array__ -> T (w2c)
    slam.shutdown()
    return poses, states


def _run_ours(frames, K):
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    slam = SLAM(cam, small_config())
    poses, states = {}, []
    for i, img in enumerate(frames):
        info = slam.track([img], timestamp=i * 0.1)
        states.append(info.get("state", slam.state.name))
        if slam.state.name == "OK" and slam.tracking.current_frame is not None:
            poses[i] = np.asarray(slam.tracking.current_frame.T_w2c)
    slam.shutdown()
    return poses, states


def _ate_pct(poses, Ts_gt):
    idx = sorted(poses)
    est = np.stack([-poses[i][:3, :3].T @ poses[i][:3, 3] for i in idx])
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt, align_scale=True)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return 100.0 * float(res["rmse"]) / max(path, 1e-9), len(idx)


@pytest.mark.parametrize("seed,n_frames,step", [(42, 14, 0.3), (11, 14, 0.3)])
def test_ate_parity_with_reference(tmp_path, seed, n_frames, step):
    rng = np.random.default_rng(seed)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=n_frames, step=step)

    # Reference at its default config: documents the terminal-LOST behavior.
    ref_poses_default, ref_states_default = _run_reference(
        frames, K, tmp_path, min_inliers=10
    )
    assert "LOST" in ref_states_default or len(ref_poses_default) < len(frames) - 2, (
        "reference unexpectedly tracked the full sequence at defaults — "
        "update PARITY.md with the new comparison"
    )

    # Relaxed reference (min_inliers=4) vs ours on identical input.
    ref_poses, ref_states = _run_reference(frames, K, tmp_path, min_inliers=4)
    our_poses, our_states = _run_ours(frames, K)

    assert len(our_poses) >= len(frames) - 2, f"ours lost tracking: {our_states}"
    our_ate, our_n = _ate_pct(our_poses, Ts_gt)

    if len(ref_poses) >= 4:
        ref_ate, ref_n = _ate_pct(ref_poses, Ts_gt)
        # North star: ours within 5 percentage points of the reference —
        # measured r2: ours ~2-6%, reference ~26% over its OK frames.
        assert our_ate <= ref_ate + 5.0, (our_ate, ref_ate)
        print(f"\nATE % of path: ours {our_ate:.2f}% ({our_n} frames) vs "
              f"reference {ref_ate:.2f}% ({ref_n} frames)")
    else:
        # Reference could not sustain tracking even relaxed; ours must hold
        # a single-digit ATE to claim the win.
        assert our_ate < 10.0, our_ate


@pytest.mark.parametrize("seed", [3, 42])
def test_ate_parity_reference_hard_world(tmp_path, seed):
    """Harder, KITTI-like fixtures — textured surfaces
    (interior corners), occlusion clutter, photometric gain/bias drift and
    sensor noise (render.render_sequence_hard). Parameters chosen so the
    relaxed reference SURVIVES >= 2/3 of the frames (probed: 12/15 at
    ~23-28% ATE), keeping the <= ref+5 gate meaningful."""
    from render import render_sequence_hard

    rng = np.random.default_rng(seed)
    frames, Ts_gt, K, world = render_sequence_hard(
        rng, n_frames=15, step=0.12, noise=1.0, gain_drift=0.002,
        bias_drift=0.1,
    )
    ref_poses, ref_states = _run_reference(frames, K, tmp_path, min_inliers=4)
    assert len(ref_poses) >= 10, (
        f"reference survived only {len(ref_poses)}/15 — retune the fixture"
    )
    ref_ate, ref_n = _ate_pct(ref_poses, Ts_gt)

    our_poses, our_states = _run_ours(frames, K)
    assert len(our_poses) >= len(frames) - 2, f"ours lost tracking: {our_states}"
    our_ate, our_n = _ate_pct(our_poses, Ts_gt)
    assert our_ate <= ref_ate + 5.0, (our_ate, ref_ate)
    print(f"\n[hard world seed={seed}] ATE % of path: ours {our_ate:.2f}% "
          f"({our_n} frames) vs reference {ref_ate:.2f}% ({ref_n} frames)")
