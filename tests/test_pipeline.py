"""Compiled device-resident pipeline: tracking correctness on synthetic
frames, reference swap, state checkpointing."""
import numpy as np
import jax.numpy as jnp
import pytest

from visual_slam_tpu.ops.detector import detect_and_describe
from visual_slam_tpu.pipeline import init_track_state, make_track_step, swap_reference

from render import make_world, render, render_with_depth, camera_path


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(3)
    world = make_world(rng)
    Ts = camera_path(6, step=0.25)
    f = 260.0
    W, H = 320, 240
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float32)
    frames = [render(world, T, K, W, H) for T in Ts]
    NF = 256
    feats0 = detect_and_describe(
        jnp.asarray(frames[0]), num_features=NF, threshold=12.0, n_levels=2, grid=4
    )
    xy = np.asarray(feats0.xy)
    valid = np.asarray(feats0.valid)
    # Exact ground-truth landmark per keypoint: the z-buffer gives the depth
    # of the visible sprite plane under each keypoint (frame 0 cam = world).
    _, zbuf = render_with_depth(world, Ts[0], K, W, H)
    Kinv = np.linalg.inv(K)
    lm = np.zeros((NF, 3), np.float32)
    has = np.zeros(NF, bool)
    for i in np.nonzero(valid)[0]:
        ui = int(round(xy[i, 0]))
        vi = int(round(xy[i, 1]))
        if not (0 <= ui < W and 0 <= vi < H):
            continue
        z = float(zbuf[vi, ui])
        if z > 0.5:
            ray = Kinv @ np.array([xy[i, 0], xy[i, 1], 1.0])
            lm[i] = ray * z
            has[i] = True
    state = init_track_state(feats0, lm, has, np.eye(4))
    step = make_track_step(
        jnp.asarray(K), num_features=NF, fast_threshold=12.0, n_levels=2, grid=4,
        pnp_hypotheses=64,
    )
    return step, state, frames, Ts, K


def test_compiled_tracking_recovers_poses(setup):
    step, state, frames, Ts, K = setup
    s = state
    # Frames 1-2 against the frame-0 reference: precise recovery expected.
    for i in (1, 2):
        s, out = step(s, jnp.asarray(frames[i]))
        T = np.asarray(out.T_w2c)
        assert int(out.n_inliers) >= 20, i
        np.testing.assert_allclose(T[:3, :3], Ts[i][:3, :3], atol=0.01)
        np.testing.assert_allclose(T[:3, 3], Ts[i][:3, 3], atol=0.06)
    # Frame 3 vs the now 3-steps-old fixed reference: only require the step
    # to stay functional (real SLAM swaps references at keyframes).
    s, out = step(s, jnp.asarray(frames[3]))
    assert int(out.n_inliers) >= 6
    assert np.isfinite(np.asarray(out.T_w2c)).all()


def test_swap_reference(setup):
    step, state, frames, Ts, K = setup
    s, out = step(state, jnp.asarray(frames[1]))
    s2 = swap_reference(s, out.features, s.ref_landmarks, s.ref_has_landmark)
    assert s2.ref_feats.xy.shape == s.ref_feats.xy.shape
    s3, out3 = step(s2, jnp.asarray(frames[2]))
    assert np.isfinite(np.asarray(out3.T_w2c)).all()


def test_track_state_checkpoint(setup, tmp_path):
    from visual_slam_tpu.utils.serialization import load_track_state, save_track_state

    step, state, frames, Ts, K = setup
    s, out = step(state, jnp.asarray(frames[1]))
    p = tmp_path / "state.npz"
    save_track_state(s, p)
    s2 = load_track_state(p)
    # resumed state must produce identical next-step output
    _, o1 = step(s, jnp.asarray(frames[2]))
    _, o2 = step(s2, jnp.asarray(frames[2]))
    np.testing.assert_allclose(np.asarray(o1.T_w2c), np.asarray(o2.T_w2c), atol=1e-6)
    assert int(o1.n_inliers) == int(o2.n_inliers)


def test_stereo_track_step():
    """Fused stereo step: detect both cameras + row-gated depth + depth-aware
    PnP in ONE program."""
    from render import stereo_pair

    rng = np.random.default_rng(4)
    world = make_world(rng)
    Ts = camera_path(4, step=0.3)
    f = 260.0
    W, H = 320, 240
    BL = 0.4
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float32)
    l0, r0 = stereo_pair(world, Ts[0], K, BL, W, H)
    NF = 256
    feats0 = detect_and_describe(
        jnp.asarray(l0), num_features=NF, threshold=12.0, n_levels=2, grid=4
    )
    xy = np.asarray(feats0.xy)
    valid = np.asarray(feats0.valid)
    _, zbuf = render_with_depth(world, Ts[0], K, W, H)
    Kinv = np.linalg.inv(K)
    lm = np.zeros((NF, 3), np.float32)
    has = np.zeros(NF, bool)
    for i in np.nonzero(valid)[0]:
        ui, vi = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if 0 <= ui < W and 0 <= vi < H and zbuf[vi, ui] > 0.5:
            lm[i] = (Kinv @ np.array([xy[i, 0], xy[i, 1], 1.0])) * float(zbuf[vi, ui])
            has[i] = True
    state = init_track_state(feats0, lm, has, np.eye(4))
    step = make_track_step(
        jnp.asarray(K), num_features=NF, fast_threshold=12.0, n_levels=2, grid=4,
        pnp_hypotheses=64, stereo=True, baseline=BL,
    )
    for i, T in enumerate(Ts[1:], 1):
        left, right = stereo_pair(world, T, K, BL, W, H)
        pair = jnp.stack([jnp.asarray(left), jnp.asarray(right)])
        state, out = step(state, pair)
        assert int(out.n_inliers) >= 15, (i, int(out.n_inliers))
        # stereo depth was actually measured
        assert int(out.kp_z_valid.sum()) >= 30
        # pose error against GT (metric — no scale gauge in stereo)
        t_err = np.linalg.norm(np.asarray(out.T_w2c)[:3, 3] - T[:3, 3])
        assert t_err < 0.12, (i, t_err)
    # measured depths agree with the z-buffer at the keypoints
    _, zb = render_with_depth(world, Ts[-1], K, W, H)
    kz = np.asarray(out.kp_z)
    kv = np.asarray(out.kp_z_valid)
    fx = np.asarray(out.features.xy)
    errs = []
    for i in np.nonzero(kv)[0]:
        ui, vi = int(round(fx[i, 0])), int(round(fx[i, 1]))
        if 0 <= ui < W and 0 <= vi < H and zb[vi, ui] > 0.5:
            errs.append(abs(kz[i] - zb[vi, ui]) / zb[vi, ui])
    assert len(errs) >= 20
    assert np.median(errs) < 0.05, np.median(errs)
