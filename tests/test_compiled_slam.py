"""CompiledSLAM: full SLAM over the fused tracking step."""
import numpy as np
import pytest

from visual_slam_tpu.models import CompiledSLAM
from visual_slam_tpu.camera import PinholeCamera
from visual_slam_tpu.state import State
from visual_slam_tpu.utils.metrics import ate_rmse

from render import render_sequence
from test_slam_e2e import small_config


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(42)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=14, step=0.3)
    cfg = small_config()
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    slam = CompiledSLAM(cam, cfg)
    infos = [slam.track([img], timestamp=i * 0.1) for i, img in enumerate(frames)]
    slam.shutdown()
    return slam, infos, Ts_gt


def test_compiled_slam_tracks(run):
    slam, infos, Ts_gt = run
    assert slam.state == State.OK, [i["state"] for i in infos]
    assert slam.map.num_keyframes() >= 3
    assert slam.map.num_map_points() > 80
    assert any(i.get("new_keyframe") for i in infos)


def test_compiled_slam_per_frame_poses(run):
    slam, infos, Ts_gt = run
    # Every frame from initialization onward got a pose (keyframes AND
    # regular frames); pre-init buffer frames don't.
    assert len(slam.poses) >= 12
    ts = [p[0] for p in slam.poses]
    assert ts == sorted(ts)


def test_compiled_slam_trajectory(run):
    slam, infos, Ts_gt = run
    # Per-frame trajectory vs GT (skip the pre-init frames).
    ts, Ts = slam.trajectory()
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt, align_scale=True)
    # 14 frames x 0.3 step = 4.2 path; allow 8% on the crude renderer.
    assert res["rmse"] < 0.35, res


def test_guided_local_map_extends_tracking():
    """The compiled step's projection-guided local-map
    association must keep tracking alive through fast-motion keyframe
    transitions that reference-block brute matching alone loses (it also
    serves landmarks the reference block never saw)."""
    rng = np.random.default_rng(7)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=10, step=0.5)
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)

    def run(local_map_size):
        cfg = small_config()
        cfg.tracking.local_map_size = local_map_size
        cfg.tracking.keyframe_interval = 4
        slam = CompiledSLAM(cam, cfg)
        inls, lost = [], 0
        for i, img in enumerate(frames):
            info = slam.track([img], timestamp=i * 0.1)
            lost += info.get("state") == "LOST"
            if info.get("n_inliers") is not None:
                inls.append(info["n_inliers"])
        slam.shutdown()
        return inls, lost

    inl_brute, lost_brute = run(0)
    inl_guided, lost_guided = run(2048)
    # The guided step sustains strictly more PnP inliers and survives at
    # least as long (measured: [30, 22, 16, ...] vs [19, 8] on this seed).
    assert sum(inl_guided) > sum(inl_brute), (inl_guided, inl_brute)
    assert len(inl_guided) > len(inl_brute)
    assert lost_guided <= lost_brute


def test_compiled_slam_stereo():
    """CompiledSLAM stereo deployment: (2,H,W) pair per dispatch, in-step
    depth, depth-aware PnP, metric landmarks at keyframes."""
    import numpy as np
    from render import camera_path, make_world, stereo_pair
    from visual_slam_tpu.utils.metrics import ate_rmse

    rng = np.random.default_rng(6)
    world = make_world(rng)
    Ts = camera_path(10, step=0.3)
    f, W, H, BL = 260.0, 320, 240, 0.5
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    cfg = small_config()
    cfg.camera.sensor_type = "stereo"
    cfg.initialization.min_inliers = 30
    cam = PinholeCamera(width=W, height=H, K=K, baseline=BL)
    slam = CompiledSLAM(cam, cfg)
    assert slam._stereo
    for i, T in enumerate(Ts):
        left, right = stereo_pair(world, T, K, BL, W, H)
        slam.track([left, right], timestamp=i * 0.1)
    slam.shutdown()
    assert slam.state.name == "OK"
    ts, Tw = slam.trajectory()
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Tw])
    gt = np.stack([-Ts[i][:3, :3].T @ Ts[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt, align_scale=False)  # metric: no alignment
    assert res["rmse"] < 0.35, res
    assert slam.map.num_map_points() > 50


@pytest.mark.slow
def test_compiled_slam_loop_closing():
    """CompiledSLAM + loop closing on a circular revisit trajectory: the
    host loop-closing component plugs into the compiled path's Map; a
    closure rewrites keyframes and the KF-anchored trajectory() propagates
    the correction to per-frame poses."""
    from render import loop_path, make_ring_world, render
    from visual_slam_tpu.config import Config
    from visual_slam_tpu.utils.metrics import ate_rmse

    N, STEP = 100, 0.25
    rng = np.random.default_rng(11)
    Ts = loop_path(N, step=STEP, closes=1.06)
    yaw_rate = 2 * np.pi * 1.06 / N
    radius = STEP / (2 * np.sin(yaw_rate / 2))
    world = make_ring_world(rng, np.array([-radius, 0.0, 0.0]), radius + 3.0, radius + 13.0)
    f, W, H = 260.0, 320, 240
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    cfg = Config()
    cfg.feature.num_features = 320
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 40
    cfg.tracking.keyframe_interval = 2
    cfg.tracking.local_map_size = 2048
    cfg.optimization.window_size = 6
    cfg.loop_closing.enabled = True
    cam = PinholeCamera(width=W, height=H, K=K)
    slam = CompiledSLAM(cam, cfg)
    for i, T in enumerate(Ts):
        slam.track([render(world, T, K, W, H)], timestamp=i * 0.1)
    slam.shutdown()
    assert slam.state.name == "OK"
    assert len(slam.loop_closing.closed_loops) >= 1
    ts, Tw = slam.trajectory()
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Tw])
    gt = np.stack([-Ts[j][:3, :3].T @ Ts[j][:3, 3] for j in idx])
    res = ate_rmse(est, gt, align_scale=True)
    assert res["rmse"] < 0.02 * STEP * N, res  # measured ~0.43% of path


@pytest.mark.slow
def test_compiled_slam_devpromo_loop_closing():
    """Device-side in-chunk promotion WITH loop closing enabled — the
    combination that exercises the compact chunk's fused place-signature
    fetch (pipeline.make_compact_chunk with_sig=True, compiled_slam
    note_signature): a closure must occur on the devpromo path, and every
    signature the compact fetch recorded must equal the signature recomputed
    from the adopted keyframe's own stored descriptors (slot-indexing
    regression guard — ADVICE r4 #1)."""
    from render import loop_path, make_ring_world, render
    from visual_slam_tpu.config import Config
    from visual_slam_tpu.loop_closing.signature import batch_signatures
    from visual_slam_tpu.utils.metrics import ate_rmse

    N, STEP = 100, 0.25
    rng = np.random.default_rng(11)
    Ts = loop_path(N, step=STEP, closes=1.06)
    yaw_rate = 2 * np.pi * 1.06 / N
    radius = STEP / (2 * np.sin(yaw_rate / 2))
    world = make_ring_world(rng, np.array([-radius, 0.0, 0.0]), radius + 3.0, radius + 13.0)
    f, W, H = 260.0, 320, 240
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    cfg = Config()
    cfg.feature.num_features = 320
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 40
    cfg.tracking.keyframe_interval = 2
    cfg.tracking.local_map_size = 2048
    cfg.tracking.chunk_size = 4
    cfg.tracking.device_promotion = True
    cfg.optimization.window_size = 6
    cfg.loop_closing.enabled = True
    cam = PinholeCamera(width=W, height=H, K=K)
    slam = CompiledSLAM(cam, cfg)
    for i, T in enumerate(Ts):
        slam.track([render(world, T, K, W, H)], timestamp=i * 0.1)
    slam.shutdown()
    assert slam.state.name == "OK"
    assert len(slam.loop_closing.closed_loops) >= 1
    # Fused-fetch signature parity: recompute from the adopted keyframes'
    # descriptors and compare with what note_signature recorded.
    table = slam.loop_closing._sig_table
    kfs = [kf for kf in slam.map.get_keyframes() if kf.keyframe_id in table]
    assert len(kfs) >= 3  # devpromo adopted keyframes carried signatures
    descs = np.stack([np.asarray(kf.descriptors(0)) for kf in kfs])
    valids = np.stack([np.asarray(kf.get_features(0).valid) for kf in kfs])
    sigs = batch_signatures(descs, valids)
    for kf, sig in zip(kfs, sigs):
        np.testing.assert_allclose(
            table[kf.keyframe_id], sig, atol=1e-5,
            err_msg=f"kf {kf.keyframe_id} fused signature != recomputed",
        )
    ts, Tw = slam.trajectory()
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Tw])
    gt = np.stack([-Ts[j][:3, :3].T @ Ts[j][:3, 3] for j in idx])
    res = ate_rmse(est, gt, align_scale=True)
    assert res["rmse"] < 0.02 * STEP * N, res


@pytest.mark.slow
def test_compiled_slam_landmark_budget():
    """config.map.max_landmarks enforced on the COMPILED path: the map must
    stay at/under budget after every boundary, tracking must survive the evictions, and
    the BA pack must stay in ONE shape bucket (optimizer.shapes_seen)."""
    rng = np.random.default_rng(42)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=17, step=0.3)
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    cfg = small_config()
    cfg.tracking.chunk_size = 7
    cfg.tracking.device_promotion = True
    cfg.map.max_landmarks = 180
    cfg.map.budget_protect_recent = 2
    cfg.optimization.point_bucket_floor = 256
    cfg.optimization.max_points = 256
    slam = CompiledSLAM(cam, cfg)
    infos = [slam.track([img], timestamp=i * 0.1) for i, img in enumerate(frames)]
    slam.shutdown()
    assert slam.state == State.OK, [i["state"] for i in infos]
    # At/near budget: landmarks minted since the last boundary eviction and
    # those protected as recently-observed may transiently overshoot; the
    # unbudgeted run holds 345.
    assert slam.map.num_map_points() <= 256
    assert slam.map.num_keyframes() >= 3
    shapes = getattr(slam.optimizer, "shapes_seen", set())
    assert all(m == 256 for (_, m) in shapes), shapes
    ts, Ts = slam.trajectory()
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt, align_scale=True)
    assert res["rmse"] < 0.45, res


@pytest.mark.slow
def test_compiled_slam_rotation_dominant_ring():
    """Rotation-dominant stress (6.2 deg/frame yaw, full circle in 58
    frames): with the rotation keyframe gate at 5 deg the compiled path
    keeps the reference fresh enough to survive, closes the revisit loop,
    and stays within 2% of path ATE. (At the reference-parity 10 deg gate
    the reference block staled 2-3 frames under this yaw and tracking died —
    the gate, brute multi-KF recovery, and rotation-adaptive guided radius
    added in round 2 are this regime's defenses.)"""
    from render import loop_path, make_ring_world, render
    from visual_slam_tpu.config import Config
    from visual_slam_tpu.utils.metrics import ate_rmse

    N, STEP = 64, 0.25
    rng = np.random.default_rng(11)
    Ts = loop_path(N, step=STEP, closes=1.1)
    yaw_rate = 2 * np.pi * 1.1 / N
    radius = STEP / (2 * np.sin(yaw_rate / 2))
    world = make_ring_world(rng, np.array([-radius, 0.0, 0.0]), radius + 3.0, radius + 13.0)
    f, W, H = 260.0, 320, 240
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    cfg = Config()
    cfg.feature.num_features = 320
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 40
    cfg.tracking.keyframe_interval = 2
    cfg.tracking.local_map_size = 2048
    cfg.tracking.kf_min_rotation_deg = 5.0
    cfg.optimization.window_size = 6
    cfg.loop_closing.enabled = True
    cam = PinholeCamera(width=W, height=H, K=K)
    slam = CompiledSLAM(cam, cfg)
    lost = 0
    for i, T in enumerate(Ts):
        info = slam.track([render(world, T, K, W, H)], timestamp=i * 0.1)
        if info.get("state") == "LOST":
            lost += 1
    slam.shutdown()
    assert slam.state.name == "OK"
    assert lost == 0
    assert len(slam.loop_closing.closed_loops) >= 1
    ts, Tw = slam.trajectory()
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Tw])
    gt = np.stack([-Ts[j][:3, :3].T @ Ts[j][:3, 3] for j in idx])
    res = ate_rmse(est, gt, align_scale=True)
    assert res["rmse"] < 0.02 * STEP * N, res


def test_compiled_slam_chunked():
    """Chunked multi-frame tracking (tracking.chunk_size > 1): lax.scan runs
    chunk_size frames per dispatch; decisions land at chunk boundaries. The
    chunked run must track the same sequence to comparable accuracy and
    record a pose for EVERY frame (including a flush of a partial chunk)."""
    rng = np.random.default_rng(42)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=15, step=0.3)
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    cfg = small_config()
    cfg.tracking.chunk_size = 4  # 15 frames -> bootstrap + chunks + partial
    slam = CompiledSLAM(cam, cfg)
    infos = [slam.track([img], timestamp=i * 0.1) for i, img in enumerate(frames)]
    slam.shutdown()  # flushes the partial chunk
    assert slam.state == State.OK, [i["state"] for i in infos]
    assert any(i.get("new_keyframe") for i in infos)
    assert slam.map.num_keyframes() >= 2
    ts, Ts = slam.trajectory()
    # Every post-init frame has a pose, in timestamp order.
    assert ts.tolist() == sorted(ts.tolist())
    assert slam.num_frames_tracked() == len(ts) >= 12
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt, align_scale=True)
    assert res["rmse"] < 0.45, res


def test_compiled_slam_device_promotion():
    """In-chunk device-side keyframe promotion (tracking.device_promotion):
    with chunk_size ABOVE the renderer's ~4-frame match-decay horizon, the
    plain chunk starves (the reference block goes stale mid-chunk) while
    the self-promoting chunk swaps its own reference on-device and must
    track the whole sequence at comparable accuracy, with host keyframes
    rebuilt from the PromoteRecords."""
    rng = np.random.default_rng(42)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=17, step=0.3)
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    cfg = small_config()
    cfg.tracking.chunk_size = 7  # > decay horizon; needs in-chunk promotion
    cfg.tracking.device_promotion = True
    slam = CompiledSLAM(cam, cfg)
    infos = [slam.track([img], timestamp=i * 0.1) for i, img in enumerate(frames)]
    slam.shutdown()  # flushes the partial chunk
    assert slam.state == State.OK, [i["state"] for i in infos]
    assert any(i.get("new_keyframe") for i in infos)
    # Device promotions happened MID-chunk (more than one keyframe from a
    # single boundary implies in-chunk promotion records were adopted).
    assert slam.map.num_keyframes() >= 3
    ts, Ts = slam.trajectory()
    assert ts.tolist() == sorted(ts.tolist())
    assert slam.num_frames_tracked() == len(ts) >= 14
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt, align_scale=True)
    assert res["rmse"] < 0.45, res


def test_compiled_slam_async_boundary():
    """Async heavy boundaries (tracking.async_boundary): the solve
    dispatched at one chunk boundary is written back at the next, and the
    device carry is re-anchored by the similarity correction
    (pipeline.apply_correction) instead of a host reference re-install.
    Must track the whole sequence at accuracy comparable to the
    synchronous devpromo path (same world, same gates)."""
    rng = np.random.default_rng(42)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=17, step=0.3)
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    cfg = small_config()
    cfg.tracking.chunk_size = 7
    cfg.tracking.device_promotion = True
    cfg.tracking.async_boundary = True
    # The maturity gate would keep this short fixture all-sync; lower it so
    # the async machinery (device-chained fsr/T_ref, deferred solve,
    # similarity correction) actually runs here.
    cfg.tracking.async_boundary_min_kfs = 3
    slam = CompiledSLAM(cam, cfg)
    infos = [slam.track([img], timestamp=i * 0.1) for i, img in enumerate(frames)]
    slam.shutdown()  # flushes the partial chunk + the in-flight solve
    assert slam.state == State.OK, [i["state"] for i in infos]
    assert slam.map.num_keyframes() >= 3
    ts, Ts = slam.trajectory()
    assert ts.tolist() == sorted(ts.tolist())
    assert slam.num_frames_tracked() == len(ts) >= 14
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt, align_scale=True)
    assert res["rmse"] < 0.45, res


def test_compiled_slam_ragged_descriptors():
    """The ragged (bin-sorted grouped matmul) descriptor path tracks the
    same world end-to-end through CompiledSLAM (config.feature.
    ragged_descriptors)."""
    import numpy as np
    from render import render_sequence
    from visual_slam_tpu.camera import PinholeCamera
    from visual_slam_tpu.config import Config
    from visual_slam_tpu.models import CompiledSLAM
    from visual_slam_tpu.utils.metrics import ate_rmse
    from visual_slam_tpu.ops import orb

    rng = np.random.default_rng(5)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=12, step=0.3)
    cfg = Config()
    cfg.feature.num_features = 320
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.ragged_descriptors = True
    cfg.initialization.min_inliers = 40
    cfg.tracking.keyframe_interval = 2
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    try:
        slam = CompiledSLAM(cam, cfg)
        for i, img in enumerate(frames):
            slam.track([img], timestamp=i * 0.1)
        slam.flush()
        ts, Ts = slam.trajectory()
        idx = [int(round(t / 0.1)) for t in ts]
        est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
        gt = np.stack([-Ts_gt[j][:3, :3].T @ Ts_gt[j][:3, 3] for j in idx])
        res = ate_rmse(est, gt, align_scale=True)
        assert slam.state.name == "OK"
        assert res["rmse"] < 0.3, res["rmse"]  # same math; near-tie bits may
        # flip vs dense (chaotic on this tiny world) — gate on sane tracking
    finally:
        orb.set_ragged_descriptors(False)  # don't leak into other tests


def test_adopt_device_keyframe_drops_stale_inherits():
    """ADVICE r3 (medium): a device-inherited slot whose HOST-side link
    fails (arena landmark fused/culled between chunk dispatch and adoption)
    must be DROPPED, not re-created — for a guided-only association the
    match train index is meaningless, and the old code linked it into the
    previous keyframe plus minted a duplicate MapPoint shadowing the live
    original. Only device-TRIANGULATED slots (rec.ref_tri) may mint."""
    import jax.numpy as jnp

    from visual_slam_tpu.map import Frame, MapPoint
    from visual_slam_tpu.map.keyframe import KeyFrame
    from visual_slam_tpu.models.compiled_slam import PromoteRecord, TrackOutput
    from visual_slam_tpu.ops.detector import Features

    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    cam = PinholeCamera(width=320, height=240, K=K)
    slam = CompiledSLAM(cam, small_config())

    nk = 4

    def feats(seed):
        r = np.random.default_rng(seed)
        return Features(
            xy=jnp.asarray(r.uniform(10, 200, (nk, 2)).astype(np.float32)),
            response=jnp.ones(nk), angle=jnp.zeros(nk),
            octave=jnp.zeros(nk, jnp.int32), size=jnp.ones(nk),
            desc=jnp.asarray(r.integers(0, 2**32, (nk, 8), dtype=np.uint32)),
            valid=jnp.ones(nk, bool),
        )

    ref_fr = Frame(features=[feats(0)], timestamp=0.0)
    ref_fr.update_pose(np.eye(4))
    ref = KeyFrame.from_frame(ref_fr)
    live = MapPoint(np.array([0.0, 0.0, 5.0]))
    ref.add_map_point(0, 1, live)  # ti[0] will point HERE (wrong link bait)
    slam.map.add_keyframe(ref)
    slam.map.add_map_point(live)

    fused = MapPoint(np.array([1.0, 0.0, 6.0]))
    fused.set_bad()  # arena landmark died between dispatch and adoption
    arena = [fused]

    # Slot 0: guided-only inherit of the now-bad arena landmark
    #   (match_valid FALSE -> ti[0]=1 is meaningless); device says ref_has.
    # Slot 1: device-triangulated via a valid match (ti[1]=2) -> must mint.
    out = TrackOutput(
        T_w2c=np.eye(4, dtype=np.float32),
        n_inliers=np.int32(nk), n_matches=np.int32(nk),
        features=feats(1),
        match_train_idx=np.array([1, 2, 0, 0], np.int32),
        match_valid=np.array([False, True, False, False]),
        pnp_inliers=np.array([True, True, False, False]),
        guided_idx=np.array([0, 0, 0, 0], np.int32),
        guided_valid=np.array([True, False, False, False]),
    )
    rec = PromoteRecord(
        promoted=True,
        ref_pos=np.array([[1, 0, 6], [0.5, 0, 7], [0, 0, 0], [0, 0, 0]], np.float64),
        ref_has=np.array([True, True, False, False]),
        ref_tri=np.array([False, True, False, False]),
    )
    n_points_before = slam.map.num_map_points()
    kf = slam._adopt_device_keyframe(out, rec, 0.1, ref, arena)

    # Slot 0 dropped: no duplicate minted, no wrong ref observation.
    assert kf.get_map_point(0, 0) is None
    assert ref.get_map_point(0, 1) is live
    assert live.num_observations() == 1
    # Slot 1 minted + linked into BOTH keyframes at the right indices.
    mp_new = kf.get_map_point(0, 1)
    assert mp_new is not None and mp_new is not live
    assert ref.get_map_point(0, 2) is mp_new
    assert slam.map.num_map_points() == n_points_before + 1


def test_compiled_slam_stereo_device_promotion():
    """Stereo in-chunk device promotion (r4): the self-promoting chunk
    mints METRIC reference landmarks from its own disparity depths (no
    two-view parallax wait), so stereo deployments get the same
    chunk-size-beyond-decay-horizon amortization as mono — and the
    trajectory stays metric (NO scale alignment in the ATE)."""
    import sys

    from render import camera_path, make_world, stereo_pair

    rng = np.random.default_rng(11)
    world = make_world(rng)
    Ts_gt = camera_path(17, step=0.3, yaw_rate=0.01)
    f, W, H = 260.0, 320, 240
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    baseline = 0.5
    cfg = small_config()
    cfg.camera.sensor_type = "stereo"
    cfg.initialization.min_inliers = 30
    cfg.tracking.chunk_size = 7  # > decay horizon; needs in-chunk promotion
    cfg.tracking.device_promotion = True
    cam = PinholeCamera(width=W, height=H, K=K, baseline=baseline)
    slam = CompiledSLAM(cam, cfg)
    infos = []
    for i, T in enumerate(Ts_gt):
        left, right = stereo_pair(world, T, K, baseline, W, H)
        infos.append(slam.track([left, right], timestamp=i * 0.1))
    slam.shutdown()
    assert slam.state == State.OK, [i["state"] for i in infos]
    assert slam.map.num_keyframes() >= 3
    ts, Ts = slam.trajectory()
    assert slam.num_frames_tracked() == len(ts) >= 14
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt, align_scale=False)  # metric: no scale fit
    assert res["rmse"] < 0.25, res


def test_async_boundary_maturity_and_cooloff_gating():
    """_use_async_boundary: sync while the map is young (the r4 asyncb
    collapse mode — q_ab_asyncb.log), async once mature, and sync again
    for `async_boundary_cooloff` boundaries after thin tracking."""
    rng = np.random.default_rng(0)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=3, step=0.3)
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    cfg = small_config()
    cfg.tracking.chunk_size = 4  # devpromo (and so async) needs chunks
    cfg.tracking.device_promotion = True
    cfg.tracking.async_boundary = True
    cfg.tracking.async_boundary_min_kfs = 5
    cfg.tracking.async_boundary_cooloff = 2
    slam = CompiledSLAM(cam, cfg)

    class _FakeMap:
        def __init__(self, n):
            self.n = n

        def num_keyframes(self):
            return self.n

    real_map = slam.map
    try:
        slam.map = _FakeMap(3)
        assert slam._use_async_boundary() is False  # young map
        slam.map = _FakeMap(8)
        assert slam._use_async_boundary() is True  # mature
        slam._async_cooloff = 2  # thin-tracking chunk fired the cooloff
        assert slam._use_async_boundary() is False
        assert slam._use_async_boundary() is False
        assert slam._use_async_boundary() is True  # cooloff consumed
        slam._async_mode = False
        assert slam._use_async_boundary() is False  # master switch off
    finally:
        slam.map = real_map
