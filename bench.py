"""Benchmark: end-to-end tracked FPS at 2000 ORB features on KITTI-sized
frames (the BASELINE.json north-star metric), full-SLAM-pipeline FPS + ATE
(BASELINE config 4), and hardened BA solve latency.

Runs on the GPU only: with no GPU it exits nonzero and prints no result.
Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ..., "extra": {...}}
with the device (platform, device_kind, device count) and the card's name
and power limit from nvidia-smi in ``extra``. vs_baseline is value / 30 FPS
(the real-time target; the reference publishes no numbers and is
qualitatively not real-time, BASELINE.md). Any failing part fails the run.

Measurement notes:
* BA latency: each call gets a DISTINCT problem and its cost value is
  fetched inside the timed region; median + p90 reported.
* The fused-VO FPS cycles distinct frames with async dispatch (one program
  per frame, block at the end) — the steady-state deployment shape.
* The full-pipeline number runs CompiledSLAM end to end: init -> track ->
  keyframe promotion -> triangulation -> bucketed LM/Schur BA, host decision
  work included; ATE is Umeyama-aligned (mono gauge) vs the synthetic GT.
"""
from __future__ import annotations

import json
import time

import numpy as np


def synth_kitti_frames(n_frames=12, H=376, W=1240, f=718.856, n_sprites=900,
                       seed=0, step=0.8, baseline=0.0, stratified=False,
                       depth=False):
    """Sprite-world frames at KITTI resolution (see tests/render.py).
    Returns (frames, K, T_w2c ground truth); with ``baseline`` > 0 also a
    right-camera sequence (offset along camera +x, KITTI rig convention) so
    stereo disparity is REAL, not a zero-disparity stack:
    (frames, frames_right, K, Ts). With ``depth`` the (left) camera's depth
    maps (inf where no sprite) are appended as the last element.

    ``stratified``: place sprites on a jittered grid along x (the travel
    axis) instead of i.i.d. uniform. Over a ~200 m span, i.i.d. placement
    has local density fluctuations large enough to flip the run: the 256-
    frame world (n_sprites=3400) starved its start region (bootstrap only
    at f11 with 94 pts) and died at f16/f43 on 2 of 3 seeds with 20-50
    PnP inliers throughout, while the SAME per-x density tracks fine in
    the 64-frame world. Stratified
    placement makes per-frame visible-sprite count layout-independent;
    used by the sequence-scale benches, off for the short worlds."""
    rng = np.random.default_rng(seed)
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float32)
    span = max(30.0, step * n_frames + 20.0)
    if stratified:
        xs = -30.0 + (np.arange(n_sprites) + rng.uniform(0, 1, n_sprites)) \
            / n_sprites * (40.0 + span)
    else:
        xs = rng.uniform(-30, 10 + span, n_sprites)
    pts = np.stack(
        [xs, rng.uniform(-8, 8, n_sprites),
         rng.uniform(8, 50, n_sprites)], 1
    )
    sizes = rng.uniform(0.15, 0.6, n_sprites)
    intens = rng.uniform(20, 255, n_sprites)

    def render(T):
        img = np.full((H, W), 110.0, np.float32)
        zbuf = np.full((H, W), np.inf, np.float32)
        pc = pts @ T[:3, :3].T + T[:3, 3]
        order = np.argsort(-pc[:, 2])
        for idx in order:
            x, y, z = pc[idx]
            if z < 1.0:
                continue
            u = f * x / z + K[0, 2]
            v = f * y / z + K[1, 2]
            s = f * sizes[idx] / z
            u0, u1, v0, v1 = u - s, u + s, v - s, v + s
            ix0, ix1 = max(int(u0), 0), min(int(np.ceil(u1)), W)
            iy0, iy1 = max(int(v0), 0), min(int(np.ceil(v1)), H)
            if ix1 <= ix0 or iy1 <= iy0:
                continue
            img[iy0:iy1, ix0:ix1] = intens[idx]
            zbuf[iy0:iy1, ix0:ix1] = z
        return img, zbuf

    frames, frames_r, depths, Ts = [], [], [], []
    for i in range(n_frames):
        T = np.eye(4)
        T[0, 3] = -step * i  # camera moving +x
        img, zbuf = render(T)
        frames.append(img)
        depths.append(zbuf)
        Ts.append(T)
        if baseline > 0:
            Tr = T.copy()
            Tr[0, 3] -= baseline  # right camera: +baseline along camera x
            frames_r.append(render(Tr)[0])
    out = (frames, frames_r) if baseline > 0 else (frames,)
    out += (K, np.stack(Ts))
    return out + (depths,) if depth else out


def make_ba_problem(rng, K_np, Wk=10, M=4096, noise=0.05):
    import jax.numpy as jnp

    from visual_slam_tpu.backend.ba import BAProblem

    pts = np.stack(
        [rng.uniform(-20, 30, M), rng.uniform(-8, 8, M), rng.uniform(8, 50, M)], 1
    ).astype(np.float32)
    T = np.tile(np.eye(4, dtype=np.float32), (Wk, 1, 1))
    for j in range(Wk):
        T[j, 0, 3] = -0.8 * j
    uv = np.zeros((M, Wk, 2), np.float32)
    valid = np.zeros((M, Wk), bool)
    for j in range(Wk):
        pc = pts @ T[j, :3, :3].T + T[j, :3, 3]
        uv[:, j] = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)
        valid[:, j] = pc[:, 2] > 1.0
    return BAProblem(
        T_w2c=jnp.asarray(T),
        points=jnp.asarray(pts + rng.normal(0, noise, pts.shape).astype(np.float32)),
        uv=jnp.asarray(uv),
        obs_valid=jnp.asarray(valid),
        pose_valid=jnp.ones(Wk, bool),
        pose_fixed=jnp.asarray([True] + [False] * (Wk - 1)),
    )


def bench_ba(K_np):
    """BA latency, two ways:

    * blocked_fetch: per-call wall time with the solve's final COST VALUE
      fetched to host inside the timed region — a forced device round trip,
      so this is solve + one sync (the deployment boundary cost).
    * dispatch amortized: 8 distinct problems dispatched back-to-back, one
      value fetch from the LAST output — the device executes in order, so
      total/8 is the device compute per solve with the sync amortized.
      (A lax.scan over stacked problems is not used as the harness: it adds
      one-time in-program cost that is not the solve's.)

    Returns (median_blocked_ms, p90_blocked_ms, amortized_ms_per_solve).
    """
    import jax

    from visual_slam_tpu.backend.ba import bundle_adjust

    rng = np.random.default_rng(1)
    huber = 5.0 / float(K_np[0, 0])
    problems = [make_ba_problem(rng, K_np) for _ in range(8)]

    # Warmup/compile on a throwaway problem.
    _, _, info = bundle_adjust(make_ba_problem(rng, K_np), n_iter=20, huber=huber)
    float(info["cost"])

    times = []
    for p in problems:
        t0 = time.perf_counter()
        _, _, info = bundle_adjust(p, n_iter=20, huber=huber)
        _ = float(info["cost"])  # value fetch INSIDE the timed region
        times.append((time.perf_counter() - t0) * 1e3)
    times = np.asarray(times)

    t0 = time.perf_counter()
    infos = [bundle_adjust(p, n_iter=20, huber=huber)[2] for p in problems]
    _ = float(infos[-1]["cost"])  # one fetch drains the in-order queue
    amort_ms = (time.perf_counter() - t0) * 1e3 / len(problems)
    return (
        float(np.median(times)),
        float(np.percentile(times, 90)),
        float(amort_ms),
    )


def bench_vo_step(imgs, K_np, num_features=2000):
    """Steady-state fused VO step FPS (async dispatch, distinct frames)."""
    import jax
    import jax.numpy as jnp

    from visual_slam_tpu.ops.detector import detect_and_describe
    from visual_slam_tpu.pipeline import init_track_state, make_track_step

    rng = np.random.default_rng(1)
    K = jnp.asarray(K_np)
    feats0 = detect_and_describe(imgs[0], num_features=num_features, threshold=20.0, n_levels=4)
    xy = np.asarray(feats0.xy)
    z = rng.uniform(8, 40, num_features).astype(np.float32)
    Kinv = np.linalg.inv(K_np)
    rays = np.concatenate([xy, np.ones((num_features, 1), np.float32)], 1) @ Kinv.T
    landmarks = rays * z[:, None]
    state = init_track_state(feats0, landmarks, np.asarray(feats0.valid), np.eye(4), seed=0)
    step = make_track_step(K, num_features=num_features, n_levels=4)
    state_w, out = step(state, imgs[1])
    jax.device_get(out.T_w2c)
    n_iter = 60
    t0 = time.perf_counter()
    s = state
    for i in range(n_iter):
        s, out = step(s, imgs[1 + (i % (len(imgs) - 1))])
    # Barrier: fetch a VALUE computed by the last dispatch inside the timed
    # region; the device executes dispatches in order, so materializing the
    # final step's pose waits for all 60.
    _ = float(jax.device_get(out.T_w2c)[0, 0])
    return n_iter / (time.perf_counter() - t0)


def bench_vo_chunk(imgs, K_np, num_features=2000, chunk=8, n_disp=12):
    """Device-throughput VO: the PRODUCTION chunked-tracking program
    (pipeline.make_track_chunk — lax.scan of the fused step over ``chunk``
    stacked frames, one dispatch per chunk), ``n_disp`` dispatches
    back-to-back, ONE value fetch from the last output.

    Splits bench_vo_step's per-frame cost into dispatch overhead (vo_step
    pays submission per FRAME; this pays it per CHUNK) and device compute:
    the gap between the two is the per-dispatch cost."""
    import jax
    import jax.numpy as jnp

    from visual_slam_tpu.ops.detector import detect_and_describe
    from visual_slam_tpu.pipeline import (
        init_track_state,
        make_track_chunk,
        make_track_step,
    )

    rng = np.random.default_rng(1)
    K = jnp.asarray(K_np)
    feats0 = detect_and_describe(
        imgs[0], num_features=num_features, threshold=20.0, n_levels=4
    )
    xy = np.asarray(feats0.xy)
    z = rng.uniform(8, 40, num_features).astype(np.float32)
    Kinv = np.linalg.inv(K_np)
    rays = np.concatenate(
        [xy, np.ones((num_features, 1), np.float32)], 1
    ) @ Kinv.T
    landmarks = rays * z[:, None]
    state = init_track_state(
        feats0, landmarks, np.asarray(feats0.valid), np.eye(4), seed=0
    )
    step = make_track_step(K, num_features=num_features, n_levels=4)
    chunk_fn = make_track_chunk(step)
    imgs_c = jnp.stack(
        [imgs[1 + (i % (len(imgs) - 1))] for i in range(chunk)]
    )
    s, outs = chunk_fn(state, imgs_c)  # compile + warm
    _ = float(jax.device_get(outs.T_w2c)[-1, 0, 0])
    t0 = time.perf_counter()
    s = state
    for _i in range(n_disp):
        s, outs = chunk_fn(s, imgs_c)
    _ = float(jax.device_get(outs.T_w2c)[-1, 0, 0])
    return chunk * n_disp / (time.perf_counter() - t0)


def bench_stereo_step(K_np, num_features=2000, baseline=0.54):
    """Steady-state fused STEREO step FPS: detect both cameras + in-program
    row-gated disparity + depth-aware PnP, one dispatch per frame (KITTI
    stereo geometry: bf = 0.54 m x fx).

    The pair is a REAL shifted-camera render (disparity = f*b/z), so the
    in-step depth measurement and the depth-residual PnP branch run on live
    data; the fraction of depth-valid keypoints is returned as evidence.
    Landmarks are backprojected from the step's own measured depths so the
    tracked geometry is self-consistent."""
    import jax
    import jax.numpy as jnp

    from visual_slam_tpu.ops.detector import detect_and_describe
    from visual_slam_tpu.pipeline import init_track_state, make_track_step

    frames_l, frames_r, _, _ = synth_kitti_frames(
        n_frames=12, seed=5, step=0.5, baseline=baseline
    )
    pairs = [
        jnp.stack([jnp.asarray(l), jnp.asarray(r)])
        for l, r in zip(frames_l, frames_r)
    ]
    K = jnp.asarray(K_np)
    feats0 = detect_and_describe(
        jnp.asarray(frames_l[0]), num_features=num_features, threshold=20.0, n_levels=4
    )
    step = make_track_step(
        K, num_features=num_features, n_levels=4, stereo=True, baseline=baseline
    )
    # Warmup pass on frame 0 ALSO measures per-keypoint depth; backproject
    # those into world landmarks (identity pose) for the timed tracking.
    state = init_track_state(
        feats0,
        np.zeros((num_features, 3), np.float32),
        np.asarray(feats0.valid),
        np.eye(4),
        seed=0,
    )
    _, out0 = step(state, pairs[0])
    z = np.asarray(out0.kp_z)
    z_ok = np.asarray(out0.kp_z_valid) & np.asarray(out0.features.valid)
    xy = np.asarray(out0.features.xy)
    Kinv = np.linalg.inv(K_np)
    rays = np.concatenate([xy, np.ones((num_features, 1), np.float32)], 1) @ Kinv.T
    landmarks = rays * np.where(z_ok, z, 20.0)[:, None]
    state = init_track_state(
        feats0, landmarks, z_ok, np.eye(4), seed=0
    )
    state_w, out = step(state, pairs[1])
    jax.device_get(out.T_w2c)
    # Gate-health evidence: inliers at ONE frame of real motion. The last
    # cycled dispatch's count would measure the world's ~50%/frame match
    # decay against the fixed frame-0 reference block (mono decays
    # identically; a SLAM run swaps references every few frames), not the
    # stereo gate. The stereo-SLAM evidence is stereo_pipeline_*.
    inl_pair1 = int(np.asarray(out.n_inliers))
    n_iter = 60
    t0 = time.perf_counter()
    s = state
    for i in range(n_iter):
        s, out = step(s, pairs[1 + (i % (len(pairs) - 1))])
    # Honest barrier: value fetch from the last dispatch (see bench_vo_step).
    _ = float(jax.device_get(out.T_w2c)[0, 0])
    fps = n_iter / (time.perf_counter() - t0)
    return fps, float(z_ok.mean()), inl_pair1


def bench_full_pipeline(num_features=2000, n_frames=64, frame_kw=None,
                        chunk_size=8, ba_n_iter=None, point_floor=None,
                        async_ba=False, pnp_hypotheses=None,
                        max_landmarks=0, window_size=None, heavy_every=None,
                        protect_recent=None):
    """CompiledSLAM end to end on a KITTI-sized synthetic sequence: FPS with
    all host decision/keyframe/BA work included, plus mono-aligned ATE.

    Deployment shape: chunked device-side tracking (chunk_size frames per
    dispatch, pipeline.make_track_chunk). The timed window starts after two
    chunks of steady state so one-time-per-deployment compiles (chunk scan,
    triangulation, the single BA shape bucket) are warm — and it contains
    tracking, decisions, keyframe promotion, triangulation and BA, but NOT
    trajectory materialization (an end-of-run export, not per-frame work).

    Frames stay float32: the sprite world's texture lives entirely in
    anti-aliased EDGE pixels, and uint8 rounding there measurably destroys
    BRIEF match stability (A/B: chunk=4 u8 went LOST at 16%% ATE where f32
    tracked 64/64 frames at 1.0%%). Real camera uint8 input is supported
    (the detector casts on device) — this is a renderer artifact, not an
    input-format policy."""
    import jax

    from visual_slam_tpu.camera import PinholeCamera
    from visual_slam_tpu.config import Config
    from visual_slam_tpu.models import CompiledSLAM
    from visual_slam_tpu.utils.metrics import ate_rmse

    kw = dict(step=0.6, n_sprites=1500)
    kw.update(frame_kw or {})
    frames, K_np, Ts_gt = synth_kitti_frames(n_frames=n_frames, seed=3, **kw)
    cfg = Config()
    cfg.feature.num_features = num_features
    cfg.tracking.keyframe_interval = 4
    cfg.tracking.chunk_size = chunk_size
    # Deployment shape: device-side in-chunk keyframe promotion, heavy (BA)
    # boundary every 2nd promotion, f16 frame upload, ONE BA bucket for the
    # whole run (window 16, pose floor 32, point floor 2048 — each extra
    # bucket is a compile inside the timed window). These were tuned on
    # earlier hardware and are not re-derived for the GPU yet.
    cfg.tracking.device_promotion = True
    # heavy_every=3 starves tracking at sequence scale (boundary staleness
    # -> LOST mid-run over 256 frames); 2 stands.
    cfg.tracking.heavy_boundary_every = 2 if heavy_every is None else heavy_every
    cfg.tracking.upload_f16 = True
    cfg.optimization.max_points = 4096
    cfg.optimization.window_size = 16 if window_size is None else window_size
    cfg.optimization.pose_bucket_floor = 32
    cfg.optimization.point_bucket_floor = (
        2048 if point_floor is None else point_floor
    )
    if ba_n_iter is not None:
        cfg.optimization.n_iter = ba_n_iter
    cfg.optimization.async_ba = bool(async_ba)
    if pnp_hypotheses is not None:
        cfg.tracking.pnp_hypotheses = pnp_hypotheses
    if max_landmarks:
        # Sequence-scale mode: the landmark budget keeps the
        # live map inside the single point bucket forever (eviction at every
        # keyframe boundary, Map.evict_landmarks), and max_points == floor
        # hard-caps the pack so even a transient overshoot cannot grow the
        # compiled shape mid-run.
        cfg.map.max_landmarks = max_landmarks
        cfg.optimization.max_points = cfg.optimization.point_bucket_floor
        if protect_recent is not None:
            cfg.map.budget_protect_recent = protect_recent
    cfg.initialization.min_inliers = min(100, max(30, num_features // 20))
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0],
                        K=np.asarray(K_np, np.float64))
    slam = CompiledSLAM(cam, cfg)

    # Bootstrap + compile outside the timed window (compiles are a one-time
    # per-deployment cost; the metric is steady-state sensor-rate capacity).
    # Allowance 16: the denser long-run world (n_sprites=3400) has more
    # sprite-on-sprite occlusion and clears the two-view inlier gate only at
    # frame ~11 — and a failure must be LOUD (it raises), not a silent None.
    i = 0
    while slam.state.name != "OK" and i < 16:
        slam.track([frames[i]], timestamp=i * 0.1)
        i += 1
    if slam.state.name != "OK":
        raise RuntimeError(
            f"bootstrap failed: state={slam.state.name} after {i} frames"
        )
    # Warm through TWO full heavy-boundary cycles so every shape (chunk
    # scan, compaction, the single BA bucket) compiles before the timer —
    # and align the timed span to the chunk size: flush() runs inside the
    # timed window (it is real tail work), and a partial tail chunk would
    # compile a FRESH scan shape there.
    n_end = len(frames) - (len(frames) - i) % chunk_size
    warm_end = min(
        i + 2 * max(chunk_size, 4) * cfg.tracking.heavy_boundary_every + 1,
        n_end - 2 * max(chunk_size, 8),
    )
    lost_calls = 0  # track calls after bootstrap that left the system LOST
    while i < warm_end:
        slam.track([frames[i]], timestamp=i * 0.1)
        lost_calls += slam.state.name == "LOST"
        i += 1

    t0 = time.perf_counter()
    n_timed = 0
    call_ms = []  # per-track-call wall times: a mid-run recompile is a
    # multi-second outlier here — max_call_ms is the no-recompile evidence.
    for k in range(i, n_end):
        tc = time.perf_counter()
        slam.track([frames[k]], timestamp=k * 0.1)
        call_ms.append((time.perf_counter() - tc) * 1e3)
        lost_calls += slam.state.name == "LOST"
        n_timed += 1
    slam.flush()
    lost_calls += slam.state.name == "LOST"
    dt = time.perf_counter() - t0
    fps = n_timed / dt
    ts, Ts = slam.trajectory()  # end-of-run export, not in the FPS window

    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[j][:3, :3].T @ Ts_gt[j][:3, 3] for j in idx])
    res = ate_rmse(est, gt, align_scale=True)
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    shapes = sorted(getattr(slam.optimizer, "shapes_seen", set()))
    return {
        "fps": round(fps, 2),
        "ate_rmse": round(float(res["rmse"]), 4),
        "ate_pct_of_path": round(100.0 * float(res["rmse"]) / max(path_len, 1e-9), 3),
        "frames_timed": n_timed,
        "keyframes": slam.map.num_keyframes(),
        "landmarks": slam.map.num_map_points(),
        "ba_shapes": [f"{w}x{m}" for (w, m) in shapes],
        "max_call_ms": round(max(call_ms), 1) if call_ms else 0.0,
        "lost_calls": int(lost_calls),
        "state": slam.state.name,
    }


def bench_stereo_pipeline(num_features=2000, n_frames=48, chunk_size=8,
                          baseline=0.54, frame_kw=None):
    """STEREO CompiledSLAM end to end: real shifted-camera renders (KITTI
    rig, bf = 0.54 m x fx), device promotion with disparity-minted metric
    landmarks (compiled_slam._create_stereo_points), ATE **without scale
    alignment** — metric accuracy is the stereo win over mono (reference
    stereo is a 0-byte stub, local_mapping/stereo.py)."""
    import time as _t

    from visual_slam_tpu.camera import PinholeCamera
    from visual_slam_tpu.config import Config
    from visual_slam_tpu.models import CompiledSLAM
    from visual_slam_tpu.utils.metrics import ate_rmse

    kw = dict(step=0.6, n_sprites=1500)
    kw.update(frame_kw or {})
    frames_l, frames_r, K_np, Ts_gt = synth_kitti_frames(
        n_frames=n_frames, seed=3, baseline=baseline, **kw
    )
    cfg = Config()
    cfg.camera.sensor_type = "stereo"
    cfg.feature.num_features = num_features
    cfg.tracking.keyframe_interval = 4
    cfg.tracking.chunk_size = chunk_size
    cfg.tracking.device_promotion = True
    cfg.tracking.heavy_boundary_every = 2
    cfg.tracking.upload_f16 = True
    cfg.optimization.max_points = 4096
    cfg.optimization.window_size = 16
    cfg.optimization.pose_bucket_floor = 32
    cfg.optimization.point_bucket_floor = 2048
    cfg.initialization.min_inliers = min(100, max(30, num_features // 20))
    cam = PinholeCamera(
        width=frames_l[0].shape[1], height=frames_l[0].shape[0],
        K=np.asarray(K_np, np.float64), baseline=baseline,
    )
    slam = CompiledSLAM(cam, cfg)
    i = 0
    while slam.state.name != "OK" and i < 6:
        slam.track([frames_l[i], frames_r[i]], timestamp=i * 0.1)
        i += 1
    if slam.state.name != "OK":
        raise RuntimeError(
            f"stereo bootstrap failed: state={slam.state.name} after {i} frames"
        )
    n_end = len(frames_l) - (len(frames_l) - i) % chunk_size
    warm_end = min(
        i + 2 * max(chunk_size, 4) * cfg.tracking.heavy_boundary_every + 1,
        n_end - 2 * max(chunk_size, 8),
    )
    while i < warm_end:
        slam.track([frames_l[i], frames_r[i]], timestamp=i * 0.1)
        i += 1
    t0 = _t.perf_counter()
    n_timed = 0
    for k in range(i, n_end):
        slam.track([frames_l[k], frames_r[k]], timestamp=k * 0.1)
        n_timed += 1
    slam.flush()
    fps = n_timed / (_t.perf_counter() - t0)
    ts, Ts = slam.trajectory()
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[j][:3, :3].T @ Ts_gt[j][:3, 3] for j in idx])
    res = ate_rmse(est, gt, align_scale=False)  # metric: no scale fit
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return {
        "fps": round(fps, 2),
        "ate_pct_of_path": round(
            100.0 * float(res["rmse"]) / max(path_len, 1e-9), 3
        ),
        "keyframes": slam.map.num_keyframes(),
        "landmarks": slam.map.num_map_points(),
        "state": slam.state.name,
    }


def bench_loop_pipeline(num_features=2000, n_frames=200, chunk_size=8,
                        H=376, W=1240, f=718.856, n_sprites=2400,
                        noise=2.0, bright=0.05):
    """Loop closure on the device pipeline (detection -> Sim(3) pose graph
    -> landmark rescale): a circular revisit trajectory around a
    KITTI-resolution ring world,
    CompiledSLAM with the bench deployment shape, loop closing ON vs OFF
    on the same frames.

    The frames carry the CPU endurance world's photometric stress (gaussian
    noise + slow sinusoidal brightness drift, scripts/exp_loop_endurance.py)
    — without it the 2000-feature KITTI-res front end tracks the ring at
    ~0.1%% ATE and there is no drift for the closure to fix. The ON run's
    compact boundary fetch carries the place signatures
    (pipeline.CompactChunk.sig).

    fps_on is a steady-state number: bootstrap + two heavy-boundary warm
    cycles run before the timer, same policy as bench_full_pipeline (a
    full-run timing would charge one-time compiles to 200 frames). Returns
    both ATEs (%% of path), the ON run's
    steady-state fps and the number of closures."""
    import os
    import sys
    import time as _t

    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests"
    ))
    from render import loop_path, make_ring_world, render

    from visual_slam_tpu.camera import PinholeCamera
    from visual_slam_tpu.config import Config
    from visual_slam_tpu.models import CompiledSLAM
    from visual_slam_tpu.utils.metrics import ate_rmse

    STEP = 0.25
    rng = np.random.default_rng(11)
    Ts = loop_path(n_frames, step=STEP, closes=1.06)
    yaw_rate = 2 * np.pi * 1.06 / n_frames
    radius = STEP / (2 * np.sin(yaw_rate / 2))
    world = make_ring_world(
        rng, np.array([-radius, 0.0, 0.0]), radius + 3.0, radius + 13.0,
        n_sprites=n_sprites, y_range=(-6, 6),
    )
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    frames = []
    for i, T in enumerate(Ts):
        img = render(world, T, K, W, H).astype(np.float32)
        img = img * (1.0 + bright * np.sin(2 * np.pi * i / 50.0))
        img = img + rng.normal(0, noise, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.float32))
    gt = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())

    def one(loop_on: bool):
        cfg = Config()
        cfg.feature.num_features = num_features
        cfg.tracking.keyframe_interval = 4
        cfg.tracking.chunk_size = chunk_size
        cfg.tracking.device_promotion = True
        cfg.tracking.heavy_boundary_every = 2
        cfg.tracking.upload_f16 = True
        cfg.optimization.max_points = 4096
        cfg.optimization.window_size = 16
        cfg.optimization.pose_bucket_floor = 32
        cfg.optimization.point_bucket_floor = 2048
        cfg.initialization.min_inliers = min(100, max(30, num_features // 20))
        cfg.loop_closing.enabled = loop_on
        cam = PinholeCamera(width=W, height=H, K=K)
        slam = CompiledSLAM(cam, cfg)
        i = 0
        while slam.state.name != "OK" and i < 16:
            slam.track([frames[i]], timestamp=i * 0.1)
            i += 1
        if slam.state.name != "OK":
            raise RuntimeError(f"loop bench bootstrap failed after {i}")
        warm_end = min(
            i + 2 * max(chunk_size, 4) * cfg.tracking.heavy_boundary_every + 1,
            len(frames) - 4 * chunk_size,
        )
        while i < warm_end:
            slam.track([frames[i]], timestamp=i * 0.1)
            i += 1
        t0 = _t.perf_counter()
        n_timed = 0
        for k in range(i, len(frames)):
            slam.track([frames[k]], timestamp=k * 0.1)
            n_timed += 1
        slam.flush()
        wall = _t.perf_counter() - t0
        ts, Tw = slam.trajectory()
        idx = [int(round(t / 0.1)) for t in ts]
        est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Tw])
        g = gt[idx]
        res = ate_rmse(est, g, align_scale=True)
        loops = (
            len(slam.loop_closing.closed_loops) if slam.loop_closing else 0
        )
        return (
            100.0 * float(res["rmse"]) / max(path_len, 1e-9),
            n_timed / wall,
            loops,
            slam.state.name,
        )

    ate_on, fps_on, loops_on, state_on = one(True)
    ate_off, _, _, state_off = one(False)
    return {
        "ate_on_pct": round(ate_on, 3),
        "ate_off_pct": round(ate_off, 3),
        "fps_on": round(fps_on, 2),
        "loops_closed": loops_on,
        "state_on": state_on,
        "state_off": state_off,
    }


def bench_loop_endurance_device(n_frames=200, num_features=320,
                                blackout=True):
    """The CPU loop-endurance scenario (scripts/exp_loop_endurance.py —
    320x240 ring, 320 features, photometric noise + brightness drift + a
    3-frame texture blackout forcing LOST -> relocalize) run on the device
    (the CPU script forces jax_platforms=cpu).

    The KITTI-res ring of bench_loop_pipeline only drifts ~0.2%% OFF at
    2000 features — too well-tracked for a closure to show its worth; THIS
    world is where the drift lives.
    Host SLAM facade, every kernel jitted on the device backend."""
    import sys as _sys

    _sys.path.insert(0, "tests")
    from render import loop_path, make_ring_world, render

    from visual_slam_tpu.camera import PinholeCamera
    from visual_slam_tpu.config import Config
    from visual_slam_tpu.slam import SLAM
    from visual_slam_tpu.utils.metrics import ate_rmse, trajectory_from_keyframes

    STEP, W, H, F = 0.25, 320, 240, 260.0
    blackout_frames = range(60, 63) if blackout else ()
    rng = np.random.default_rng(11)
    Ts = loop_path(n_frames, step=STEP, closes=1.06)
    yaw_rate = 2 * np.pi * 1.06 / n_frames
    radius = STEP / (2 * np.sin(yaw_rate / 2))
    world = make_ring_world(
        rng, np.array([-radius, 0.0, 0.0]), radius + 3.0, radius + 13.0
    )
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]])
    frames = []
    for i, T in enumerate(Ts):
        if i in blackout_frames:
            img = np.full((H, W), 110.0, np.float32)
        else:
            img = render(world, T, K, W, H)
        img = img * (1.0 + 0.05 * np.sin(2 * np.pi * i / 50.0))
        img = img + rng.normal(0, 2.0, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.float32))
    gt_full = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    path_len = float(np.linalg.norm(np.diff(gt_full, axis=0), axis=1).sum())

    def one(loop_on):
        cfg = Config()
        cfg.feature.num_features = num_features
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
        slam = SLAM(PinholeCamera(width=W, height=H, K=K), cfg)
        reloc = 0
        for i, img in enumerate(frames):
            info = slam.track([img], timestamp=i * 0.1)
            if info.get("relocalized"):
                reloc += 1
        slam.shutdown()
        kfs = slam.map.get_keyframes()
        est = trajectory_from_keyframes(kfs)
        idx = [int(round(kf.timestamp / 0.1)) for kf in kfs]
        ate = ate_rmse(est, gt_full[idx], align_scale=True)["rmse"]
        loops = len(slam.loop_closing.closed_loops) if slam.loop_closing else 0
        return 100.0 * ate / max(path_len, 1e-9), loops, reloc, slam.state.name

    ate_on, loops_on, reloc_on, st_on = one(True)
    ate_off, _, _, st_off = one(False)
    return {
        "ate_on_pct": round(ate_on, 3),
        "ate_off_pct": round(ate_off, 3),
        "loops_closed": loops_on,
        "relocs": reloc_on,
        "state_on": st_on,
        "state_off": st_off,
    }


def _flops_of(jitted, *args, **kwargs):
    """XLA-cost-model FLOPs (utils/profiling.flops_of; lazy import so the
    backend initializes first)."""
    from visual_slam_tpu.utils.profiling import flops_of

    return flops_of(jitted, *args, **kwargs)


def bench_multiseq(imgs_np, K_np, n_seq=4, num_features=2000):
    """BASELINE config 5 surface: ``n_seq`` independent sequences tracked by
    ONE vmapped program on one chip (the seq mesh axis is how the same code
    scales across chips — tests/dryrun run it sharded). Returns aggregate
    frames/s across the batch — the data-parallel scale-out win vs running
    the single-sequence step n_seq times."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from visual_slam_tpu.ops.detector import detect_and_describe
    from visual_slam_tpu.parallel.multiseq import make_batched_vo, shard_batch
    from visual_slam_tpu.pipeline import init_track_state

    rng = np.random.default_rng(7)
    K = jnp.asarray(K_np)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("seq",))
    step = make_batched_vo(K, mesh, axis="seq", num_features=num_features, n_levels=4)

    states = []
    Kinv = np.linalg.inv(K_np)
    for s in range(n_seq):
        feats0 = detect_and_describe(
            imgs_np[s % len(imgs_np)], num_features=num_features,
            threshold=20.0, n_levels=4,
        )
        xy = np.asarray(feats0.xy)
        z = rng.uniform(8, 40, num_features).astype(np.float32)
        rays = np.concatenate([xy, np.ones((num_features, 1), np.float32)], 1) @ Kinv.T
        states.append(
            init_track_state(
                feats0, rays * z[:, None], np.asarray(feats0.valid),
                np.eye(4), seed=s,
            )
        )
    states = jax.tree.map(lambda *xs: jnp.stack(xs), *states)
    states = shard_batch(mesh, "seq", states)
    frames = np.stack(
        [np.stack([imgs_np[(s + i) % len(imgs_np)] for s in range(n_seq)])
         for i in range(4)]
    )  # (4 steps, n_seq, H, W) distinct batches to cycle
    batches = [shard_batch(mesh, "seq", jnp.asarray(b)) for b in frames]
    states, out = step(states, batches[0])
    jax.device_get(out.T_w2c)
    n_iter = 30
    t0 = time.perf_counter()
    s = states
    for i in range(n_iter):
        s, out = step(s, batches[i % len(batches)])
    # Honest barrier: value fetch from the last dispatch (see bench_vo_step).
    _ = float(jax.device_get(out.T_w2c)[0, 0, 0])
    return n_seq * n_iter / (time.perf_counter() - t0)


def bench_pose_graph(n_nodes=256, n_loops=8, n_iter=10):
    """Loop-closure back-end latency (BASELINE config 5's pose graph): an
    odometry chain of ``n_nodes`` keyframe poses with drift + ``n_loops``
    loop edges, solved by Gauss-Newton (loop_closing/pose_graph.py).
    Returns (ms_per_solve, residual_cost). Reference counterpart: none
    (loop_closing/ is 0 bytes there)."""
    import jax.numpy as jnp

    from visual_slam_tpu.loop_closing.pose_graph import (
        build_sequential_graph,
        optimize_pose_graph,
    )

    rng = np.random.default_rng(3)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_nodes, 1, 1))
    for i in range(n_nodes):
        poses[i, 0, 3] = -0.5 * i - (0.02 * i * rng.uniform(0.5, 1.0))
    loops = []
    for k in range(n_loops):
        i = int(rng.integers(n_nodes // 2, n_nodes - 1))
        j = int(rng.integers(0, n_nodes // 4))
        T_true_i = np.eye(4, dtype=np.float32)
        T_true_i[0, 3] = -0.5 * i
        T_true_j = np.eye(4, dtype=np.float32)
        T_true_j[0, 3] = -0.5 * j
        loops.append((i, j, T_true_i @ np.linalg.inv(T_true_j)))
    graph = build_sequential_graph(jnp.asarray(poses), loop_edges=loops)
    T, info = optimize_pose_graph(graph, n_iter=n_iter)
    float(info["cost"])  # compile warmup
    t0 = time.perf_counter()
    T, info = optimize_pose_graph(graph, n_iter=n_iter)
    cost = float(info["cost"])  # value fetch inside the timed region
    return (time.perf_counter() - t0) * 1e3, cost


def main():
    import jax
    import jax.numpy as jnp

    from visual_slam_tpu.utils.profiling import gpu_name_and_power_limit

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found platform {dev.platform!r}"
        )
    extra: dict = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "gpu_name_power_limit": gpu_name_and_power_limit(),
    }

    def run(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        extra[f"_sec_{name}"] = round(time.perf_counter() - t0, 1)
        return out

    num_features = 2000
    frames, K_np, _ = synth_kitti_frames()
    imgs = [jnp.asarray(f) for f in frames]

    ba_med, ba_p90, ba_amort_ms = run("ba", bench_ba, K_np)
    extra["ba_ms_blocked_fetch_10kf_4096pts_20iter"] = round(ba_med, 3)
    extra["ba_ms_blocked_fetch_p90"] = round(ba_p90, 3)
    extra["ba_ms_per_solve_dispatch8"] = round(ba_amort_ms, 3)
    from visual_slam_tpu.backend.ba import bundle_adjust

    fl = _flops_of(
        bundle_adjust, make_ba_problem(np.random.default_rng(1), K_np),
        n_iter=20, huber=5.0 / float(K_np[0, 0]),
    )
    if fl is not None:
        extra["ba_gflop_per_solve"] = round(fl / 1e9, 2)

    fps = run("vo", bench_vo_step, imgs, K_np, num_features)
    from visual_slam_tpu.ops import orb as orb_ops
    from visual_slam_tpu.ops.detector import detect_and_describe
    from visual_slam_tpu.pipeline import init_track_state, make_track_step

    step = make_track_step(jnp.asarray(K_np), num_features=num_features, n_levels=4)
    feats0 = detect_and_describe(
        imgs[0], num_features=num_features, threshold=20.0, n_levels=4
    )
    st = init_track_state(
        feats0, np.zeros((num_features, 3), np.float32),
        np.asarray(feats0.valid), np.eye(4), seed=0,
    )
    fl = _flops_of(step.jitted, st, imgs[0], orb_ops.active_sampling())
    if fl is not None:
        extra["track_step_gflop"] = round(fl / 1e9, 2)

    extra["tracked_fps_chunk8"] = round(
        run("vo_chunk8", bench_vo_chunk, imgs, K_np, num_features), 2
    )

    fps_stereo, z_frac, stereo_inl = run(
        "stereo", bench_stereo_step, K_np, num_features
    )
    extra["stereo_tracked_fps"] = round(fps_stereo, 2)
    extra["stereo_kp_z_valid_frac"] = round(z_frac, 3)
    extra["stereo_n_inliers"] = stereo_inl

    full = run("full_pipeline", bench_full_pipeline, num_features)
    extra["full_pipeline_fps"] = full["fps"]
    extra["full_pipeline_ate_pct_of_path"] = full["ate_pct_of_path"]
    extra["full_pipeline_keyframes"] = full["keyframes"]
    extra["full_pipeline_landmarks"] = full["landmarks"]

    # Sequence scale: 256 frames, landmark budget active, ONE BA bucket for
    # the whole run; max_call_ms is the no-mid-run-recompile evidence,
    # ba_shapes the packed-shape log. Sprite count scales with the longer
    # path so the per-frame feature density matches the 64-frame run. The
    # budget of 3072 inside the 4096 point bucket keeps every landmark the
    # BA window packs while bounding the host map scan.
    full_long = run(
        "full_pipeline_long", bench_full_pipeline, num_features,
        n_frames=256, frame_kw={"n_sprites": 3400, "stratified": True},
        max_landmarks=3072, point_floor=4096,
    )
    extra["full_pipeline_long_fps"] = full_long["fps"]
    extra["full_pipeline_long_ate_pct_of_path"] = full_long["ate_pct_of_path"]
    extra["full_pipeline_long_frames_timed"] = full_long["frames_timed"]
    extra["full_pipeline_long_keyframes"] = full_long["keyframes"]
    extra["full_pipeline_long_landmarks"] = full_long["landmarks"]
    extra["full_pipeline_long_ba_shapes"] = ",".join(full_long["ba_shapes"])
    extra["full_pipeline_long_max_call_ms"] = full_long["max_call_ms"]

    sp = run("stereo_pipeline", bench_stereo_pipeline, num_features)
    extra["stereo_pipeline_fps"] = sp["fps"]
    extra["stereo_pipeline_ate_pct_of_path_metric"] = sp["ate_pct_of_path"]
    extra["stereo_pipeline_keyframes"] = sp["keyframes"]
    extra["stereo_pipeline_landmarks"] = sp["landmarks"]

    lp = run("loop_pipeline", bench_loop_pipeline, num_features)
    extra["loop_pipeline_ate_on"] = lp["ate_on_pct"]
    extra["loop_pipeline_ate_off"] = lp["ate_off_pct"]
    extra["loop_pipeline_fps"] = lp["fps_on"]
    extra["loop_pipeline_closures"] = lp["loops_closed"]

    le = run("loop_endurance", bench_loop_endurance_device)
    extra["loop_endurance_ate_on"] = le["ate_on_pct"]
    extra["loop_endurance_ate_off"] = le["ate_off_pct"]
    extra["loop_endurance_closures"] = le["loops_closed"]
    extra["loop_endurance_relocs"] = le["relocs"]

    extra["multiseq4_agg_fps"] = round(
        run("multiseq4", bench_multiseq, frames, K_np, 4, num_features), 2
    )

    pg_ms, pg_cost = run("pose_graph", bench_pose_graph)
    extra["pose_graph_ms_256kf_8loops"] = round(pg_ms, 2)
    extra["pose_graph_cost"] = round(pg_cost, 6)

    print(json.dumps({
        "metric": "tracked_fps_2000feat_kitti",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / 30.0, 3),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
