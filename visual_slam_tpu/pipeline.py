"""Fused device-resident visual-odometry pipeline.

This is the performance path: one jitted program per frame covering
  detect (pyramid/FAST/rBRIEF) -> match (matmul Hamming) -> 3D-2D gather ->
  RANSAC-PnP + GN refine -> motion-model update
with ALL state (reference features, landmark slots, poses) living on device
as a fixed-shape pytree. The host only feeds images and occasionally swaps
the reference-keyframe block (at keyframe boundaries). This replaces the
reference's per-frame OpenCV/numpy round-trips (SURVEY.md §3.2 hot path)
with a single XLA executable.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .ops import matching as m_ops
from .ops.detector import Features, detect_and_describe_with_sampling
from .ops.pnp import (
    ransac_pnp,
    ransac_pnp_depth,
    refine_pose_gn,
    refine_pose_gn_depth,
    _reproj_err2,
)
from .ops.projection import normalize_points
from .ops.lie import se3_inverse


class TrackState(NamedTuple):
    """Device-resident tracking state."""

    ref_feats: Features  # reference keyframe feature block
    ref_landmarks: jnp.ndarray  # (K, 3) landmark position per ref kp slot
    ref_has_landmark: jnp.ndarray  # (K,) bool
    T_w2c: jnp.ndarray  # (4, 4) current pose
    T_rel: jnp.ndarray  # (4, 4) constant-velocity motion model
    key: jnp.ndarray  # PRNG state
    # Local-map landmark arena (projection-guided association inside the
    # fused step — the ORB-SLAM "track local map" stage). All-invalid blocks
    # disable the stage's effect without changing the compiled program.
    lm_pos: jnp.ndarray = None  # (M, 3)
    lm_desc: jnp.ndarray = None  # (M, 8) packed rBRIEF
    lm_valid: jnp.ndarray = None  # (M,) bool


class TrackOutput(NamedTuple):
    T_w2c: jnp.ndarray
    n_inliers: jnp.ndarray
    n_matches: jnp.ndarray
    features: Features  # current-frame features (for KF promotion host-side)
    match_train_idx: jnp.ndarray
    match_valid: jnp.ndarray
    pnp_inliers: jnp.ndarray
    # Guided local-map association per current keypoint (arena row + valid);
    # zeros when the step was built without a local map.
    guided_idx: jnp.ndarray = None
    guided_valid: jnp.ndarray = None
    # Per-keypoint stereo depth measurements (stereo steps only; None on
    # mono). Host-side keyframe promotion feeds these to the stereo handler.
    kp_z: jnp.ndarray = None
    kp_z_valid: jnp.ndarray = None


def make_track_step(
    K: jnp.ndarray,
    num_features: int = 2000,
    fast_threshold: float = 20.0,
    n_levels: int = 4,
    scale: float = 1.2,
    grid: int = 8,
    ratio: float = 0.75,
    pnp_hypotheses: int = 128,
    pnp_threshold_px: float = 3.0,
    local_map: bool = False,
    width: float | None = None,
    height: float | None = None,
    guided_radius_px: float = 25.0,
    guided_ratio: float = 0.8,
    stereo: bool = False,
    baseline: float = 0.0,
    stereo_row_tolerance: float = 2.0,
    min_depth: float = 0.1,
):
    # 128 hypotheses: at the >=60% inlier ratios of steady-state tracking the
    # clean-sample probability is ~1 - 1e-6, and the motion-model GN fallback
    # covers degraded frames; the hypothesis batch is a large share of the
    # step, so 256 would cost frame rate for no robustness.
    """Build the jitted per-frame tracking step for a fixed camera/config.

    With ``local_map=True`` the step additionally projects the state's
    landmark arena into the constant-velocity predicted pose and associates
    landmarks to keypoints inside a pixel window (ops.guided_matching) — the
    ORB-SLAM "track local map" stage the reference lacks — and PnP runs on
    the union of guided and reference-block pairs (guided wins per keypoint:
    it covers landmarks the reference block never saw).

    With ``stereo=True`` (requires ``baseline > 0``) the step takes a
    (2, H, W) image pair, detects on BOTH cameras, measures per-keypoint
    depth via the row-gated Hamming matcher (ops/stereo.py), and solves a
    depth-aware PnP (normalized-disparity residual) — the full rectified-
    stereo tracking step in ONE compiled program (reference stereo tracking
    is a stub, visual_slam/tracking.py:415-430)."""
    Kinv = jnp.linalg.inv(K)
    focal = K[0, 0]
    thresh = pnp_threshold_px / focal
    w_img = float(width) if width is not None else float(2.0 * K[0, 2])
    h_img = float(height) if height is not None else float(2.0 * K[1, 2])
    bf = baseline * float(K[0, 0])
    if stereo and baseline <= 0:
        raise ValueError("stereo=True requires a positive baseline")
    from .ops import orb as orb_ops
    from .ops.guided_matching import guided_match
    from .ops.stereo import stereo_feature_depths

    @jax.jit
    def _track_step(state: TrackState, img: jnp.ndarray, sampling: jnp.ndarray):
        def detect(im):
            return detect_and_describe_with_sampling(
                im,
                sampling,
                num_features=num_features,
                threshold=fast_threshold,
                n_levels=n_levels,
                scale=scale,
                grid=grid,
            )

        if stereo:
            feats = detect(img[0])
            feats_r = detect(img[1])
            sd = stereo_feature_depths(
                feats.xy, feats.desc, feats.valid,
                feats_r.xy, feats_r.desc, feats_r.valid,
                bf, row_tolerance=stereo_row_tolerance,
                max_disparity=bf / min_depth,
            )
            kp_z = sd["z"]
            kp_z_valid = sd["valid"] & (kp_z > min_depth)
        else:
            feats = detect(img)
            kp_z = jnp.zeros(num_features, jnp.float32)
            kp_z_valid = jnp.zeros(num_features, bool)
        match = m_ops.match_descriptors(
            feats.desc, state.ref_feats.desc, feats.valid, state.ref_feats.valid,
            feats.angle, state.ref_feats.angle,
            ratio=ratio, cross_check=True, use_orientation=True,
        )
        ti = match["train_idx"]
        pair_valid = match["valid"] & state.ref_has_landmark[ti]
        pts3d = state.ref_landmarks[ti]
        xy_norm = normalize_points(Kinv, feats.xy)

        key, sub = jax.random.split(state.key)
        T_pred = state.T_rel @ state.T_w2c
        if local_map:
            # Rotation-adaptive search window: the constant-velocity
            # prediction lags turn onsets by a fraction of the per-frame
            # rotation, whose pixel-scale is ~focal x angle. A static 25 px
            # window lost tracking at 6 deg/frame yaw; a static 40 px
            # admitted aliases that doubled ATE under fast translation.
            from .ops.lie import rotation_angle

            rot = rotation_angle(state.T_rel[:3, :3])
            radius_t = jnp.clip(
                guided_radius_px + focal * rot,
                guided_radius_px,
                4.0 * guided_radius_px,
            )
            g = guided_match(
                state.lm_pos, state.lm_desc, state.lm_valid, T_pred, K,
                feats.xy, feats.desc, feats.valid, w_img, h_img,
                radius_px=radius_t, ratio=guided_ratio,
            )
            guided_idx = g["lm_idx"]
            # The cross-checked, orientation-filtered reference-block match
            # is the stricter association — keep it where present; guided
            # pairs (ratio-only, radius-gated) fill keypoints the reference
            # block could not serve (A/B: guided-wins degraded ATE 3.7x).
            guided_valid = g["valid"] & ~pair_valid
            pts3d = jnp.where(guided_valid[:, None], g["pts3d"], pts3d)
            pair_valid = guided_valid | pair_valid
        else:
            guided_idx = jnp.zeros(num_features, jnp.int32)
            guided_valid = jnp.zeros(num_features, bool)
        if stereo:
            res = ransac_pnp_depth(
                pts3d, xy_norm, pair_valid, kp_z, kp_z_valid, baseline, sub,
                n_hyp=pnp_hypotheses, thresh=thresh,
            )
            R_f, t_f = refine_pose_gn_depth(
                T_pred[:3, :3], T_pred[:3, 3], pts3d, xy_norm,
                pair_valid.astype(jnp.float32),
                kp_z, kp_z_valid.astype(jnp.float32), baseline,
                iters=8, huber=thresh,
            )
        else:
            res = ransac_pnp(
                pts3d, xy_norm, pair_valid, sub,
                n_hyp=pnp_hypotheses, thresh=thresh,
            )
            # Motion-model fallback: robust GN from the predicted pose.
            R_f, t_f = refine_pose_gn(
                T_pred[:3, :3], T_pred[:3, 3], pts3d, xy_norm,
                pair_valid.astype(jnp.float32), iters=8, huber=thresh,
            )
        err_f = _reproj_err2(R_f, t_f, pts3d, xy_norm)
        inl_f = (err_f < thresh * thresh) & pair_valid
        use_fallback = jnp.sum(inl_f) > res["n_inliers"]
        R = jnp.where(use_fallback, R_f, res["R"])
        t = jnp.where(use_fallback, t_f, res["t"])
        inliers = jnp.where(use_fallback, inl_f, res["inliers"])
        n_inl = jnp.sum(inliers)

        T_new = jnp.eye(4, dtype=state.T_w2c.dtype).at[:3, :3].set(R).at[:3, 3].set(t)
        ok = n_inl >= 6
        T_new = jnp.where(ok, T_new, T_pred)
        T_rel = jnp.where(ok, T_new @ se3_inverse(state.T_w2c), state.T_rel)

        new_state = state._replace(T_w2c=T_new, T_rel=T_rel, key=key)
        out = TrackOutput(
            T_w2c=T_new,
            n_inliers=n_inl,
            n_matches=match["n_matches"],
            features=feats,
            match_train_idx=ti,
            match_valid=match["valid"],
            pnp_inliers=inliers,
            guided_idx=guided_idx,
            guided_valid=guided_valid,
            kp_z=kp_z,
            kp_z_valid=kp_z_valid,
        )
        return new_state, out

    def track_step(state: TrackState, img: jnp.ndarray):
        # The sampling matrix rides as a traced argument (uploaded once).
        return _track_step(state, img, orb_ops.active_sampling())

    track_step.jitted = _track_step  # explicit-sampling variant for composition
    return track_step


def make_track_chunk(track_step):
    """Multi-frame device-side tracking: ``lax.scan`` the fused step over a
    (C, ...) image chunk so C frames cost ONE dispatch; chunking amortizes
    per-dispatch latency C-fold. Host decisions (keyframe
    promotion, LOST) read the chunk's STACKED scalars in a single fetch at
    the chunk boundary — the reference block stays fixed within a chunk,
    which is the same staleness the deferred per-frame decision already
    tolerates (models/compiled_slam.py).

    ``track_step`` is the function returned by :func:`make_track_step`; the
    chunk reuses its jitted body so mono/stereo/local-map variants compose
    unchanged. Returns ``chunk(state, imgs (C, ...)) -> (state, outs)`` with
    every TrackOutput leaf stacked along a leading C axis.
    """
    inner = track_step.jitted

    @jax.jit
    def _chunk(state: TrackState, imgs: jnp.ndarray, sampling: jnp.ndarray):
        def body(s, img):
            s, out = inner(s, img, sampling)
            return s, out

        return jax.lax.scan(body, state, imgs)

    def chunk(state: TrackState, imgs: jnp.ndarray):
        from .ops import orb as orb_ops

        return _chunk(state, imgs, orb_ops.active_sampling())

    chunk.jitted = _chunk
    return chunk


class PromoteRecord(NamedTuple):
    """Per-frame record of an in-chunk device-side keyframe promotion
    (:func:`make_track_chunk_promote`). ``ref_pos``/``ref_has`` are the
    post-promotion reference landmark block (per current-frame keypoint
    slot) — the host rebuilds the promoted KeyFrame and its new landmarks
    from these without any extra dispatch. ``ref_tri`` marks the slots the
    DEVICE triangulated fresh (vs inherited): only these may mint new
    MapPoints on the host — an inherited slot whose host-side link fails
    (arena landmark fused/culled meanwhile) must be dropped, not duplicated,
    and its match train index may be meaningless for guided-only slots."""

    promoted: jnp.ndarray  # () bool
    ref_pos: jnp.ndarray  # (K, 3)
    ref_has: jnp.ndarray  # (K,) bool
    ref_tri: jnp.ndarray  # (K,) bool — device-triangulated subset of ref_has


def make_track_chunk_promote(
    track_step,
    K: jnp.ndarray,
    min_inliers: int = 15,
    keyframe_interval: int = 4,
    kf_min_matches: int = 60,
    kf_min_rotation_deg: float = 10.0,
    kf_min_translation: float = 1.0,
    min_depth: float = 0.1,
    max_depth: float = 1e6,
    min_parallax_deg: float = 0.5,
    pnp_threshold_px: float = 3.0,
    stereo: bool = False,
):
    """Chunked tracking with IN-CHUNK keyframe promotion: the scan body
    evaluates the keyframe gates (interval / match decay / rotation /
    translation — the same policy models/compiled_slam.py applies at chunk
    boundaries) every frame, ON DEVICE, and on trigger swaps the reference
    block to the current frame — inheriting landmark positions from the
    guided-arena and reference associations and triangulating fresh ones:
    mono against the old reference (ops.triangulation.triangulate_gated,
    parallax/depth/reproj gated), stereo directly from the step's own
    disparity depths (``out.kp_z`` — no parallax wait; every depth-valid
    keypoint can seed a metric landmark) — all inside the ONE compiled
    program.

    This removes the map-starvation ceiling on chunk size: a plain chunk
    (make_track_chunk) holds the reference fixed for chunk_size frames, so
    sequences whose feature matches decay in ~4 frames cap chunk_size at 4
    and with it the amortization of per-dispatch latency + host
    boundary work. With self-promotion the device keeps its own reference
    fresh and chunk_size can grow to 8-16; the host trails at chunk
    boundaries, rebuilding the promoted keyframes from the emitted
    :class:`PromoteRecord`s (zero extra dispatches) and re-installing a
    BA-corrected state.

    Returns ``chunk(state, fsr, T_ref, imgs (C, ...)) -> (state, fsr,
    T_ref, outs, recs)`` where ``fsr`` is frames-since-reference (int32)
    and ``T_ref`` the current reference pose — both re-seeded by the host
    at every boundary.
    """
    from .ops import orb as orb_ops
    from .ops.lie import rotation_angle
    from .ops.triangulation import triangulate_gated

    import numpy as np

    inner = track_step.jitted
    Kinv = jnp.linalg.inv(K)
    rot_thresh = float(np.deg2rad(kf_min_rotation_deg))
    par_thresh = float(np.deg2rad(min_parallax_deg))
    reproj_n = float(pnp_threshold_px / np.asarray(K)[0, 0])

    def promote_block(s: TrackState, out: TrackOutput, T_ref):
        """New reference block from the current frame's associations."""
        ti = out.match_train_idx
        inl = out.pnp_inliers
        g_ok = out.guided_valid & inl
        has_ref = s.ref_has_landmark[ti]
        inherit_ref = out.match_valid & inl & has_ref & ~g_ok
        pos = s.ref_landmarks[ti]
        if s.lm_pos is not None:
            pos = jnp.where(g_ok[:, None], s.lm_pos[out.guided_idx], pos)
        has = g_ok | inherit_ref
        if stereo:
            # Stereo mint: backproject the step's own disparity depths
            # (x_cam = z * Kinv [u, v, 1]; X = R^T (x_cam - t)). No
            # two-view parallax gate needed — depth is metric per frame.
            z = out.kp_z
            tri_cand = (
                out.features.valid & ~has & out.kp_z_valid
                & (z > min_depth) & (z < max_depth)
            )
            uv1 = jnp.concatenate(
                [out.features.xy, jnp.ones_like(out.features.xy[:, :1])], -1
            )
            x_cam = (uv1 @ Kinv.T) * z[:, None]
            Rc = out.T_w2c[:3, :3]
            pts_tri = (x_cam - out.T_w2c[:3, 3]) @ Rc
            tri_ok = tri_cand
        else:
            tri_cand = out.match_valid & ~has_ref & ~has
            pts_tri, tri_good = triangulate_gated(
                Kinv, T_ref, out.T_w2c,
                s.ref_feats.xy[ti], out.features.xy,
                jnp.float32(min_depth), jnp.float32(max_depth),
                jnp.float32(par_thresh), jnp.float32(reproj_n),
            )
            tri_ok = tri_cand & tri_good
        pos = jnp.where(tri_ok[:, None], pts_tri, pos)
        has = has | tri_ok
        s2 = s._replace(
            ref_feats=out.features, ref_landmarks=pos, ref_has_landmark=has
        )
        return s2, pos, has, tri_ok

    @jax.jit
    def _chunk(state: TrackState, fsr, T_ref, imgs, sampling, n_valid):
        def body(carry, frame):
            img, i = frame
            s, fsr, T_ref = carry
            s, out = inner(s, img, sampling)
            fsr = fsr + 1
            ok = out.n_inliers >= min_inliers
            rot = rotation_angle(out.T_w2c[:3, :3] @ T_ref[:3, :3].T)
            C_cur = -out.T_w2c[:3, :3].T @ out.T_w2c[:3, 3]
            C_ref = -T_ref[:3, :3].T @ T_ref[:3, 3]
            trigger = (
                (fsr > keyframe_interval)
                | (out.n_inliers < kf_min_matches)
                | (rot > rot_thresh)
                | (jnp.linalg.norm(C_cur - C_ref) > kf_min_translation)
            )
            # Flush pads the chunk by duplicating the last frame; a padded
            # frame must never swap the device reference (the host discards
            # its PromoteRecord, desynchronizing device vs host reference,
            # and phantom promos can force a full compact-fetch overflow).
            promote = ok & trigger & (i < n_valid)
            s, ref_pos, ref_has, ref_tri = jax.lax.cond(
                promote,
                promote_block,
                lambda s, out, T_ref: (
                    s,
                    jnp.zeros_like(s.ref_landmarks),
                    jnp.zeros_like(s.ref_has_landmark),
                    jnp.zeros_like(s.ref_has_landmark),
                ),
                s, out, T_ref,
            )
            fsr = jnp.where(promote, 0, fsr)
            T_ref = jnp.where(promote, out.T_w2c, T_ref)
            rec = PromoteRecord(
                promoted=promote, ref_pos=ref_pos, ref_has=ref_has,
                ref_tri=ref_tri,
            )
            return (s, fsr, T_ref), (out, rec)

        (s, fsr, T_ref), (outs, recs) = jax.lax.scan(
            body, (state, fsr, T_ref),
            (imgs, jnp.arange(imgs.shape[0], dtype=jnp.int32)),
        )
        return s, fsr, T_ref, outs, recs

    def chunk(state: TrackState, fsr, T_ref, imgs: jnp.ndarray, n_valid=None):
        C = imgs.shape[0]
        return _chunk(
            state,
            jnp.asarray(fsr, jnp.int32),
            jnp.asarray(T_ref, jnp.float32),
            imgs,
            orb_ops.active_sampling(),
            jnp.asarray(C if n_valid is None else n_valid, jnp.int32),
        )

    chunk.jitted = _chunk
    return chunk


class CompactChunk(NamedTuple):
    """Slimmed boundary fetch for the devpromo chunk: the decision scalars
    for every frame plus the FULL per-keypoint blocks for only the promoted
    frames (gathered on device into ``P`` fixed slots). At chunk_size 8 with
    the typical 1-2 promotions this is ~4x less payload than fetching the
    whole stacked TrackOutput+PromoteRecord."""

    # Per-frame decision scalars (C, ...): tiny.
    T_w2c: jnp.ndarray
    n_inliers: jnp.ndarray
    n_matches: jnp.ndarray
    promoted: jnp.ndarray
    n_promoted: jnp.ndarray  # () int32 — host checks overflow (> P slots)
    # Promoted-frame blocks (P, ...): slot i holds the i-th promoted frame.
    slot_frame: jnp.ndarray  # (P,) int32 frame index within chunk, C if empty
    feats: Features  # (P, K, ...) promoted frames' features
    match_train_idx: jnp.ndarray  # (P, K)
    match_valid: jnp.ndarray  # (P, K)
    pnp_inliers: jnp.ndarray  # (P, K)
    guided_idx: jnp.ndarray  # (P, K)
    guided_valid: jnp.ndarray  # (P, K)
    ref_pos: jnp.ndarray  # (P, K, 3) post-promotion reference landmarks
    ref_has: jnp.ndarray  # (P, K)
    ref_tri: jnp.ndarray  # (P, K) device-triangulated subset of ref_has
    # (P, V) global place signatures of the promoted frames, computed on
    # device inside the SAME fused fetch (loop_closing/signature.py). Loop
    # detection's query signature becomes a host cache hit instead of a
    # dedicated upload+dispatch+fetch round trip per heavy boundary.
    sig: jnp.ndarray


def correction_similarity(T_old: "np.ndarray", T_new: "np.ndarray", s: float):
    """Host-side helper: the world-frame similarity ``x_new = s R_u x + t_u``
    implied by one keyframe's BA/loop-closure pose update T_old -> T_new
    (both w2c) plus the mono-gauge scale ``s``. Applying it to every device-
    resident world quantity re-anchors a tracking state that ran ahead of an
    asynchronously-finished solve (the ORB-SLAM relative-correction catch-up;
    same construction as Map.record_gauge_transform's consumer side).

    Derivation: physical camera coords scale with the gauge (c_new = s c),
    so x_new = R_new^T(s c - t_new) with c = R_old x + t_old gives
    R_u = R_new^T R_old and t_u = R_new^T (s t_old - t_new)."""
    import numpy as np

    R_old = np.asarray(T_old, np.float64)[:3, :3]
    t_old = np.asarray(T_old, np.float64)[:3, 3]
    R_new = np.asarray(T_new, np.float64)[:3, :3]
    t_new = np.asarray(T_new, np.float64)[:3, 3]
    R_u = R_new.T @ R_old
    t_u = R_new.T @ (s * t_old - t_new)
    return R_u, t_u


@jax.jit
def apply_correction(state: TrackState, T_ref, R_u, t_u, s):
    """Re-anchor a device tracking state into a post-BA world frame without
    any host round trip: landmarks move by the similarity x' = s R_u x + t_u,
    w2c poses by R' = R R_u^T, t' = s t - R' t_u (keeps reprojection
    invariant), and the constant-velocity model's translation scales by s.
    Dispatched at the boundary AFTER an async solve finishes — the state's
    own (fresher) reference features are preserved, only geometry moves."""
    R_u = R_u.astype(jnp.float32)
    t_u = t_u.astype(jnp.float32)
    s = jnp.float32(s)

    def fix_pose(T):
        R = T[:3, :3] @ R_u.T
        t = s * T[:3, 3] - R @ t_u
        return T.at[:3, :3].set(R).at[:3, 3].set(t)

    def fix_pts(x):
        return x @ (s * R_u).T + t_u

    T_rel = state.T_rel.at[:3, 3].multiply(s)
    new = state._replace(
        T_w2c=fix_pose(state.T_w2c),
        T_rel=T_rel,
        ref_landmarks=fix_pts(state.ref_landmarks),
    )
    if state.lm_pos is not None:
        new = new._replace(lm_pos=fix_pts(state.lm_pos))
    return new, fix_pose(T_ref)


def make_compact_chunk(P: int, with_sig: bool = False):
    """Build the jitted on-device compaction ``(outs, recs) -> CompactChunk``
    dispatched right after the chunk program (chained on its outputs, ~zero
    compute) so the boundary's single sync moves the slim struct only.

    ``with_sig=False`` (loop closing disabled) skips the place-signature
    matmul and ships a (P, 1) zero placeholder instead — the field is only
    consumed when a LoopClosing instance exists to receive it."""

    from .loop_closing.signature import keyframe_signature

    @jax.jit
    def compact(outs: TrackOutput, recs: PromoteRecord) -> CompactChunk:
        C = outs.T_w2c.shape[0]
        order = jnp.where(recs.promoted, jnp.arange(C), C)
        slots = jnp.sort(order)[:P]  # ascending promoted frame indices
        idx = jnp.minimum(slots, C - 1)

        def g(a):
            return a[idx]

        return CompactChunk(
            T_w2c=outs.T_w2c,
            n_inliers=outs.n_inliers,
            n_matches=outs.n_matches,
            promoted=recs.promoted,
            n_promoted=jnp.sum(recs.promoted.astype(jnp.int32)),
            slot_frame=slots.astype(jnp.int32),
            feats=jax.tree.map(g, outs.features),
            match_train_idx=g(outs.match_train_idx),
            match_valid=g(outs.match_valid),
            pnp_inliers=g(outs.pnp_inliers),
            guided_idx=g(outs.guided_idx),
            guided_valid=g(outs.guided_valid),
            ref_pos=g(recs.ref_pos),
            ref_has=g(recs.ref_has),
            ref_tri=g(recs.ref_tri),
            sig=(
                jax.vmap(keyframe_signature)(
                    g(outs.features.desc), g(outs.features.valid)
                )
                if with_sig
                else jnp.zeros((P, 1), jnp.float32)
            ),
        )

    return compact


def make_frame_step(
    K: jnp.ndarray,
    width: float,
    height: float,
    num_features: int = 2000,
    fast_threshold: float = 20.0,
    n_levels: int = 4,
    scale: float = 1.2,
    grid: int = 8,
    pnp_hypotheses: int = 128,
    pnp_threshold_px: float = 3.0,
    guided_radius_px: float = 25.0,
    guided_ratio: float = 0.8,
    dist: jnp.ndarray | None = None,
    stereo: bool = False,
    rgbd: bool = False,
    baseline: float = 0.0,
    stereo_row_tolerance: float = 2.0,
    min_depth: float = 0.1,
    max_depth: float = 50.0,
    depth_scale: float = 1.0,
):
    """Fused host-pipeline frame step: detect -> projection-guided landmark
    association -> RANSAC-PnP (+ predicted-pose GN fallback), ONE jitted
    program. Unlike ``make_track_step`` it takes the local-map landmark
    block and the predicted pose explicitly, so the host Tracking state
    machine can drive it while paying a single dispatch per frame.
    With ``stereo=True`` the image argument is a (2, H, W) pair; the step
    detects on both cameras, measures per-keypoint depth, and solves the
    depth-aware PnP (returns features_right/kp_z/kp_z_valid additionally).
    With ``rgbd=True`` the image argument is a (2, H, W) stack of
    (gray, depth): per-keypoint depth is looked up in-program and the same
    depth-aware PnP runs with the virtual ``baseline``.

    Returns fn(img, lm_pos (M,3), lm_desc (M,8) u32, lm_valid (M,),
    T_pred (4,4), key) -> dict(features, T_w2c, n_inliers, pair_valid,
    lm_idx, pnp_inliers, ok).
    """
    from .ops.guided_matching import guided_match
    from .ops.projection import undistort_pixels
    from .ops.stereo import sample_depth_at, stereo_feature_depths

    Kinv = jnp.linalg.inv(K)
    focal = K[0, 0]
    thresh = pnp_threshold_px / focal
    dist_arr = None if dist is None else jnp.asarray(dist, jnp.float32)
    bf = baseline * float(K[0, 0])
    if (stereo or rgbd) and baseline <= 0:
        raise ValueError("stereo/rgbd requires a positive (virtual) baseline")
    use_depth = stereo or rgbd

    @jax.jit
    def _frame_step(img, lm_pos, lm_desc, lm_valid, T_pred, key, sampling):
        def detect(im):
            f = detect_and_describe_with_sampling(
                im, sampling,
                num_features=num_features, threshold=fast_threshold,
                n_levels=n_levels, scale=scale, grid=grid,
            )
            if dist_arr is not None:
                # Work in ideal pinhole coordinates throughout (reference
                # camera.py:160-169 undistorts ad hoc; here it is in-program).
                f = f._replace(xy=undistort_pixels(K, Kinv, dist_arr, f.xy))
            return f

        feats_r = None
        if stereo:
            feats = detect(img[0])
            feats_r = detect(img[1])
            sd = stereo_feature_depths(
                feats.xy, feats.desc, feats.valid,
                feats_r.xy, feats_r.desc, feats_r.valid,
                bf, row_tolerance=stereo_row_tolerance,
                max_disparity=bf / min_depth,
            )
            kp_z = sd["z"]
            kp_z_valid = sd["valid"] & (kp_z > min_depth)
        elif rgbd:
            feats = detect(img[0])
            sd = sample_depth_at(img[1], feats.xy, depth_scale=depth_scale)
            kp_z = sd["z"]
            # feats.valid gate: padded keypoint slots sit at (0, 0), where
            # the depth map is usually non-zero — without the gate every
            # empty slot gets a "valid" depth and the keyframe handler mints
            # piles of identical bogus landmarks on the (0,0) ray.
            kp_z_valid = (
                sd["valid"] & feats.valid & (kp_z > min_depth) & (kp_z < max_depth)
            )
        else:
            feats = detect(img)
            kp_z = jnp.zeros(num_features, jnp.float32)
            kp_z_valid = jnp.zeros(num_features, bool)
        g = guided_match(
            lm_pos, lm_desc, lm_valid, T_pred, K,
            feats.xy, feats.desc, feats.valid, width, height,
            radius_px=guided_radius_px, ratio=guided_ratio,
        )
        pts3d = g["pts3d"]
        pair_valid = g["valid"]
        xy_norm = normalize_points(Kinv, feats.xy)
        if use_depth:
            res = ransac_pnp_depth(
                pts3d, xy_norm, pair_valid, kp_z, kp_z_valid, baseline, key,
                n_hyp=pnp_hypotheses, thresh=thresh,
            )
            R_f, t_f = refine_pose_gn_depth(
                T_pred[:3, :3], T_pred[:3, 3], pts3d, xy_norm,
                pair_valid.astype(jnp.float32),
                kp_z, kp_z_valid.astype(jnp.float32), baseline,
                iters=8, huber=thresh,
            )
        else:
            res = ransac_pnp(
                pts3d, xy_norm, pair_valid, key,
                n_hyp=pnp_hypotheses, thresh=thresh,
            )
            R_f, t_f = refine_pose_gn(
                T_pred[:3, :3], T_pred[:3, 3], pts3d, xy_norm,
                pair_valid.astype(jnp.float32), iters=8, huber=thresh,
            )
        err_f = _reproj_err2(R_f, t_f, pts3d, xy_norm)
        inl_f = (err_f < thresh * thresh) & pair_valid
        use_fallback = jnp.sum(inl_f) > res["n_inliers"]
        R = jnp.where(use_fallback, R_f, res["R"])
        t = jnp.where(use_fallback, t_f, res["t"])
        inliers = jnp.where(use_fallback, inl_f, res["inliers"])
        n_inl = jnp.sum(inliers)
        T = jnp.eye(4, dtype=jnp.float32).at[:3, :3].set(R).at[:3, 3].set(t)
        out = {
            "features": feats,
            "T_w2c": T,
            "n_inliers": n_inl,
            "pair_valid": pair_valid,
            "lm_idx": g["lm_idx"],
            "pnp_inliers": inliers,
            "ok": n_inl >= 6,
        }
        if use_depth:
            out["features_right"] = feats_r
            out["kp_z"] = kp_z
            out["kp_z_valid"] = kp_z_valid
        return out

    def frame_step(img, lm_pos, lm_desc, lm_valid, T_pred, key):
        from .ops import orb as orb_ops

        return _frame_step(
            img, lm_pos, lm_desc, lm_valid, T_pred, key, orb_ops.active_sampling()
        )

    frame_step.jitted = _frame_step
    return frame_step


def init_track_state(
    ref_feats: Features,
    ref_landmarks: jnp.ndarray,
    ref_has_landmark: jnp.ndarray,
    T_w2c: jnp.ndarray,
    seed: int = 0,
    local_map_size: int = 0,
) -> TrackState:
    lm_pos = lm_desc = lm_valid = None
    if local_map_size:
        lm_pos = jnp.zeros((local_map_size, 3), jnp.float32)
        lm_desc = jnp.zeros((local_map_size, ref_feats.desc.shape[-1]), ref_feats.desc.dtype)
        lm_valid = jnp.zeros((local_map_size,), bool)
    return TrackState(
        ref_feats=ref_feats,
        ref_landmarks=jnp.asarray(ref_landmarks, jnp.float32),
        ref_has_landmark=jnp.asarray(ref_has_landmark),
        T_w2c=jnp.asarray(T_w2c, jnp.float32),
        T_rel=jnp.eye(4, dtype=jnp.float32),
        key=jax.random.PRNGKey(seed),
        lm_pos=lm_pos,
        lm_desc=lm_desc,
        lm_valid=lm_valid,
    )


def set_local_map(
    state: TrackState,
    lm_pos: jnp.ndarray,
    lm_desc: jnp.ndarray,
    lm_valid: jnp.ndarray,
) -> TrackState:
    """Install/refresh the local-map landmark arena (keyframe boundaries).
    Shapes must match the arena capacity the state was initialized with."""
    return state._replace(
        lm_pos=jnp.asarray(lm_pos, jnp.float32),
        lm_desc=jnp.asarray(lm_desc),
        lm_valid=jnp.asarray(lm_valid),
    )


def swap_reference(
    state: TrackState,
    ref_feats: Features,
    ref_landmarks: jnp.ndarray,
    ref_has_landmark: jnp.ndarray,
) -> TrackState:
    """Host-side keyframe boundary: install a new reference block."""
    return state._replace(
        ref_feats=ref_feats,
        ref_landmarks=jnp.asarray(ref_landmarks, jnp.float32),
        ref_has_landmark=jnp.asarray(ref_has_landmark),
    )
