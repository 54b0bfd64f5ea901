"""Pipeline-parallel front-end/back-end split over a 2-stage device mesh.

The reference runs tracking and optimization in separate HOST threads
(visual_slam/slam.py + handlers, timer-driven); the device equivalent is
a DEVICE pipeline: stage 0 (front-end) runs detection + descriptor matching
for frame t while stage 1 (back-end) runs the robust pose solve for frame
t-1 — concurrently, on different chips of a ``pp`` mesh axis, exchanging the
fixed-shape 3D-2D candidate payload over the device interconnect with one
``ppermute`` per frame.
The whole T-frame loop is ONE jitted ``shard_map`` program (lax.scan), so
the pipeline never returns to the host between frames.

Payloads are fixed-shape (num_features slots + validity), poses come back
with a one-frame pipeline latency (the classic single-bubble fill).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import matching as m_ops
from ..ops.detector import Features, detect_and_describe_with_sampling
from ..ops.pnp import ransac_pnp, refine_pose_gn, _reproj_err2
from ..ops.projection import normalize_points


class _Payload(NamedTuple):
    pts3d: jnp.ndarray  # (K, 3) candidate landmark per keypoint slot
    xy_norm: jnp.ndarray  # (K, 2) normalized observations
    valid: jnp.ndarray  # (K,) f32 candidate validity (f32: ppermute-friendly)


def make_frontback_pipeline(
    K: jnp.ndarray,
    mesh: Mesh,
    axis: str = "pp",
    num_features: int = 512,
    fast_threshold: float = 20.0,
    n_levels: int = 2,
    scale: float = 1.2,
    grid: int = 4,
    ratio: float = 0.75,
    pnp_threshold_px: float = 3.0,
    gn_iters: int = 10,
    pnp_hypotheses: int = 64,
    seed: int = 0,
    batch_axis: str | None = None,
):
    """Build fn(frames (T,H,W), ref_feats, ref_landmarks (K,3), ref_has (K,),
    T0 (4,4), sampling) -> (T_w2c (T,4,4), n_inliers (T,)).

    Pipeline latency one frame: output row t is the back-end solve of frame
    t-1 (row 0 is the bubble-fill step and returns T0). Requires mesh axis
    ``axis`` of size 2.

    With ``batch_axis`` set, every input gains a leading sequence axis
    sharded over that mesh axis (frames (S, T, H, W), ref blocks (S, ...),
    T0 (S, 4, 4)) and the pipeline runs data-parallel sequences THROUGH the
    2-stage pp split — the combined seq x pp deployment (each pp stage
    processes its shard's sequences concurrently; payloads ride one
    ppermute per frame regardless of S).
    """
    if mesh.shape[axis] != 2:
        raise ValueError(f"front/back pipeline needs mesh axis {axis!r} of size 2")
    Kinv = jnp.linalg.inv(K)
    thresh = pnp_threshold_px / float(K[0, 0])

    def front(frame, ref_feats, ref_lm, ref_has, sampling):
        feats = detect_and_describe_with_sampling(
            frame, sampling,
            num_features=num_features, threshold=fast_threshold,
            n_levels=n_levels, scale=scale, grid=grid,
        )
        match = m_ops.match_descriptors(
            feats.desc, ref_feats.desc, feats.valid, ref_feats.valid,
            feats.angle, ref_feats.angle,
            ratio=ratio, cross_check=True, use_orientation=True,
        )
        ti = match["train_idx"]
        valid = match["valid"] & ref_has[ti]
        return _Payload(
            pts3d=ref_lm[ti],
            xy_norm=normalize_points(Kinv, feats.xy),
            valid=valid.astype(jnp.float32),
        )

    def back(payload: _Payload, T_prev, key):
        """Robust back-end solve: RANSAC hypotheses + previous-pose GN
        fallback, better-inlier-count wins (the fused track step's policy —
        GN alone diverged as the reference keyframe aged, dropping the
        deployable PipelinedVO to single-digit inliers within a chunk)."""
        valid_b = payload.valid > 0
        res = ransac_pnp(
            payload.pts3d, payload.xy_norm, valid_b, key,
            n_hyp=pnp_hypotheses, thresh=thresh,
        )
        R_f, t_f = refine_pose_gn(
            T_prev[:3, :3], T_prev[:3, 3],
            payload.pts3d, payload.xy_norm, payload.valid,
            iters=gn_iters, huber=thresh,
        )
        err_f = _reproj_err2(R_f, t_f, payload.pts3d, payload.xy_norm)
        inl_f = (err_f < thresh * thresh) & valid_b
        use_fallback = jnp.sum(inl_f) > res["n_inliers"]
        R = jnp.where(use_fallback, R_f, res["R"])
        t = jnp.where(use_fallback, t_f, res["t"])
        n_inl = jnp.where(use_fallback, jnp.sum(inl_f), res["n_inliers"])
        T_new = jnp.eye(4, dtype=T_prev.dtype).at[:3, :3].set(R).at[:3, 3].set(t)
        ok = n_inl >= 6
        T_new = jnp.where(ok, T_new, T_prev)
        return T_new, n_inl.astype(jnp.int32)

    def _zero_payload(dtype=jnp.float32):
        return _Payload(
            pts3d=jnp.zeros((num_features, 3), dtype),
            xy_norm=jnp.zeros((num_features, 2), dtype),
            valid=jnp.zeros((num_features,), dtype),
        )

    bspec = P() if batch_axis is None else P(batch_axis)
    # Batched outputs are (pp, T, S_local, ...) per shard: reassemble the
    # sequence axis across batch_axis shards.
    ospec = (
        (P(axis), P(axis))
        if batch_axis is None
        else (P(axis, None, batch_axis), P(axis, None, batch_axis))
    )

    @jax.jit
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(bspec, bspec, bspec, bspec, bspec, P()),
        out_specs=ospec,
    )
    def _pipeline(frames, ref_feats, ref_lm, ref_has, T0, sampling):
        r = jax.lax.axis_index(axis)
        if batch_axis is None:
            front_fn = front
            back_fn = back
            zero_fn = _zero_payload
            frames_scan = frames  # (T, H, W) -> scan over T
            T0_ = T0.astype(jnp.float32)
            zero_inl = lambda: jnp.asarray(0, jnp.int32)
        else:
            # Local block: (S_local, T, ...). vmap the per-sequence stage
            # bodies; scan stays over the TIME axis.
            front_fn = jax.vmap(front, in_axes=(0, 0, 0, 0, None))
            back_fn = jax.vmap(back, in_axes=(0, 0, 0))
            S_local = frames.shape[0]
            # Constants must be MARKED varying over the batch axis: the
            # live branches' outputs derive from seq-sharded inputs, and
            # cond/scan demand matching varying-axis types.
            zero_fn = lambda: jax.lax.pcast(
                jax.tree.map(
                    lambda a: jnp.broadcast_to(a, (S_local,) + a.shape),
                    _zero_payload(),
                ),
                (batch_axis,),
                to="varying",
            )
            frames_scan = jnp.swapaxes(frames, 0, 1)  # (T, S_local, H, W)
            T0_ = T0.astype(jnp.float32)
            zero_inl = lambda: jax.lax.pcast(
                jnp.zeros((S_local,), jnp.int32), (batch_axis,), to="varying"
            )

        def step(carry, frame):
            payload_prev, T_prev, key = carry
            key, sub = jax.random.split(key)
            subs = sub if batch_axis is None else jax.random.split(sub, frames.shape[0])
            # Stage 0 (this chip, frame t) and stage 1 (other chip, frame
            # t-1) execute their cond branches CONCURRENTLY; the ppermute at
            # the step boundary hands frame t's candidates to the back-end.
            payload = jax.lax.cond(
                r == 0,
                lambda: front_fn(frame, ref_feats, ref_lm, ref_has, sampling),
                lambda: zero_fn(),
            )
            T_new, n_inl = jax.lax.cond(
                r == 1,
                lambda: back_fn(payload_prev, T_prev, subs),
                lambda: (
                    T_prev,
                    jax.lax.pcast(zero_inl(), (axis,), to="varying"),
                ),
            )
            payload_recv = jax.lax.ppermute(payload, axis, [(0, 1)])
            return (payload_recv, T_new, key), (T_new, n_inl)

        # Initial carry must be marked device-varying over the pp axis (the
        # cond-on-rank outputs are varying, and scan demands matching types);
        # the PRNG key advances identically on both ranks and stays uniform.
        init = jax.lax.pcast((zero_fn(), T0_), (axis,), to="varying") + (
            jax.random.PRNGKey(seed),
        )
        (_, _, _), (Ts, n_inls) = jax.lax.scan(step, init, frames_scan)
        # Per-shard outputs: stage 1's rows carry the solves. Leading axis
        # sharded over pp -> caller reads the rank-1 block.
        return Ts[None], n_inls[None]

    def pipeline(frames, ref_feats: Features, ref_lm, ref_has, T0, sampling):
        Ts, n_inls = _pipeline(
            frames, ref_feats, jnp.asarray(ref_lm, jnp.float32),
            jnp.asarray(ref_has), jnp.asarray(T0, jnp.float32), sampling,
        )
        return Ts[1], n_inls[1]  # rank-1 (back-end) shard

    return pipeline
