"""Projection-guided landmark-to-keypoint matching, pure JAX.

The ORB-SLAM "track local map" search the reference lacks (its tracking is
descriptor-only against the latest keyframe, SURVEY.md §3.2 note): project
every local-map landmark into the constant-velocity predicted pose, then
match each landmark's descriptor against only the keypoints inside a pixel
search window. The spatial gate is a mask over the same matmul Hamming
matrix used everywhere else — no grids/buckets needed.

Produces keypoint-slot-aligned 3D-2D candidates ready for RANSAC-PnP.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .matching import BIG, distance_matrix, is_binary_desc, min2
from .projection import project_points


@partial(jax.jit, static_argnames=("ratio", "max_distance"))
def guided_match(
    lm_pos: jnp.ndarray,  # (M, 3) landmark positions (world)
    lm_desc: jnp.ndarray,  # (M, 8) packed descriptors
    lm_valid: jnp.ndarray,  # (M,) bool
    T_pred: jnp.ndarray,  # (4, 4) predicted T_w2c
    K: jnp.ndarray,  # (3, 3)
    kp_xy: jnp.ndarray,  # (Kp, 2) current keypoints (pixels)
    kp_desc: jnp.ndarray,  # (Kp, 8)
    kp_valid: jnp.ndarray,  # (Kp,) bool
    width: float,
    height: float,
    radius_px: float = 15.0,
    ratio: float = 0.8,
    max_distance: float | None = None,
) -> dict:
    """Returns keypoint-aligned association:
    ``pts3d (Kp, 3)``, ``valid (Kp,) bool``, ``lm_idx (Kp,) int32``.

    The distance metric follows the descriptor width (matching.is_binary_desc):
    Hamming for binary 8-word blocks, L2 for bitcast float families. The
    default absolute-distance gate is metric-appropriate (80 bits / 0.9 L2
    on unit-norm descriptors) when ``max_distance`` is None.
    """
    with jax.named_scope("guided_match"):
        if max_distance is None:
            max_distance = 80.0 if is_binary_desc(lm_desc) else 0.9
        uv, z = project_points(K, T_pred, lm_pos)
        visible = (
            lm_valid
            & (z > 0.1)
            & (uv[:, 0] >= 0) & (uv[:, 0] < width)
            & (uv[:, 1] >= 0) & (uv[:, 1] < height)
        )
        dist = distance_matrix(lm_desc, kp_desc, visible, kp_valid)  # (M, Kp)
        # Spatial gate: landmark's predicted pixel vs keypoint position.
        d2 = jnp.sum((uv[:, None, :] - kp_xy[None, :, :]) ** 2, axis=-1)
        dist = jnp.where(d2 <= radius_px * radius_px, dist, BIG)

        # Best + second keypoint per landmark (ratio test), then invert to a
        # keypoint-aligned table keeping the lowest-distance landmark per kp.
        # (min2, not lax.top_k: three fused reduction passes instead of a sort.)
        best, second, kp_of_lm = min2(dist)
        ok_lm = (best < BIG * 0.5) & (best <= max_distance)
        ok_lm &= best < ratio * second

        Kp = kp_xy.shape[0]
        d_masked = jnp.where(ok_lm, best, BIG)
        # Keypoint-aligned inversion as dense one-hot masked mins instead of an
        # .at[kp_of_lm].min scatter: the (M, Kp) masked reduce fuses with the
        # distance matrix already in flight. Bit-exact with the scatter (min has
        # no rounding).
        onehot = kp_of_lm[:, None] == jnp.arange(Kp)[None, :]  # (M, Kp)
        best_per_kp = jnp.min(jnp.where(onehot, d_masked[:, None], BIG), axis=0)
        M = lm_pos.shape[0]
        mi = jnp.arange(M)
        winner = ok_lm & (d_masked <= best_per_kp[kp_of_lm] + 1e-6)
        # Deterministic tie-break by landmark index.
        lm_val = jnp.where(winner, mi, 1 << 30)
        best_lm_per_kp = jnp.min(
            jnp.where(onehot, lm_val[:, None], 1 << 30), axis=0
        )
        lm_idx = jnp.where(best_lm_per_kp < (1 << 30), best_lm_per_kp, 0).astype(jnp.int32)
        valid = best_lm_per_kp < (1 << 30)
        pts3d = lm_pos[lm_idx]
        return {"pts3d": pts3d, "valid": valid & kp_valid, "lm_idx": lm_idx,
                "n_matches": jnp.sum(valid & kp_valid)}
