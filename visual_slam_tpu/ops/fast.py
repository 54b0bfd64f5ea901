"""FAST-16 corner detection, fully vectorized.

Device replacement for cv2.FastFeatureDetector / cv2.ORB's detection stage
(reference: visual_slam/feature/feature.py:95-99, 180-184).

The classic FAST implementation is branchy and pointer-chasing; here the whole
image is processed as 16 shifted copies (one per ring pixel), the 16
bright/dark comparisons are packed into an int32 bitmask per pixel, and the
"9 contiguous pixels" test becomes 8 shift-ANDs on a doubled mask — pure
elementwise work that XLA fuses into a handful of passes.  Non-max
suppression is a 3x3 max-pool comparison.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# FAST-16 Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
RING_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9/16: need >= 9 contiguous bright or dark ring pixels
BORDER = 3


def _ring_stack(img: jnp.ndarray) -> jnp.ndarray:
    """(H, W) -> (16, H, W): the 16 ring neighbours of every pixel.

    Uses static padded slicing (no gathers) so XLA lowers it to cheap
    shifted views.
    """
    H, W = img.shape
    p = jnp.pad(img, BORDER, mode="edge")
    return jnp.stack(
        [p[BORDER + dy : BORDER + dy + H, BORDER + dx : BORDER + dx + W] for dy, dx in RING_OFFSETS]
    )


def _has_arc(mask16: jnp.ndarray) -> jnp.ndarray:
    """Given an int32 bitmask of 16 ring bits per pixel, test for a circular
    run of >= ARC_LEN set bits. mask16: (..., ) int32 in [0, 2^16)."""
    m = mask16 | (mask16 << 16)  # double the ring to handle wrap-around
    r = m
    for k in range(1, ARC_LEN):
        r = r & (m >> k)
    return (r & 0xFFFF) != 0


@partial(jax.jit, static_argnames=())
def fast_scores(img: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """FAST-9/16 corner response map.

    Args:
      img: (H, W) float32 grayscale (any range; threshold in same units).
      threshold: center/ring intensity difference.

    Returns (H, W) float32 score map: 0 for non-corners; for corners the
    OpenCV-style SAD score (sum of |ring - center| - t over the contributing
    arc's polarity), usable for NMS ranking.
    """
    ring = _ring_stack(img)  # (16, H, W)
    c = img[None]
    bright = ring > c + threshold
    dark = ring < c - threshold

    weights = (1 << jnp.arange(16, dtype=jnp.int32))[:, None, None]
    bmask = jnp.sum(bright.astype(jnp.int32) * weights, axis=0)
    dmask = jnp.sum(dark.astype(jnp.int32) * weights, axis=0)

    is_corner_b = _has_arc(bmask)
    is_corner_d = _has_arc(dmask)

    # SAD-style score restricted to each polarity's contributing pixels.
    bscore = jnp.sum(jnp.where(bright, ring - c - threshold, 0.0), axis=0)
    dscore = jnp.sum(jnp.where(dark, c - ring - threshold, 0.0), axis=0)
    score = jnp.maximum(
        jnp.where(is_corner_b, bscore, 0.0), jnp.where(is_corner_d, dscore, 0.0)
    )
    # Kill the border: ring samples there are edge-padded replicas.
    H, W = img.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    interior = (
        (ys >= BORDER) & (ys < H - BORDER) & (xs >= BORDER) & (xs < W - BORDER)
    )
    return jnp.where(interior, score, 0.0)


@partial(jax.jit, static_argnames=("window",))
def shi_tomasi_scores(
    img: jnp.ndarray, quality_level: float = 0.01, window: int = 5
) -> jnp.ndarray:
    """Shi-Tomasi (min-eigenvalue) corner response map.

    On-device goodFeaturesToTrack scoring (reference delegates to cv2 via
    the ShiTomasiOrbFeature2D factory entry, visual_slam/feature/feature.py):
    Sobel gradients -> windowed structure tensor -> smaller eigenvalue
      lambda_min = (Sxx+Syy)/2 - sqrt(((Sxx-Syy)/2)^2 + Sxy^2),
    thresholded at ``quality_level`` x (map max), cv2 semantics.

    Returns (H, W) float32 scores (0 below threshold / at borders).
    """
    H, W = img.shape
    im = img[None, :, :, None]  # NHWC
    sob_x = jnp.asarray([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
    sob_y = sob_x.T
    k = jnp.stack([sob_x, sob_y], axis=-1)[:, :, None, :]  # HWIO (3,3,1,2)
    g = jax.lax.conv_general_dilated(
        im, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
    )[0]
    gx, gy = g[..., 0], g[..., 1]
    prods = jnp.stack([gx * gx, gy * gy, gx * gy], axis=-1)[None]
    # Box-sum each channel with a depthwise convolution.
    box = jnp.ones((window, window, 1, 3), prods.dtype)
    S = jax.lax.conv_general_dilated(
        prods, box, (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=3,
    )[0]
    Sxx, Syy, Sxy = S[..., 0], S[..., 1], S[..., 2]
    half_tr = 0.5 * (Sxx + Syy)
    half_df = 0.5 * (Sxx - Syy)
    lam_min = half_tr - jnp.sqrt(half_df * half_df + Sxy * Sxy)
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    interior = (
        (ys >= BORDER) & (ys < H - BORDER) & (xs >= BORDER) & (xs < W - BORDER)
    )
    lam_min = jnp.where(interior, lam_min, 0.0)
    thresh = quality_level * jnp.max(lam_min)
    return jnp.where(lam_min > thresh, lam_min, 0.0)


def nms(scores: jnp.ndarray, window: int = 3) -> jnp.ndarray:
    """3x3 (or window^2) non-max suppression: keep local maxima.

    Exact tie-break toward the lexicographically first pixel (two pooling
    passes: max score, then min index among the tied maxima) so plateaus
    don't produce duplicate corners and scores are never perturbed.
    """
    H, W = scores.shape
    pooled = jax.lax.reduce_window(
        scores, -jnp.inf, jax.lax.max, (window, window), (1, 1), "SAME"
    )
    is_max = (scores >= pooled) & (scores > 0.0)
    idx = (
        jax.lax.broadcasted_iota(jnp.int32, (H, W), 0) * W
        + jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    )
    big = jnp.int32(H * W + 1)
    tie_idx = jnp.where(is_max, idx, big)
    pooled_idx = jax.lax.reduce_window(
        tie_idx, big, jax.lax.min, (window, window), (1, 1), "SAME"
    )
    # A tied candidate survives only if no same-score maximum with a smaller
    # index sits in its window AND that smaller-index max has the same score
    # (a strictly-greater neighbour already failed is_max).
    keep = is_max & (idx <= pooled_idx)
    return jnp.where(keep, scores, 0.0)


def top_k_grid(
    scores: jnp.ndarray,
    k: int,
    grid: int = 8,
    per_cell_factor: int = 2,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Spatially-balanced top-k corner selection.

    Replaces the reference's grid / ANMS keypoint filters
    (visual_slam/utils/keypoints.py:14-51, feature/feature.py:225-328): the
    image is split into ``grid x grid`` cells, each cell keeps its
    ``per_cell_factor * ceil(k / grid^2)`` best corners, and the global top-k
    is taken from those survivors — bounded per-cell density with exact
    fixed shapes throughout.

    Returns (yx (k, 2) int32, score (k,) float32, valid (k,) bool).
    """
    H, W = scores.shape
    g = grid
    cap = -(-k // (g * g)) * per_cell_factor  # per-cell candidate quota
    ph = -(-H // g) * g - H
    pw = -(-W // g) * g - W
    s = jnp.pad(scores, ((0, ph), (0, pw)))
    Hp, Wp = H + ph, W + pw
    ch, cw = Hp // g, Wp // g
    # (g, g, ch*cw) cells
    cells = s.reshape(g, ch, g, cw).transpose(0, 2, 1, 3).reshape(g * g, ch * cw)
    cell_scores, cell_idx = jax.lax.top_k(cells, cap)  # (g*g, cap)
    # Recover absolute coordinates.
    gy = jnp.arange(g * g, dtype=jnp.int32) // g
    gx = jnp.arange(g * g, dtype=jnp.int32) % g
    local_y = cell_idx // cw
    local_x = cell_idx % cw
    abs_y = gy[:, None] * ch + local_y
    abs_x = gx[:, None] * cw + local_x
    flat_scores = cell_scores.reshape(-1)
    flat_y = abs_y.reshape(-1)
    flat_x = abs_x.reshape(-1)
    top_scores, top_i = jax.lax.top_k(flat_scores, k)
    yx = jnp.stack([flat_y[top_i], flat_x[top_i]], axis=-1)
    valid = top_scores > 0.0
    return yx, top_scores, valid


def subpixel_offsets(scores: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """Subpixel corner localization: separable 1D quadratic fit on the score
    surface around each selected pixel. Returns (k, 2) float (dy, dx) in
    [-0.5, 0.5]. (Beyond the reference — cv2.FAST has integer corners; this
    trims the ~0.3px quantization floor off every downstream estimate.)"""
    p = jnp.pad(scores, 1)
    y = yx[:, 0] + 1
    x = yx[:, 1] + 1

    def fit(sm, s0, sp):
        denom = sm - 2.0 * s0 + sp
        off = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (sm - sp) / denom, 0.0)
        return jnp.clip(off, -0.5, 0.5)

    s0 = p[y, x]
    dy = fit(p[y - 1, x], s0, p[y + 1, x])
    dx = fit(p[y, x - 1], s0, p[y, x + 1])
    return jnp.stack([dy, dx], axis=-1)


def detect_fast(
    img: jnp.ndarray,
    k: int,
    threshold: float = 20.0,
    grid: int = 8,
    nms_window: int = 3,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """FAST detection pipeline: score -> NMS -> balanced top-k.

    Returns (yx (k, 2) int32, response (k,), valid (k,))."""
    s = fast_scores(img, threshold)
    s = nms(s, nms_window)
    return top_k_grid(s, k, grid=grid)
