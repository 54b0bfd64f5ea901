"""Descriptor matching + match filter chain, pure JAX with matmul-routed
Hamming distances.

Device replacement for cv2.BFMatcher(NORM_HAMMING)/knnMatch and the
reference's filter stack (visual_slam/feature/matcher.py:12-40,
visual_slam/utils/matching.py:10-460: Lowe ratio, cross-check, orientation
histogram, RANSAC fundamental, max-distance, unique-train).

Key trick: Hamming distance between 256-bit descriptors a, b equals
``popcnt(a) + popcnt(b) - 2 * dot(bits(a), bits(b))`` — so the full KxK
distance matrix is ONE bf16 matmul (bit counts <= 256 are exact in bf16 with
f32 accumulation, so the result is exact at any matmul precision) instead of a
scalar XOR/popcount loop.

All matchers return a fixed-shape match table aligned to the query side:
``train_idx (K,) int32``, ``distance (K,) float32``, ``valid (K,) bool``.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .orb import unpack_bits

BIG = 1e9


def hamming_distance_matrix(
    desc1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid1: jnp.ndarray,
    valid2: jnp.ndarray,
) -> jnp.ndarray:
    """(K1, 8) x (K2, 8) packed uint32 -> (K1, K2) float32 Hamming distances.
    Invalid rows/columns get BIG."""
    b1 = unpack_bits(desc1)  # (K1, 256) bf16
    b2 = unpack_bits(desc2)
    pop1 = jnp.sum(b1.astype(jnp.float32), axis=-1)
    pop2 = jnp.sum(b2.astype(jnp.float32), axis=-1)
    # The one big matmul: 0/1 bf16 operands with f32 accumulation are exact,
    # so it may run at the fastest precision.
    dots = jax.lax.dot_general(
        b1,
        b2,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )
    d = pop1[:, None] + pop2[None, :] - 2.0 * dots
    d = jnp.where(valid1[:, None] & valid2[None, :], d, BIG)
    return d


def l2_distance_matrix(
    desc1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid1: jnp.ndarray,
    valid2: jnp.ndarray,
) -> jnp.ndarray:
    """(K1, D) x (K2, D) float descriptors (stored bitcast in the uint32
    block — the float-family convention) -> (K1, K2) float32 L2 distances.
    Invalid rows/columns get BIG. One matmul, same as Hamming."""
    d1 = jax.lax.bitcast_convert_type(desc1, jnp.float32)
    d2 = jax.lax.bitcast_convert_type(desc2, jnp.float32)
    n1 = jnp.sum(d1 * d1, axis=-1)
    n2 = jnp.sum(d2 * d2, axis=-1)
    dots = jax.lax.dot_general(
        d1, d2,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    )
    d = jnp.sqrt(jnp.maximum(n1[:, None] + n2[None, :] - 2.0 * dots, 0.0))
    return jnp.where(valid1[:, None] & valid2[None, :], d, BIG)


def is_binary_desc(desc: jnp.ndarray) -> bool:
    """The descriptor WIDTH is the metric: binary families pack 256 bits
    into 8 uint32 words; float families bitcast 128 f32 into 128 words.
    Static (trace-time) — every matcher dispatches on it."""
    return int(desc.shape[-1]) == 8


def distance_matrix(desc1, desc2, valid1, valid2) -> jnp.ndarray:
    """Metric-dispatching distance matrix (see is_binary_desc)."""
    if is_binary_desc(desc1):
        return hamming_distance_matrix(desc1, desc2, valid1, valid2)
    return l2_distance_matrix(desc1, desc2, valid1, valid2)


def min2(dist: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(best, second, argmin) along the last axis — ``lax.top_k(-d, 2)``
    relowered as argmin + one masked re-min: three fused reduction passes
    instead of a sort, bit-identical including first-index tie-breaks."""
    ti = jnp.argmin(dist, axis=-1)
    best = jnp.take_along_axis(dist, ti[..., None], axis=-1)[..., 0]
    cols = jnp.arange(dist.shape[-1])
    second = jnp.min(
        jnp.where(cols == ti[..., None], jnp.inf, dist), axis=-1
    )
    return best, second, ti


def match_nn(
    dist: jnp.ndarray,
    ratio: float = 0.75,
    cross_check: bool = True,
    max_distance: float = 0.0,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Nearest-neighbour matching with Lowe ratio + optional cross-check.

    Mirrors BFMatcherHamming (reference matcher.py:12-40): crossCheck mode or
    knn(2) + ratio 0.75; plus the max-descriptor-distance filter
    (matching.py:280-303) when ``max_distance > 0``.

    Returns (train_idx (K1,), distance (K1,), valid (K1,)).
    """
    # Top-2 per query row.
    best, second, ti = min2(dist)
    ok = best < BIG * 0.5
    if ratio > 0:
        ok &= best < ratio * second
    if cross_check:
        rev = jnp.argmin(dist, axis=0)  # best query for each train
        ok &= rev[ti] == jnp.arange(dist.shape[0])
    if max_distance > 0:
        ok &= best <= max_distance
    return ti, best, ok


def unique_train(ti: jnp.ndarray, dist: jnp.ndarray, ok: jnp.ndarray, n_train: int) -> jnp.ndarray:
    """Keep only the lowest-distance match per train index (reference
    filter_matches_unique, matching.py:308-334). Returns updated ``ok``.

    Lowered as dense one-hot masked mins, not ``.at[ti].min`` scatters: the
    (K, n_train) masked reduce is a handful of fused passes with no
    data-dependent write order. Bit-exact with the scatter (min has no
    rounding)."""
    d = jnp.where(ok, dist, BIG)
    onehot = ti[:, None] == jnp.arange(n_train)[None, :]  # (K, n_train)
    best_per_train = jnp.min(jnp.where(onehot, d[:, None], BIG), axis=0)
    winner = d <= best_per_train[ti] + 1e-6
    # Tie-break duplicates deterministically by query index.
    qi = jnp.arange(ti.shape[0])
    q_val = jnp.where(winner & ok, qi, 1 << 30)
    best_qi = jnp.min(jnp.where(onehot, q_val[:, None], 1 << 30), axis=0)
    return ok & winner & (best_qi[ti] == qi)


def orientation_filter(
    angle1: jnp.ndarray,
    angle2: jnp.ndarray,
    ti: jnp.ndarray,
    ok: jnp.ndarray,
    n_bins: int = 30,
    keep_bins: int = 1,
) -> jnp.ndarray:
    """Rotation-consistency filter: histogram the per-match angle difference
    into ``n_bins`` and keep matches in the ``keep_bins`` dominant bin(s)
    (reference filter_matches_orientation, matching.py:145-186)."""
    da = angle1 - angle2[ti]
    two_pi = 2.0 * jnp.pi
    da = jnp.mod(da, two_pi)  # [0, 2pi)
    bins = jnp.clip((da / two_pi * n_bins).astype(jnp.int32), 0, n_bins - 1)
    # One-hot histogram: the (K, n_bins) sum is one fused pass, integer-exact.
    onehot = bins[:, None] == jnp.arange(n_bins)[None, :]
    hist = jnp.sum(
        jnp.where(ok[:, None] & onehot, 1, 0).astype(jnp.int32), axis=0
    )
    order = jnp.argsort(-hist)
    keep = jnp.zeros((n_bins,), bool).at[order[:keep_bins]].set(True)
    return ok & keep[bins]


def stereo_epipolar_filter(
    xy1: jnp.ndarray,
    xy2: jnp.ndarray,
    ti: jnp.ndarray,
    ok: jnp.ndarray,
    row_tolerance: float = 2.0,
    min_disparity: float = 0.0,
    max_disparity: float = 1e9,
) -> jnp.ndarray:
    """Rectified-stereo consistency: same row, positive bounded disparity
    (reference filter_matches_stereo, matching.py:192-228). xy1 = left,
    xy2 = right (indexed by ti)."""
    p2 = xy2[ti]
    dv = jnp.abs(xy1[:, 1] - p2[:, 1])
    disp = xy1[:, 0] - p2[:, 0]
    return ok & (dv <= row_tolerance) & (disp > min_disparity) & (disp < max_disparity)


def region_mask_filter(
    xy: jnp.ndarray,
    ok: jnp.ndarray,
    regions: jnp.ndarray,
    exclude: bool = True,
) -> jnp.ndarray:
    """Keep/drop matches whose QUERY keypoint falls in any of the given
    axis-aligned regions (reference filter_matches_mask, matching.py:233-275).

    regions: (R, 4) [x0, y0, x1, y1]; padded rows may be all-zero (ignored).
    """
    x, y = xy[:, 0], xy[:, 1]
    x0, y0, x1, y1 = regions[:, 0], regions[:, 1], regions[:, 2], regions[:, 3]
    nonempty = (x1 > x0) & (y1 > y0)
    inside = (
        (x[:, None] >= x0[None]) & (x[:, None] < x1[None])
        & (y[:, None] >= y0[None]) & (y[:, None] < y1[None])
        & nonempty[None]
    ).any(axis=1)
    return ok & (~inside if exclude else inside)


@partial(jax.jit, static_argnames=("ratio", "cross_check", "use_orientation", "n_bins", "keep_bins", "max_distance"))
def match_descriptors(
    desc1: jnp.ndarray,
    desc2: jnp.ndarray,
    valid1: jnp.ndarray,
    valid2: jnp.ndarray,
    angle1: jnp.ndarray | None = None,
    angle2: jnp.ndarray | None = None,
    ratio: float = 0.75,
    cross_check: bool = True,
    use_orientation: bool = False,
    n_bins: int = 30,
    keep_bins: int = 3,
    max_distance: float = 0.0,
) -> dict:
    """Distance matrix -> NN match -> unique-train -> optional orientation
    filter. The fused jitted matcher used by the tracker."""
    with jax.named_scope("match_descriptors"):
        dist = distance_matrix(desc1, desc2, valid1, valid2)
        ti, d, ok = match_nn(dist, ratio=ratio, cross_check=cross_check, max_distance=max_distance)
    ok = unique_train(ti, d, ok, desc2.shape[0])
    if use_orientation and angle1 is not None:
        ok = orientation_filter(angle1, angle2, ti, ok, n_bins=n_bins, keep_bins=keep_bins)
    return {"train_idx": ti, "distance": d, "valid": ok, "n_matches": jnp.sum(ok)}


@partial(jax.jit, static_argnames=("ratio", "cross_check", "use_orientation"))
def match_descriptors_batched(
    desc_q: jnp.ndarray,
    desc_c: jnp.ndarray,
    valid_q: jnp.ndarray,
    valid_c: jnp.ndarray,
    angle_q: jnp.ndarray,
    angle_c: jnp.ndarray,
    ratio: float = 0.75,
    cross_check: bool = True,
    use_orientation: bool = True,
) -> dict:
    """One query block vs C stacked candidate blocks in a SINGLE dispatch
    (loop place recognition: the query keyframe against every old keyframe).

    Uses lax.map rather than vmap so the per-candidate (K, K) distance matrix
    is never materialized C times at once: each candidate's Hamming matmul
    runs in turn inside one compiled program, bounding device memory at one
    matrix while keeping host round-trips at exactly one.

    Shapes: desc_c (C, K, B), valid_c (C, K), angle_c (C, K); returns stacked
    dict with train_idx/distance/valid (C, K) and n_matches (C,). Float-family
    descriptors (width 128, see is_binary_desc) take the L2 metric.
    """
    def one(cand):
        d, v, a = cand
        return match_descriptors(
            desc_q, d, valid_q, v, angle_q, a,
            ratio=ratio, cross_check=cross_check, use_orientation=use_orientation,
        )

    return jax.lax.map(one, (desc_c, valid_c, angle_c))
