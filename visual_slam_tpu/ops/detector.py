"""Fused multi-scale ORB-style detector: pyramid -> FAST -> orientation ->
rBRIEF, one jitted program per input resolution.

Device replacement for the reference's detector zoo
(visual_slam/feature/feature.py: ORBFeature2D, FastBriefFeature2D,
FastOrbAnmsFeature2D) — detection, spatial balancing (grid top-k, replacing
ANMS/grid filters in utils/keypoints.py), orientation, and descriptors run
on-device with static shapes: the output always has exactly ``num_features``
slots with a validity mask.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import fast as fast_ops
from . import orb as orb_ops
from . import pyramid as pyr_ops


class Features(NamedTuple):
    """Fixed-capacity per-frame feature block (the SoA analogue of the
    reference's cv2.KeyPoint list + descriptor matrix)."""

    xy: jnp.ndarray  # (K, 2) float32, full-resolution (x, y) pixels
    response: jnp.ndarray  # (K,) float32
    angle: jnp.ndarray  # (K,) float32 radians
    octave: jnp.ndarray  # (K,) int32 pyramid level
    size: jnp.ndarray  # (K,) float32 patch diameter at full resolution
    desc: jnp.ndarray  # (K, 8) uint32 packed 256-bit descriptors
    valid: jnp.ndarray  # (K,) bool

    @property
    def num_slots(self) -> int:
        return self.xy.shape[-2]


def level_quotas(num_features: int, n_levels: int, scale: float) -> list[int]:
    """Distribute the feature budget across pyramid levels with the OpenCV
    ORB policy (geometric decay by 1/scale per level)."""
    ws = [(1.0 / scale) ** l for l in range(n_levels)]
    total = sum(ws)
    ks = [max(int(round(num_features * w / total)), 1) for w in ws]
    ks[0] += num_features - sum(ks)  # absorb rounding drift at level 0
    return ks


@partial(
    jax.jit,
    static_argnames=("num_features", "n_levels", "scale", "grid", "edge_margin", "score"),
)
def detect_and_describe_with_sampling(
    img: jnp.ndarray,
    sampling: jnp.ndarray,
    num_features: int = 1000,
    threshold: float = 20.0,
    n_levels: int = 4,
    scale: float = 1.2,
    grid: int = 8,
    edge_margin: int = 16,
    score: str = "fast",
) -> Features:
    """Full ORB front-end on one grayscale image (H, W) float32 in [0, 255].

    Replaces FeatureTracker.detectAndCompute -> cv2 detector C++ calls
    (reference feature/tracker.py:92-104).

    ``sampling`` is the rotated-BRIEF weight matrix (orb.sampling_matrix()).
    It MUST flow through every enclosing jit as a traced argument — baked as
    an HLO literal (59 MB) it blows up compile time; use this explicit-arg
    variant inside jit/vmap, and the ``detect_and_describe`` wrapper from
    host code.
    """
    H0, W0 = img.shape
    # Accept uint8 camera frames directly: the cast runs on device, so the
    # host->device transfer is 1/4 the bytes of pre-converted f32.
    img = img.astype(jnp.float32)
    levels = pyr_ops.build_pyramid(img, n_levels, scale)
    quotas = level_quotas(num_features, n_levels, scale)

    outs = []
    for l, (lvl, k_l) in enumerate(zip(levels, quotas)):
        Hl, Wl = lvl.shape
        if score == "shi_tomasi":
            # ``threshold`` is the cv2-style relative quality level here.
            scores = fast_ops.shi_tomasi_scores(lvl, quality_level=threshold)
        else:
            scores = fast_ops.fast_scores(lvl, threshold)
        scores = fast_ops.nms(scores)
        # Patch-safety margin: descriptors need a full 31x31 window.
        ys = jax.lax.broadcasted_iota(jnp.int32, (Hl, Wl), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (Hl, Wl), 1)
        interior = (
            (ys >= edge_margin)
            & (ys < Hl - edge_margin)
            & (xs >= edge_margin)
            & (xs < Wl - edge_margin)
        )
        scores = jnp.where(interior, scores, 0.0)
        yx, resp, valid = fast_ops.top_k_grid(scores, k_l, grid=grid)
        sub = fast_ops.subpixel_offsets(scores, yx)

        blurred = pyr_ops.gaussian_blur(lvl, sigma=2.0, radius=3)
        with jax.named_scope("orb_patches"):
            patches_raw = orb_ops.extract_patches(lvl, yx)
            patches_blur = orb_ops.extract_patches(blurred, yx)
            ang = orb_ops.orientations(patches_raw)

        sx = W0 / Wl
        sy = H0 / Hl
        xy_full = jnp.stack(
            [
                (yx[:, 1].astype(jnp.float32) + sub[:, 1]) * sx,
                (yx[:, 0].astype(jnp.float32) + sub[:, 0]) * sy,
            ],
            axis=-1,
        )
        if sampling.ndim == 3:
            # Grouped-matmul descriptor path (orb.descriptors_sorted), then
            # UNSORT the descriptors back to detection order — a (K, 8)
            # gather, trivial next to the 30x matmul saved. Keeping the
            # original order matters beyond cosmetics: slot index encodes
            # detection score (top-k emits strongest first), so matcher
            # argmin TIES resolve toward stronger features — reordering
            # measurably degraded small-world ATE (0.017 -> 0.09-0.18).
            # Same math as the dense path; individual near-tie BRIEF bits
            # may still flip (grouped matmul accumulates in a different
            # order).
            desc_s, order = orb_ops.descriptors_sorted(patches_blur, ang, sampling)
            desc = desc_s[jnp.argsort(order)]
        else:
            desc = orb_ops.descriptors(patches_blur, ang, sampling)
        outs.append(
            Features(
                xy=xy_full,
                response=resp,
                angle=ang,
                octave=jnp.full((k_l,), l, jnp.int32),
                size=jnp.full((k_l,), orb_ops.PATCH * (sx + sy) * 0.5, jnp.float32),
                desc=desc,
                valid=valid,
            )
        )

    return Features(*[jnp.concatenate([getattr(o, f) for o in outs], axis=0) for f in Features._fields])


def detect_and_describe(
    img: jnp.ndarray,
    num_features: int = 1000,
    threshold: float = 20.0,
    n_levels: int = 4,
    scale: float = 1.2,
    grid: int = 8,
    edge_margin: int = 16,
    score: str = "fast",
) -> Features:
    """Host-callable wrapper: injects the device-resident sampling matrix as
    a traced argument. From inside jit/vmap use
    ``detect_and_describe_with_sampling`` and thread the matrix explicitly."""
    return detect_and_describe_with_sampling(
        img,
        orb_ops.active_sampling(),
        num_features=num_features,
        threshold=threshold,
        n_levels=n_levels,
        scale=scale,
        grid=grid,
        edge_margin=edge_margin,
        score=score,
    )
