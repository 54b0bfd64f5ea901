"""GradHist: an on-device float descriptor (SIFT-class), pure JAX.

The reference's float-descriptor family delegates to cv2.SIFT (C++ host,
visual_slam/feature/feature.py:53-83); this is the on-device equivalent:
a 4x4-cell x 8-orientation-bin gradient-histogram descriptor (128-d float,
L2-matched) computed entirely on device with the same machinery style as
rBRIEF:

  * patch gradients by central differences (batched elementwise),
  * gradient orientations soft-binned into 8 bins with cosine lobes
    (cos^3 clipped at 0 — a smooth stand-in for SIFT's linear bin
    interpolation; all 8 bins from one cos/sin pair per pixel),
  * spatial pooling into the 4x4 cell grid as ONE matmul against 30
    PRE-ROTATED Gaussian-windowed cell-weight matrices (the rBRIEF
    steering-quantization trick: rotation handled by baked positional
    weights + subtracting the keypoint angle from gradient orientations,
    so there is no per-keypoint gather anywhere),
  * SIFT's normalize -> clip 0.2 -> renormalize.

Descriptors are stored bitcast into the uint32 Features.desc block (the
same convention as the cv2 SIFT fallback) so the Features pytree shape
stays uniform; the L2 matchers re-cast.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import fast as fast_ops
from . import orb as orb_ops
from . import pyramid as pyr_ops
from .detector import Features, level_quotas

N_CELLS = 4  # 4x4 spatial grid
N_OBINS = 8  # orientation bins
N_ROT = 30  # rotation quantization (matches rBRIEF steering)
DESC_DIM = N_CELLS * N_CELLS * N_OBINS  # 128
_P = 32  # patch side


def _make_cell_weights() -> np.ndarray:
    """(N_ROT, 1024, 16) Gaussian-windowed bilinear cell weights, one per
    rotation bin: pixel (y, x) of the patch contributes to the 4x4 cell grid
    at its position rotated by -theta_b about the patch center."""
    c = (_P - 1) / 2.0
    half = 31 / 2.0  # active patch half-width (pixels beyond 31 get ~0)
    cell_w = 31 / N_CELLS
    sigma = 31 / 2.0
    ys, xs = np.meshgrid(np.arange(_P), np.arange(_P), indexing="ij")
    ys = (ys - c).reshape(-1)
    xs = (xs - c).reshape(-1)
    out = np.zeros((N_ROT, _P * _P, N_CELLS * N_CELLS), np.float32)
    for b in range(N_ROT):
        th = 2.0 * np.pi * b / N_ROT
        co, si = np.cos(-th), np.sin(-th)
        ry = si * xs + co * ys
        rx = co * xs - si * ys
        w_g = np.exp(-(rx**2 + ry**2) / (2 * sigma**2))
        w_g *= (np.abs(rx) <= half) & (np.abs(ry) <= half)
        # continuous cell coordinates in [0, 4)
        cy = (ry + half) / cell_w
        cx = (rx + half) / cell_w
        y0 = np.clip(np.floor(cy - 0.5), 0, N_CELLS - 1).astype(int)
        x0 = np.clip(np.floor(cx - 0.5), 0, N_CELLS - 1).astype(int)
        fy = np.clip(cy - 0.5 - y0, 0.0, 1.0)
        fx = np.clip(cx - 0.5 - x0, 0.0, 1.0)
        y1 = np.minimum(y0 + 1, N_CELLS - 1)
        x1 = np.minimum(x0 + 1, N_CELLS - 1)
        idx = np.arange(_P * _P)
        out[b, idx, y0 * N_CELLS + x0] += w_g * (1 - fy) * (1 - fx)
        out[b, idx, y0 * N_CELLS + x1] += w_g * (1 - fy) * fx
        out[b, idx, y1 * N_CELLS + x0] += w_g * fy * (1 - fx)
        out[b, idx, y1 * N_CELLS + x1] += w_g * fy * fx
    return out


_CELL_W_NP = _make_cell_weights()
# Flattened for the single-matmul pooling: (1024, N_ROT * 16)
_CELL_W_FLAT = jnp.asarray(
    _CELL_W_NP.transpose(1, 0, 2).reshape(_P * _P, N_ROT * N_CELLS * N_CELLS)
)
_OBIN_ANGLES = jnp.asarray(2.0 * np.pi * np.arange(N_OBINS) / N_OBINS, jnp.float32)


def gradhist_descriptors(patches: jnp.ndarray, angles: jnp.ndarray) -> jnp.ndarray:
    """(K, 32, 32) raw patches + (K,) keypoint angles -> (K, 128) float32
    L2-normalized descriptors."""
    K = patches.shape[0]
    p = patches
    gx = jnp.zeros_like(p).at[:, :, 1:-1].set((p[:, :, 2:] - p[:, :, :-2]) * 0.5)
    gy = jnp.zeros_like(p).at[:, 1:-1, :].set((p[:, 2:, :] - p[:, :-2, :]) * 0.5)
    mag = jnp.sqrt(gx * gx + gy * gy).reshape(K, -1)  # (K, 1024)
    gang = jnp.arctan2(gy, gx).reshape(K, -1) - angles[:, None]
    # Soft orientation binning: clipped cos^3 lobes (width ~ +-90 deg,
    # dominated by the two adjacent bins — SIFT's linear interpolation
    # smoothed). All bins from one cos/sin pair.
    ca, sa = jnp.cos(gang), jnp.sin(gang)
    lobes = jnp.maximum(
        ca[..., None] * jnp.cos(_OBIN_ANGLES) + sa[..., None] * jnp.sin(_OBIN_ANGLES),
        0.0,
    ) ** 3  # (K, 1024, 8)
    contrib = mag[..., None] * lobes  # (K, 1024, 8)
    # Spatial pooling for ALL rotation bins at once, then one-hot select the
    # keypoint's bin (no gathers): (K, 8, 1024) @ (1024, 30*16).
    pooled = jax.lax.dot_general(
        contrib.transpose(0, 2, 1), _CELL_W_FLAT,
        dimension_numbers=(((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    ).reshape(K, N_OBINS, N_ROT, N_CELLS * N_CELLS)
    two_pi = 2.0 * jnp.pi
    bins = jnp.floor(jnp.mod(angles, two_pi) / two_pi * N_ROT).astype(jnp.int32) % N_ROT
    onehot = jax.nn.one_hot(bins, N_ROT, dtype=pooled.dtype)  # (K, 30)
    desc = jnp.einsum("kobc,kb->kco", pooled, onehot)  # (K, 16, 8)
    desc = desc.reshape(K, DESC_DIM)
    # SIFT normalization: L2 -> clip 0.2 -> L2.
    norm = jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-9)
    desc = jnp.minimum(desc / norm, 0.2)
    norm = jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-9)
    return desc / norm


@partial(
    jax.jit,
    static_argnames=("num_features", "n_levels", "scale", "grid", "edge_margin", "score"),
)
def detect_and_describe_gradhist(
    img: jnp.ndarray,
    num_features: int = 1000,
    threshold: float = 20.0,
    n_levels: int = 4,
    scale: float = 1.2,
    grid: int = 8,
    edge_margin: int = 16,
    score: str = "fast",
) -> Features:
    """FAST (or Shi-Tomasi) keypoints + GradHist float descriptors, one
    jitted program. Descriptors are bitcast into the uint32 desc block
    ((K, 128) words), same convention as the cv2 SIFT fallback."""
    H0, W0 = img.shape
    levels = pyr_ops.build_pyramid(img, n_levels, scale)
    quotas = level_quotas(num_features, n_levels, scale)
    outs = []
    for l, (lvl, k_l) in enumerate(zip(levels, quotas)):
        Hl, Wl = lvl.shape
        if score == "shi_tomasi":
            scores = fast_ops.shi_tomasi_scores(lvl, quality_level=threshold)
        else:
            scores = fast_ops.fast_scores(lvl, threshold)
        scores = fast_ops.nms(scores)
        ys = jax.lax.broadcasted_iota(jnp.int32, (Hl, Wl), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (Hl, Wl), 1)
        interior = (
            (ys >= edge_margin) & (ys < Hl - edge_margin)
            & (xs >= edge_margin) & (xs < Wl - edge_margin)
        )
        scores = jnp.where(interior, scores, 0.0)
        yx, resp, valid = fast_ops.top_k_grid(scores, k_l, grid=grid)
        sub = fast_ops.subpixel_offsets(scores, yx)
        blurred = pyr_ops.gaussian_blur(lvl, sigma=2.0, radius=3)
        ang = orb_ops.orientations(orb_ops.extract_patches(lvl, yx))
        pblur = orb_ops.extract_patches(blurred, yx)
        # pad 31x31 -> 32x32 (gradients at the pad edge are zeroed anyway)
        pblur = jnp.pad(pblur, ((0, 0), (0, 1), (0, 1)), mode="edge")
        desc_f = gradhist_descriptors(pblur, ang)
        desc_u32 = jax.lax.bitcast_convert_type(desc_f, jnp.uint32)
        sx = W0 / Wl
        sy = H0 / Hl
        xy_full = jnp.stack(
            [
                (yx[:, 1].astype(jnp.float32) + sub[:, 1]) * sx,
                (yx[:, 0].astype(jnp.float32) + sub[:, 0]) * sy,
            ],
            axis=-1,
        )
        outs.append(
            Features(
                xy=xy_full,
                response=resp,
                angle=ang,
                octave=jnp.full((k_l,), l, jnp.int32),
                size=jnp.full((k_l,), 31.0 * (sx + sy) * 0.5, jnp.float32),
                desc=desc_u32,
                valid=valid,
            )
        )
    return Features(
        *[jnp.concatenate([getattr(o, f) for o in outs], axis=0) for f in Features._fields]
    )
