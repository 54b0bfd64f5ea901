"""On-device SIFT: DoG scale-space detector + GradHist descriptor, pure JAX.

The reference ships cv2.SIFT as a first-class float-feature family
(visual_slam/feature/feature.py:53-83 — host C++, dynamic keypoint counts).
This is the device-native equivalent, designed for fixed-shape matmuls and
fused elementwise passes rather than translated:

  * Gaussian octaves by incremental separable blurs (shifted-slice adds XLA
    fuses — no conv op, no host round trips),
  * difference-of-Gaussians planes, 26-neighbour extrema as ONE 3x3x3
    ``reduce_window`` max/min over the plane-stacked DoG volume,
  * dense contrast + Hessian edge rejection BEFORE selection (elementwise;
    rejected pixels never crowd the top-k),
  * spatially-balanced fixed-K selection per octave (``fast.top_k_grid`` —
    static shapes end to end, padded with a validity mask),
  * closed-form 3D quadratic subpixel/subscale refinement from the gathered
    3x3x3 neighbourhood cube (cofactor 3x3 inverse — no ``linalg`` lowering,
    see backend/ba.py's ``_inv3x3`` lesson),
  * 36-bin gradient-orientation histogram as a one-hot einsum with per-plane
    Gaussian windows (one matmul; circular smoothing + parabolic peak),
  * the GradHist 4x4x8 float descriptor (ops/floatdesc.py) computed at the
    keypoint's own scale plane, bitcast into the uint32 ``Features.desc``
    block (L2 matchers re-cast — same convention as the cv2 fallback).

Everything below is fixed-shape and jit-compiled as one program per image
size; the per-frame cost is independent of how many features fire.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import fast as fast_ops
from .detector import Features, level_quotas
from .floatdesc import DESC_DIM, gradhist_descriptors

_SIGMA0 = 1.6  # base scale of each octave (Lowe 2004)
_SIGMA_IN = 0.5  # assumed blur of the raw input image
_N_HBINS = 36  # orientation histogram bins (10 deg each)
_P = 32  # descriptor/orientation patch side (matches floatdesc)


def _blur(img: jnp.ndarray, sigma: float) -> jnp.ndarray:
    """Separable Gaussian blur with radius matched to sigma (static)."""
    from . import pyramid as pyr_ops

    radius = max(int(np.ceil(3.0 * sigma)), 1)
    return pyr_ops.gaussian_blur(img, sigma=sigma, radius=radius)


def _octave_stack(base: jnp.ndarray, n_scales: int) -> jnp.ndarray:
    """(S+3, H, W) Gaussian images at sigma0 * 2^(i/S) from a base image
    already at sigma0, via incremental blurs (each adds in quadrature)."""
    k = 2.0 ** (1.0 / n_scales)
    imgs = [base]
    for i in range(1, n_scales + 3):
        sig_prev = _SIGMA0 * k ** (i - 1)
        sig_inc = sig_prev * float(np.sqrt(k * k - 1.0))
        imgs.append(_blur(imgs[-1], sig_inc))
    return jnp.stack(imgs)


def _inv3x3_cofactor(A: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched closed-form 3x3 inverse (adjugate / det) + the determinant.
    Same rationale as backend/ba.py:_inv3x3 — ``jnp.linalg.inv`` lowers to a
    batched LU with pivoting."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = c * h - b * i
    co_c = b * f - c * e
    co_d = f * g - d * i
    co_e = a * i - c * g
    co_f = c * d - a * f
    co_g = d * h - e * g
    co_h = b * g - a * h
    co_i = a * e - b * d
    det = a * co_a + b * co_d + c * co_g
    adj = jnp.stack(
        [
            jnp.stack([co_a, co_b, co_c], -1),
            jnp.stack([co_d, co_e, co_f], -1),
            jnp.stack([co_g, co_h, co_i], -1),
        ],
        -2,
    )
    safe = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    return adj / safe[..., None, None], det


def _gather_cube(dog: jnp.ndarray, plane: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """(K, 3, 3, 3) DoG neighbourhoods around (plane, y, x) keypoints.
    One flat gather — K is fixed, indices are clamped in-range upstream."""
    P, H, W = dog.shape
    dp, dy, dx = jnp.meshgrid(
        jnp.arange(-1, 2), jnp.arange(-1, 2), jnp.arange(-1, 2), indexing="ij"
    )
    off = (dp * (H * W) + dy * W + dx).reshape(-1)  # (27,)
    centre = plane * (H * W) + yx[:, 0] * W + yx[:, 1]  # (K,)
    flat = dog.reshape(-1)
    idx = jnp.clip(centre[:, None] + off[None, :], 0, P * H * W - 1)
    return flat[idx].reshape(-1, 3, 3, 3)


def _extract_patches_stack(
    stack: jnp.ndarray, plane: jnp.ndarray, yx: jnp.ndarray
) -> jnp.ndarray:
    """(K, 32, 32) patches from the Gaussian stack at each keypoint's own
    scale plane (vmapped dynamic_slice on the edge-padded volume)."""
    r = _P // 2
    p = jnp.pad(stack, ((0, 0), (r, r), (r, r)), mode="edge")

    def one(pl, c):
        return jax.lax.dynamic_slice(p, (pl, c[0], c[1]), (1, _P, _P))[0]

    return jax.vmap(one)(plane, yx)


def _orientation_weights(n_scales: int) -> np.ndarray:
    """(S, 1024) per-plane Gaussian windows for the orientation histogram
    (sigma = 1.5 * scale sigma, Lowe) — selected per keypoint by plane
    one-hot, so no per-keypoint gather."""
    c = (_P - 1) / 2.0
    ys, xs = np.meshgrid(np.arange(_P), np.arange(_P), indexing="ij")
    r2 = ((ys - c) ** 2 + (xs - c) ** 2).reshape(-1)
    out = np.zeros((n_scales, _P * _P), np.float32)
    for p in range(n_scales):
        sig = 1.5 * _SIGMA0 * 2.0 ** ((p + 1) / n_scales)
        out[p] = np.exp(-r2 / (2.0 * sig * sig))
    return out


def _orientations_hist(
    patches: jnp.ndarray, plane: jnp.ndarray, w_plane: jnp.ndarray
) -> jnp.ndarray:
    """Dominant gradient orientation per patch: weighted 36-bin histogram
    (one-hot einsum), circular [1,4,6,4,1]/16 smoothing, parabolic peak."""
    K = patches.shape[0]
    p = patches
    gx = jnp.zeros_like(p).at[:, :, 1:-1].set((p[:, :, 2:] - p[:, :, :-2]) * 0.5)
    gy = jnp.zeros_like(p).at[:, 1:-1, :].set((p[:, 2:, :] - p[:, :-2, :]) * 0.5)
    mag = jnp.sqrt(gx * gx + gy * gy).reshape(K, -1)  # (K, 1024)
    ang = jnp.arctan2(gy, gx).reshape(K, -1)  # (K, 1024) in [-pi, pi)
    two_pi = 2.0 * jnp.pi
    bins = jnp.floor(jnp.mod(ang, two_pi) / two_pi * _N_HBINS).astype(jnp.int32)
    bins = jnp.clip(bins, 0, _N_HBINS - 1)
    onehot = jax.nn.one_hot(bins, _N_HBINS, dtype=mag.dtype)  # (K, 1024, 36)
    w = w_plane[plane]  # (K, 1024) window for each keypoint's scale
    hist = jnp.einsum("kp,kpb->kb", mag * w, onehot)  # (K, 36)
    # Circular smoothing with the binomial [1,4,6,4,1]/16 kernel.
    hr = jnp.concatenate([hist[:, -2:], hist, hist[:, :2]], axis=1)
    hist = (
        hr[:, :-4] + 4.0 * hr[:, 1:-3] + 6.0 * hr[:, 2:-2]
        + 4.0 * hr[:, 3:-1] + hr[:, 4:]
    ) / 16.0
    peak = jnp.argmax(hist, axis=1)
    # Parabolic refinement around the peak bin.
    left = hist[jnp.arange(K), (peak - 1) % _N_HBINS]
    mid = hist[jnp.arange(K), peak]
    right = hist[jnp.arange(K), (peak + 1) % _N_HBINS]
    denom = left - 2.0 * mid + right
    frac = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (left - right) / denom, 0.0)
    frac = jnp.clip(frac, -0.5, 0.5)
    return (peak.astype(jnp.float32) + 0.5 + frac) * (two_pi / _N_HBINS)


@partial(
    jax.jit,
    static_argnames=(
        "num_features", "n_octaves", "n_scales", "grid", "edge_margin"
    ),
)
def detect_and_describe_sift(
    img: jnp.ndarray,
    num_features: int = 1000,
    n_octaves: int = 4,
    n_scales: int = 3,
    contrast_threshold: float = 0.04,
    edge_threshold: float = 10.0,
    grid: int = 8,
    edge_margin: int = 16,
) -> Features:
    """Full on-device SIFT detect+describe as one jitted program.

    ``img`` is (H, W) grayscale in [0, 255]; returns the standard padded
    ``Features`` block with float descriptors bitcast to uint32
    (reference counterpart: visual_slam/feature/feature.py:53-83)."""
    H0, W0 = img.shape
    base = img.astype(jnp.float32) / 255.0
    sig_boot = float(np.sqrt(max(_SIGMA0**2 - _SIGMA_IN**2, 0.01)))
    base = _blur(base, sig_boot)
    # Octave count limited by resolution (static, from the traced shape).
    n_oct = min(n_octaves, int(np.floor(np.log2(min(H0, W0) / 48.0))) + 1)
    n_oct = max(n_oct, 1)
    quotas = level_quotas(num_features, n_oct, 2.0)
    w_plane = jnp.asarray(_orientation_weights(n_scales))
    # cv2-equivalent contrast gate (their images are [0,255]; thresh 0.04
    # on [0,1] images with the standard /n_scales normalization).
    floor_d = 0.5 * contrast_threshold / n_scales
    r_edge = edge_threshold
    outs = []
    for o in range(n_oct):
        gauss = _octave_stack(base, n_scales)  # (S+3, Hl, Wl)
        dog = gauss[1:] - gauss[:-1]  # (S+2, Hl, Wl)
        Hl, Wl = dog.shape[1:]
        mx = jax.lax.reduce_window(
            dog, -jnp.inf, jax.lax.max, (3, 3, 3), (1, 1, 1), "SAME"
        )
        mn = jax.lax.reduce_window(
            dog, jnp.inf, jax.lax.min, (3, 3, 3), (1, 1, 1), "SAME"
        )
        is_ext = ((dog >= mx) & (dog > floor_d)) | ((dog <= mn) & (dog < -floor_d))
        # Dense Hessian edge rejection (per plane, central differences).
        dpad = jnp.pad(dog, ((0, 0), (1, 1), (1, 1)), mode="edge")
        dxx = dpad[:, 1:-1, 2:] - 2.0 * dog + dpad[:, 1:-1, :-2]
        dyy = dpad[:, 2:, 1:-1] - 2.0 * dog + dpad[:, :-2, 1:-1]
        dxy = 0.25 * (
            dpad[:, 2:, 2:] - dpad[:, 2:, :-2] - dpad[:, :-2, 2:] + dpad[:, :-2, :-2]
        )
        tr = dxx + dyy
        det2 = dxx * dyy - dxy * dxy
        not_edge = (det2 > 0.0) & (
            tr * tr * r_edge < (r_edge + 1.0) ** 2 * det2
        )
        cand = is_ext & not_edge  # (S+2, Hl, Wl)
        # Only interior planes 1..S are true scale-space extrema.
        score_planes = jnp.where(cand[1 : n_scales + 1], jnp.abs(dog[1 : n_scales + 1]), 0.0)
        score = jnp.max(score_planes, axis=0)  # (Hl, Wl)
        plane_rel = jnp.argmax(score_planes, axis=0).astype(jnp.int32)  # 0..S-1
        ys = jax.lax.broadcasted_iota(jnp.int32, (Hl, Wl), 0)
        xs = jax.lax.broadcasted_iota(jnp.int32, (Hl, Wl), 1)
        m = edge_margin if min(Hl, Wl) > 2 * edge_margin + 8 else 4
        interior = (ys >= m) & (ys < Hl - m) & (xs >= m) & (xs < Wl - m)
        score = jnp.where(interior, score, 0.0)
        k_o = quotas[o]
        yx, resp, valid = fast_ops.top_k_grid(score, k_o, grid=grid)
        valid = valid & (resp > 0.0)
        plane_k = plane_rel[yx[:, 0], yx[:, 1]] + 1  # 1..S in the DoG stack
        # --- 3D quadratic refinement from the 27-neighbourhood cube ---
        cube = _gather_cube(dog, plane_k, yx)  # (K, 3, 3, 3) [p, y, x]
        c = cube
        gx_ = 0.5 * (c[:, 1, 1, 2] - c[:, 1, 1, 0])
        gy_ = 0.5 * (c[:, 1, 2, 1] - c[:, 1, 0, 1])
        gs_ = 0.5 * (c[:, 2, 1, 1] - c[:, 0, 1, 1])
        hxx = c[:, 1, 1, 2] - 2.0 * c[:, 1, 1, 1] + c[:, 1, 1, 0]
        hyy = c[:, 1, 2, 1] - 2.0 * c[:, 1, 1, 1] + c[:, 1, 0, 1]
        hss = c[:, 2, 1, 1] - 2.0 * c[:, 1, 1, 1] + c[:, 0, 1, 1]
        hxy = 0.25 * (c[:, 1, 2, 2] - c[:, 1, 2, 0] - c[:, 1, 0, 2] + c[:, 1, 0, 0])
        hxs = 0.25 * (c[:, 2, 1, 2] - c[:, 2, 1, 0] - c[:, 0, 1, 2] + c[:, 0, 1, 0])
        hys = 0.25 * (c[:, 2, 2, 1] - c[:, 2, 0, 1] - c[:, 0, 2, 1] + c[:, 0, 0, 1])
        Hm = jnp.stack(
            [
                jnp.stack([hxx, hxy, hxs], -1),
                jnp.stack([hxy, hyy, hys], -1),
                jnp.stack([hxs, hys, hss], -1),
            ],
            -2,
        )  # (K, 3, 3) over (x, y, s)
        g = jnp.stack([gx_, gy_, gs_], -1)  # (K, 3)
        Hinv, det = _inv3x3_cofactor(Hm)
        off = -jnp.einsum("kij,kj->ki", Hinv, g)
        off = jnp.where(jnp.abs(det[:, None]) > 1e-12, off, 0.0)
        off = jnp.clip(off, -0.6, 0.6)  # single-step refinement, clamped
        val = c[:, 1, 1, 1] + 0.5 * jnp.einsum("ki,ki->k", g, off)
        valid = valid & (jnp.abs(val) * n_scales >= contrast_threshold)
        # --- orientation + descriptor at the keypoint's own scale plane ---
        patches = _extract_patches_stack(gauss, plane_k, yx)
        ang = _orientations_hist(patches, plane_k - 1, w_plane)
        desc_f = gradhist_descriptors(patches, ang)
        desc_u32 = jax.lax.bitcast_convert_type(desc_f, jnp.uint32)
        scale_up = float(2**o)
        sig_kp = _SIGMA0 * 2.0 ** (
            (plane_k.astype(jnp.float32) + off[:, 2]) / n_scales
        )
        xy_full = jnp.stack(
            [
                (yx[:, 1].astype(jnp.float32) + off[:, 0]) * scale_up,
                (yx[:, 0].astype(jnp.float32) + off[:, 1]) * scale_up,
            ],
            axis=-1,
        )
        outs.append(
            Features(
                xy=xy_full,
                response=jnp.abs(val),
                angle=ang,
                octave=jnp.full((k_o,), o, jnp.int32),
                size=sig_kp * scale_up * 2.0,
                desc=desc_u32,
                valid=valid,
            )
        )
        if o + 1 < n_oct:
            # Next octave base: the sigma=2*sigma0 image, decimated 2x.
            base = gauss[n_scales][::2, ::2]
    return Features(
        *[
            jnp.concatenate([getattr(o, f) for o in outs], axis=0)
            for f in Features._fields
        ]
    )
