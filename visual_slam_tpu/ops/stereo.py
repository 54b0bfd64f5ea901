"""Per-frame stereo / RGB-D depth measurement ops. Pure JAX, fixed shapes.

Device replacement for the reference's per-keyframe Python stereo loop
(reference triangulate_stereo_points, visual_slam/utils/motion_estimation.py:
400-437, and the rectified row/disparity match filter, matching.py:192-228):
one Hamming matmul over the left/right feature blocks with the epipolar gate
applied INSIDE the distance matrix, so every left keypoint gets a depth in a
single dispatch. These measurements feed the depth-aware PnP residual
(ops/pnp.py::refine_pose_gn_depth) so the second modality constrains pose
EVERY frame, not only at init / keyframe mapping.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .matching import BIG, distance_matrix, min2

_EPS = 1e-9


@partial(jax.jit, static_argnames=("ratio", "cross_check"))
def stereo_feature_depths(
    xy_l: jnp.ndarray,
    desc_l: jnp.ndarray,
    valid_l: jnp.ndarray,
    xy_r: jnp.ndarray,
    desc_r: jnp.ndarray,
    valid_r: jnp.ndarray,
    bf: float,
    row_tolerance: float = 2.0,
    min_disparity: float = 0.1,
    max_disparity: float = 1e4,
    ratio: float = 0.8,
    cross_check: bool = True,
) -> dict:
    """Rectified-stereo depth per LEFT keypoint slot.

    The row/disparity epipolar gate is fused into the (K_l, K_r) Hamming
    matrix (not applied post-NN), so the nearest neighbour is the best
    *epipolar-consistent* candidate — one matmul, no host loop.

    Args:
      xy_l/xy_r: (K, 2) pixel coords. desc_*: (K, 8) packed rBRIEF.
      bf: stereo baseline x focal length (pixels * meters).

    Returns dict(z (K_l,) depth in meters, disparity (K_l,), right_idx
    (K_l,), valid (K_l,)).
    """
    # Metric follows the descriptor width (Hamming / L2 for float families).
    d = distance_matrix(desc_l, desc_r, valid_l, valid_r)
    dv = jnp.abs(xy_l[:, 1:2] - xy_r[None, :, 1])  # (K_l, K_r) row gap
    disp = xy_l[:, 0:1] - xy_r[None, :, 0]  # (K_l, K_r)
    gate = (dv <= row_tolerance) & (disp > min_disparity) & (disp < max_disparity)
    d = jnp.where(gate, d, BIG)

    best, second, ri = min2(d)  # reductions, not a top_k sort
    ok = best < BIG * 0.5
    if ratio > 0:
        ok &= best < ratio * second
    if cross_check:
        rev = jnp.argmin(d, axis=0)
        ok &= rev[ri] == jnp.arange(d.shape[0])
    dsp = xy_l[:, 0] - xy_r[ri, 0]
    dsp = jnp.maximum(dsp, _EPS)
    z = bf / dsp
    return {"z": z, "disparity": dsp, "right_idx": ri, "valid": ok}


@jax.jit
def sample_depth_at(depth: jnp.ndarray, xy: jnp.ndarray, depth_scale: float = 1.0) -> dict:
    """Nearest-pixel depth lookup per keypoint (RGB-D path).

    Nearest (not bilinear): depth images have step discontinuities at object
    boundaries where interpolation invents free-space depths.

    Returns dict(z (K,), valid (K,)) — valid where in-bounds and z > 0.
    """
    H, W = depth.shape[:2]
    ui = jnp.clip(jnp.round(xy[:, 0]).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip(jnp.round(xy[:, 1]).astype(jnp.int32), 0, H - 1)
    inb = (xy[:, 0] >= 0) & (xy[:, 0] < W) & (xy[:, 1] >= 0) & (xy[:, 1] < H)
    z = depth[vi, ui].astype(jnp.float32) * depth_scale
    return {"z": z, "valid": inb & (z > 0) & jnp.isfinite(z)}


@jax.jit
def backproject_depths(
    Kinv: jnp.ndarray,
    T_c2w: jnp.ndarray,
    xy: jnp.ndarray,
    z: jnp.ndarray,
) -> jnp.ndarray:
    """Pixels + depths -> world points, batched. (K,2),(K,) -> (K,3)."""
    ones = jnp.ones_like(z)
    rays = jnp.stack([xy[:, 0], xy[:, 1], ones], axis=-1) @ Kinv.T
    p_cam = rays * z[:, None]
    return p_cam @ T_c2w[:3, :3].T + T_c2w[:3, 3]


def backproject_np(Kinv, R_c2w, t_c2w, xy, z) -> np.ndarray:
    """Host-side batched backprojection (numpy twin of backproject_depths):
    pixels (K, 2) + depths (K,) -> world points (K, 3). Shared by the
    stereo/RGB-D keyframe handlers and CompiledSLAM's stereo landmark
    creation."""
    xy = np.asarray(xy)
    rays = np.concatenate([xy, np.ones((len(xy), 1))], axis=1) @ np.asarray(Kinv).T
    return (rays * np.asarray(z)[:, None]) @ np.asarray(R_c2w).T + np.asarray(t_c2w)
