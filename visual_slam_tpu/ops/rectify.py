"""Stereo rectification + dense undistortion/remap, pure JAX.

Device replacement for the reference's cv2.stereoRectify /
initUndistortRectifyMap / remap path (visual_slam/calibration.py:61-136),
which computed R1/R2/P1/P2/Q and rectification maps from a raw K1/K2/R/T rig.
Pre-rectified input needs none of it; this module lets an unrectified Kalibr/EuRoC-style rig run the row-gated stereo
pipeline, and gives distorted monocular cameras a dense undistortion path
(sparse keypoint undistortion remains the tracking-path default).

Conventions: ``x2 = R @ x1 + T`` maps left-camera coordinates into the right
camera (the Kalibr ``T_cn_cnm1`` convention the calibration loader returns).
Rectifying rotations R1/R2 map each camera's coordinates into its rectified
frame; P1/P2 are the rectified projections sharing one K_new with the
baseline along rectified +x.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .projection import denormalize_points, distort_normalized, normalize_points


def stereo_rectify(
    K1: np.ndarray,
    D1: np.ndarray,
    K2: np.ndarray,
    D2: np.ndarray,
    R: np.ndarray,
    T: np.ndarray,
) -> dict:
    """Bouguet-style rectification from a raw calibrated rig (host math,
    runs once per deployment; replaces cv2.stereoRectify, reference
    calibration.py:87-136).

    Returns dict(R1, R2, P1, P2, Q, K_new, baseline): R1/R2 rotate each
    camera into the common rectified orientation whose x-axis is the
    baseline; Q reprojects (u, v, disparity, 1) to 3D.
    """
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    R = np.asarray(R, np.float64)
    T = np.ravel(np.asarray(T, np.float64))[:3]

    # Right-camera center in left coordinates; rectified x-axis rides the
    # baseline so epipolar lines become image rows.
    C2 = -R.T @ T
    baseline = float(np.linalg.norm(C2))
    if baseline < 1e-12:
        raise ValueError("stereo_rectify: zero baseline")
    # Rectified +x rides the baseline TOWARD camera 2, whatever its sign in
    # left-camera coordinates: with no sign normalization camera 2 always
    # sits at +baseline on the rectified x-axis, which is exactly what
    # P2/Q encode. (An earlier e1[0]<0 flip put negative-x rigs' second
    # camera at (-baseline, 0, 0) while P2/Q still said +baseline —
    # disparity sign and Q reprojection came out wrong for those rigs.)
    e1 = C2 / baseline
    # Split the inter-camera rotation evenly: build the "down" axis from the
    # AVERAGE optical axis of the two cameras (expressed in left coords), so
    # neither image takes the whole rectifying rotation.
    z_avg = np.array([0.0, 0.0, 1.0]) + R.T @ np.array([0.0, 0.0, 1.0])
    e2 = np.cross(z_avg, e1)
    n2 = np.linalg.norm(e2)
    if n2 < 1e-9:  # degenerate: baseline parallel to optical axis
        e2 = np.cross(np.array([0.0, 1.0, 0.0]), e1)
        n2 = np.linalg.norm(e2)
    e2 = e2 / n2
    e3 = np.cross(e1, e2)
    # Rows of R_rect: rectified x = baseline, z = forward.
    R_rect = np.stack([e1, e2, e3 / np.linalg.norm(e3)])
    # Reorder to (x, y, z) with y = down: e2 as computed is x cross z_avg...
    # R_rect rows above are (x=e1, y=e2, z=e3); verify right-handedness.
    if np.linalg.det(R_rect) < 0:
        R_rect[1] = -R_rect[1]
    R1 = R_rect
    R2 = R_rect @ R.T

    # Shared rectified intrinsics: average focal, left principal point.
    f_new = 0.5 * (K1[0, 0] + K2[0, 0])
    cx = 0.5 * (K1[0, 2] + K2[0, 2])
    cy = 0.5 * (K1[1, 2] + K2[1, 2])
    K_new = np.array([[f_new, 0, cx], [0, f_new, cy], [0, 0, 1.0]])
    P1 = K_new @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K_new @ np.hstack([np.eye(3), np.array([[-baseline], [0.0], [0.0]])])
    Q = np.array(
        [
            [1.0, 0, 0, -cx],
            [0, 1.0, 0, -cy],
            [0, 0, 0, f_new],
            [0, 0, 1.0 / baseline, 0],
        ]
    )
    return {
        "R1": R1,
        "R2": R2,
        "P1": P1,
        "P2": P2,
        "Q": Q,
        "K_new": K_new,
        "baseline": baseline,
    }


@partial(jax.jit, static_argnames=("height", "width"))
def undistort_rectify_map(
    K: jnp.ndarray,
    dist: jnp.ndarray,
    R_rect: jnp.ndarray,
    K_new: jnp.ndarray,
    height: int,
    width: int,
) -> jnp.ndarray:
    """(2, H, W) source-pixel sampling map for the rectified image: for each
    rectified pixel, unproject through K_new, rotate back into the original
    camera (R_rect^T), z-divide, distort, and project through the original K
    (replaces cv2.initUndistortRectifyMap, reference calibration.py:61-84).
    Identity R_rect + zero dist degrade gracefully to a pure undistort /
    pure-resample map."""
    u = jnp.arange(width, dtype=jnp.float32)
    v = jnp.arange(height, dtype=jnp.float32)
    uu, vv = jnp.meshgrid(u, v)
    pts = jnp.stack([uu.reshape(-1), vv.reshape(-1)], axis=-1)  # (HW, 2)
    xy = normalize_points(jnp.linalg.inv(K_new), pts)
    rays = jnp.concatenate([xy, jnp.ones_like(xy[:, :1])], axis=-1)
    rays_cam = rays @ R_rect  # == (R_rect^T @ ray^T)^T
    z = jnp.where(jnp.abs(rays_cam[:, 2]) < 1e-9, 1e-9, rays_cam[:, 2])
    xy_cam = rays_cam[:, :2] / z[:, None]
    xy_dist = distort_normalized(dist, xy_cam)
    uv_src = denormalize_points(K, xy_dist)  # (HW, 2)
    return uv_src.T.reshape(2, height, width)  # [0]=x map, [1]=y map


@jax.jit
def remap_bilinear(img: jnp.ndarray, smap: jnp.ndarray) -> jnp.ndarray:
    """Bilinear resample of ``img`` (H, W) at the (2, H', W') source map
    (replaces cv2.remap). Out-of-bounds samples clamp to the border."""
    H, W = img.shape
    x = jnp.clip(smap[0], 0.0, W - 1.001)
    y = jnp.clip(smap[1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    img_f = img.astype(jnp.float32)

    def at(yy, xx):
        return img_f[yy, xx]

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


@jax.jit
def rectify_pixels(
    K: jnp.ndarray,
    dist: jnp.ndarray,
    R_rect: jnp.ndarray,
    K_new: jnp.ndarray,
    pts: jnp.ndarray,
) -> jnp.ndarray:
    """Sparse (keypoint-level) rectification: original-image pixels ->
    rectified-image pixels. The SLAM-shaped alternative to dense remap when
    features are detected on the RAW image (undistort + rotate + reproject;
    the forward direction of undistort_rectify_map)."""
    from .projection import undistort_normalized

    xy_d = normalize_points(jnp.linalg.inv(K), pts)
    xy_u = undistort_normalized(dist, xy_d)
    rays = jnp.concatenate([xy_u, jnp.ones_like(xy_u[:, :1])], axis=-1)
    rays_r = rays @ R_rect.T  # into the rectified frame
    z = jnp.where(jnp.abs(rays_r[:, 2]) < 1e-9, 1e-9, rays_r[:, 2])
    return denormalize_points(K_new, rays_r[:, :2] / z[:, None])
