"""Camera projection math, pure JAX.

Device replacement for the reference's numba camera kernels
(reference: visual_slam/utils/camera.py:20-239, visual_slam/utils/geometry.py:87-100).
All functions are fixed-shape, jit/vmap friendly, and operate on batched point
arrays ``(..., N, 2|3)`` with intrinsics ``K (3,3)`` / distortion ``dist (5,)``
(OpenCV order k1 k2 p1 p2 k3).
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-9


def add_ones(pts: jnp.ndarray) -> jnp.ndarray:
    """(..., N, D) -> (..., N, D+1) homogeneous (reference add_ones,
    utils/geometry.py:60-80)."""
    return jnp.concatenate([pts, jnp.ones_like(pts[..., :1])], axis=-1)


def normalize_points(K_inv: jnp.ndarray, pts2d: jnp.ndarray) -> jnp.ndarray:
    """Pixel -> normalized image coordinates (reference ``normalize`` numba
    kernel, utils/geometry.py:87-100)."""
    ph = add_ones(pts2d)
    return (ph @ jnp.swapaxes(K_inv, -1, -2))[..., :2]


def denormalize_points(K: jnp.ndarray, pts_norm: jnp.ndarray) -> jnp.ndarray:
    """Normalized image coordinates -> pixels."""
    ph = add_ones(pts_norm)
    return (ph @ jnp.swapaxes(K, -1, -2))[..., :2]


def transform_points(T: jnp.ndarray, pts3d: jnp.ndarray) -> jnp.ndarray:
    """Apply SE(3) (..., 4, 4) to points (..., N, 3) (reference
    transform_points_numba, utils/geometry.py:193-206)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    return pts3d @ jnp.swapaxes(R, -1, -2) + t[..., None, :]


def project_points(
    K: jnp.ndarray, T_w2c: jnp.ndarray, pts3d_w: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """World points -> pixels and camera-frame depths.

    Returns ``(uv (..., N, 2), z (..., N))``.  Replaces the reference's
    ``project`` numba kernel (utils/camera.py:58-95).
    """
    pc = transform_points(T_w2c, pts3d_w)
    z = pc[..., 2]
    zs = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    xy = pc[..., :2] / zs[..., None]
    uv = denormalize_points(K, xy)
    return uv, z


def project_camera_points(K: jnp.ndarray, pts3d_c: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Camera-frame points -> pixels and depths."""
    z = pts3d_c[..., 2]
    zs = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    uv = denormalize_points(K, pts3d_c[..., :2] / zs[..., None])
    return uv, z


def backproject(K_inv: jnp.ndarray, pts2d: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """Pixels + depths -> camera-frame 3D points (reference backproject_3d,
    utils/camera.py:20-56)."""
    rays = add_ones(normalize_points(K_inv, pts2d))
    return rays * depth[..., None]


def unproject_points(K_inv: jnp.ndarray, pts2d: jnp.ndarray) -> jnp.ndarray:
    """Pixels -> unit-depth rays (x, y, 1) (reference unproject_points_3d,
    utils/camera.py:176-211)."""
    return add_ones(normalize_points(K_inv, pts2d))


def are_in_image(
    pts2d: jnp.ndarray, width: int, height: int, margin: float = 0.0
) -> jnp.ndarray:
    """Bounds mask (reference are_in_image_numba, utils/camera.py:213-239)."""
    u, v = pts2d[..., 0], pts2d[..., 1]
    return (
        (u >= margin) & (u < width - margin) & (v >= margin) & (v < height - margin)
    )


def distort_normalized(dist: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Apply radial-tangential (Brown-Conrady) distortion to normalized coords.

    ``dist = (k1, k2, p1, p2, k3)`` — OpenCV layout, matching the reference's
    calibration files (visual_slam/calibration.py:42-84).
    """
    k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xt = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yt = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xt, yt], axis=-1)


def undistort_normalized(dist: jnp.ndarray, xy_d: jnp.ndarray, iters: int = 8) -> jnp.ndarray:
    """Invert distortion by fixed-point iteration (fixed iteration count —
    compiler-friendly; replaces cv2.undistortPoints, reference camera.py:166)."""
    xy = xy_d

    def body(xy, _):
        k1, k2, p1, p2, k3 = dist[0], dist[1], dist[2], dist[3], dist[4]
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xy_new = (xy_d - jnp.stack([dx, dy], axis=-1)) / radial[..., None]
        return xy_new, None

    for _ in range(iters):
        xy, _ = body(xy, None)
    return xy


def undistort_pixels(
    K: jnp.ndarray, K_inv: jnp.ndarray, dist: jnp.ndarray, pts2d: jnp.ndarray
) -> jnp.ndarray:
    """Undistort pixel coordinates, returning pixel coordinates under the same K."""
    xy = normalize_points(K_inv, pts2d)
    xy_u = undistort_normalized(dist, xy)
    return denormalize_points(K, xy_u)


def reprojection_errors(
    K: jnp.ndarray, T_w2c: jnp.ndarray, pts3d_w: jnp.ndarray, uv_obs: jnp.ndarray
) -> jnp.ndarray:
    """Per-point pixel reprojection error norms (reference
    compute_reprojection_error, utils/geometry.py:209-247)."""
    uv, _ = project_points(K, T_w2c, pts3d_w)
    return jnp.linalg.norm(uv - uv_obs, axis=-1)


def view_cos(T_w2c: jnp.ndarray, pts3d_w: jnp.ndarray) -> jnp.ndarray:
    """Cosine between camera viewing axis and the ray to each point, used for
    the visibility gate (reference frame.py:193-259 view-cos > 0.5)."""
    pc = transform_points(T_w2c, pts3d_w)
    n = jnp.linalg.norm(pc, axis=-1)
    return pc[..., 2] / jnp.where(n < _EPS, _EPS, n)


def fov2focal(fov: jnp.ndarray, pixels: jnp.ndarray) -> jnp.ndarray:
    """(reference utils/camera.py:10-13)"""
    return pixels / (2.0 * jnp.tan(fov * 0.5))


def focal2fov(focal: jnp.ndarray, pixels: jnp.ndarray) -> jnp.ndarray:
    """(reference utils/camera.py:15-17)"""
    return 2.0 * jnp.arctan2(pixels, 2.0 * focal)
