"""Batched two-view triangulation and geometric gates, pure JAX.

Device replacement for cv2.triangulatePoints and the reference's
depth/parallax filter chain (reference: visual_slam/utils/motion_estimation.py:
139-177 triangulate_points, 233-290 filter_by_parallax, 443-493
filter_points_by_depth, 202-230 compute_normalize_parallax).

Everything is fixed-shape: callers pass validity masks instead of shrinking
arrays, so the whole chain compiles once.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .lie import inv_T
from .linalg import nullspace_vector

_EPS = 1e-9


@jax.jit
def triangulate_gated(
    Kinv: jnp.ndarray,
    T_ref: jnp.ndarray,
    T_cur: jnp.ndarray,
    xy_ref: jnp.ndarray,
    xy_cur: jnp.ndarray,
    min_depth: jnp.ndarray,
    max_depth: jnp.ndarray,
    min_parallax_rad: jnp.ndarray,
    reproj_thresh_n: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Full keyframe-boundary triangulation chain in ONE program: pixel ->
    normalized coords, DLT, depth/parallax gates, and a two-view
    reprojection gate. Thresholds ride as traced scalars so one compile
    serves every config.

    The reprojection gate kills descriptor matches that pass ratio/cross-
    check but are geometrically wrong (aliasing under fast yaw): they
    triangulate to points that re-project badly in their OWN two views;
    ungated they enter the map, BA faithfully fits them, and PnP loses
    consistency (observed: map unusable in ~10 keyframes on a 6 deg/frame
    ring while the gated path survived).

    Replaces the previous eager op-by-op boundary math, which paid one
    device dispatch per op; this is one fused program.
    """
    from .projection import normalize_points

    x_ref = normalize_points(Kinv, xy_ref)
    x_cur = normalize_points(Kinv, xy_cur)
    pts3d, w_ok = triangulate_dlt(
        projection_from_T(T_ref), projection_from_T(T_cur), x_ref, x_cur
    )
    good = w_ok & depth_mask(T_ref, T_cur, pts3d, min_depth, max_depth)
    good &= parallax_angles(T_ref, T_cur, pts3d) >= min_parallax_rad

    def reproj_err2(T, x_obs):
        pc = pts3d @ T[:3, :3].T + T[:3, 3]
        z = jnp.where(jnp.abs(pc[:, 2]) < _EPS, _EPS, pc[:, 2])
        return jnp.sum((pc[:, :2] / z[:, None] - x_obs) ** 2, axis=-1)

    t2 = reproj_thresh_n * reproj_thresh_n
    good &= reproj_err2(T_ref, x_ref) < t2
    good &= reproj_err2(T_cur, x_cur) < t2
    return pts3d, good


def projection_from_T(T_w2c: jnp.ndarray) -> jnp.ndarray:
    """Normalized projection matrix P = [R|t] (3,4) from a 4x4 world->cam pose
    (matches the reference's use of T_w2c[:3] with K-normalized coordinates,
    motion_estimation.py:160-170)."""
    return T_w2c[..., :3, :]


def triangulate_dlt(
    P1: jnp.ndarray, P2: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Linear (DLT) triangulation of N correspondences in normalized coords.

    Args:
      P1, P2: (3, 4) normalized projection matrices (world -> image).
      x1, x2: (N, 2) normalized image coordinates.

    Returns:
      (pts3d_w (N, 3), w_ok (N,) bool) — homogeneous-w validity mask, the
      analogue of the reference's ``w != 0`` good-mask (motion_estimation.py:172).

    Implementation: per-point 4x4 system, smallest eigenvector of A^T A via
    ``eigh`` — batched over N by construction (no vmap over SVD needed).
    """
    # Rows of A: x*P[2]-P[0], y*P[2]-P[1] for each view -> (N, 4, 4)
    a0 = x1[..., 0:1] * P1[2] - P1[0]
    a1 = x1[..., 1:2] * P1[2] - P1[1]
    a2 = x2[..., 0:1] * P2[2] - P2[0]
    a3 = x2[..., 1:2] * P2[2] - P2[1]
    A = jnp.stack([a0, a1, a2, a3], axis=-2)  # (N, 4, 4)
    AtA = jnp.swapaxes(A, -1, -2) @ A
    # ops/linalg.nullspace_vector picks the solver per backend;
    # triangulation runs INSIDE the fused track chunk at every promotion.
    Xh = nullspace_vector(AtA)  # smallest eigenvalue's eigenvector
    w = Xh[..., 3]
    w_ok = jnp.abs(w) > _EPS
    ws = jnp.where(w_ok, w, 1.0)
    pts = Xh[..., :3] / ws[..., None]
    return pts, w_ok


def depths_in_cameras(
    T1_w2c: jnp.ndarray, T2_w2c: jnp.ndarray, pts3d_w: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Depths of world points in both camera frames."""
    R1, t1 = T1_w2c[..., :3, :3], T1_w2c[..., :3, 3]
    R2, t2 = T2_w2c[..., :3, :3], T2_w2c[..., :3, 3]
    z1 = pts3d_w @ R1[2] + t1[..., 2]
    z2 = pts3d_w @ R2[2] + t2[..., 2]
    return z1, z2


def depth_mask(
    T1_w2c: jnp.ndarray,
    T2_w2c: jnp.ndarray,
    pts3d_w: jnp.ndarray,
    min_depth: float,
    max_depth: float,
) -> jnp.ndarray:
    """Points whose depth lies in [min, max] in BOTH cameras (reference
    filter_points_by_depth, motion_estimation.py:443-493)."""
    z1, z2 = depths_in_cameras(T1_w2c, T2_w2c, pts3d_w)
    return (z1 > min_depth) & (z1 < max_depth) & (z2 > min_depth) & (z2 < max_depth)


def parallax_angles(
    T1_w2c: jnp.ndarray, T2_w2c: jnp.ndarray, pts3d_w: jnp.ndarray
) -> jnp.ndarray:
    """Per-point ray parallax angle (radians) between the two camera centers
    (reference filter_by_parallax, motion_estimation.py:233-290)."""
    C1 = inv_T(T1_w2c)[..., :3, 3]
    C2 = inv_T(T2_w2c)[..., :3, 3]
    r1 = pts3d_w - C1[..., None, :]
    r2 = pts3d_w - C2[..., None, :]
    n1 = jnp.linalg.norm(r1, axis=-1)
    n2 = jnp.linalg.norm(r2, axis=-1)
    cosang = jnp.sum(r1 * r2, axis=-1) / jnp.maximum(n1 * n2, _EPS)
    return jnp.arccos(jnp.clip(cosang, -1.0, 1.0))


def median_ray_parallax(
    R_rel: jnp.ndarray,
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    mask: jnp.ndarray,
) -> jnp.ndarray:
    """Median angle between rotation-compensated viewing rays — the
    initializer's pre-triangulation parallax gate (reference
    compute_normalize_parallax, motion_estimation.py:202-230).

    ``x1``/``x2`` are normalized coords in ref/cur frames; ``R_rel`` maps
    ref-camera rays into the cur camera. Masked entries are ignored via a
    masked median (invalid entries pushed to +inf and the median index scaled
    by the valid count).
    """
    r1 = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    r2 = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    r1r = r1 @ jnp.swapaxes(R_rel, -1, -2)
    c = jnp.sum(r1r * r2, axis=-1) / jnp.maximum(
        jnp.linalg.norm(r1r, axis=-1) * jnp.linalg.norm(r2, axis=-1), _EPS
    )
    ang = jnp.arccos(jnp.clip(c, -1.0, 1.0))
    return masked_median(ang, mask)


def masked_median(x: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median over entries where mask is True (fixed-shape: sorts with invalid
    entries pushed to +inf)."""
    n = jnp.sum(mask.astype(jnp.int32), axis=-1)
    big = jnp.asarray(jnp.inf, dtype=x.dtype)
    xs = jnp.sort(jnp.where(mask, x, big), axis=-1)
    idx = jnp.maximum(n - 1, 0) // 2
    idx2 = jnp.maximum(n - 1, 0) - idx  # == idx for odd n, idx+? for even
    lo = jnp.take_along_axis(xs, idx[..., None], axis=-1)[..., 0]
    hi = jnp.take_along_axis(xs, idx2[..., None], axis=-1)[..., 0]
    med = 0.5 * (lo + hi)
    return jnp.where(n > 0, med, jnp.zeros_like(med))
