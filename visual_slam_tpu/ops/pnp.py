"""Perspective-n-Point pose estimation: vmapped fixed-budget RANSAC over
DLT hypotheses + Gauss-Newton SE(3) refinement. Pure JAX.

Device replacement for cv2.solvePnPRansac / cv2.solvePnP
(reference: visual_slam/utils/motion_estimation.py:57-132, used by
Tracking._optimize_pose_mono, tracking.py:332-413).

OpenCV's adaptive, early-exiting RANSAC becomes a fixed batch of hypotheses:
each samples 6 correspondences, fits a projection matrix with weighted DLT,
projects it onto SE(3), and is scored by robust reprojection error across all
correspondences.  The winner is polished with a fixed number of damped
Gauss-Newton iterations (Huber-weighted IRLS) — the whole solve is a single
jitted program with no data-dependent control flow.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .lie import make_T, project_to_so3, so3_exp
from .linalg import nullspace_vector

_EPS = 1e-9


def pnp_dlt(
    pts3d: jnp.ndarray, xy: jnp.ndarray, w: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted DLT pose from 3D-2D correspondences in *normalized* image
    coordinates.  Needs >= 6 effective points.

    Returns (R (3,3), t (3,)) mapping world -> camera, with cheirality fixed
    so the weighted mean depth is positive.
    """
    X, Y, Z = pts3d[:, 0], pts3d[:, 1], pts3d[:, 2]
    u, v = xy[:, 0], xy[:, 1]
    one = jnp.ones_like(X)
    zero = jnp.zeros_like(X)
    # Rows for u: [X Y Z 1 0 0 0 0 -uX -uY -uZ -u]
    r1 = jnp.stack([X, Y, Z, one, zero, zero, zero, zero, -u * X, -u * Y, -u * Z, -u], axis=-1)
    r2 = jnp.stack([zero, zero, zero, zero, X, Y, Z, one, -v * X, -v * Y, -v * Z, -v], axis=-1)
    A = jnp.concatenate([r1, r2], axis=0)  # (2N, 12)
    ww = jnp.concatenate([w, w], axis=0)
    AtA = (A * ww[:, None]).T @ A
    # Nullspace via ops/linalg.nullspace_vector, which picks the solver per
    # backend (see there).
    p = nullspace_vector(AtA)
    P = p.reshape(3, 4)
    M = P[:, :3]
    # Scale: ||lambda R|| rows have norm |lambda|; use the geometric mean of
    # singular values so noise spreads evenly.
    s = jnp.linalg.svd(M, compute_uv=False)
    lam = jnp.maximum(jnp.exp(jnp.mean(jnp.log(jnp.maximum(s, _EPS)))), _EPS)
    sign = jnp.sign(jnp.linalg.det(M))
    sign = jnp.where(sign == 0, 1.0, sign)
    R = project_to_so3(M / (lam * sign))
    t = P[:, 3] / (lam * sign)
    # Cheirality: flip if weighted mean depth negative.
    z = pts3d @ R[2] + t[2]
    flip = jnp.sum(z * w) < 0
    R = jnp.where(flip, -R, R)
    R = project_to_so3(R)  # -R of a rotation is not a rotation; re-project
    t = jnp.where(flip, -t, t)
    return R, t


def _reproj_err2(R: jnp.ndarray, t: jnp.ndarray, pts3d: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Squared reprojection error in normalized coords; points behind the
    camera get a large penalty."""
    pc = pts3d @ R.T + t
    z = pc[:, 2]
    zs = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    proj = pc[:, :2] / zs[:, None]
    e2 = jnp.sum((proj - xy) ** 2, axis=-1)
    return jnp.where(z > _EPS, e2, 1e6)


def refine_pose_gn(
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    pts3d: jnp.ndarray,
    xy: jnp.ndarray,
    w: jnp.ndarray,
    iters: int = 8,
    huber: float = 3e-3,
    damping: float = 1e-6,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Damped Gauss-Newton on SE(3) minimizing Huber-weighted reprojection
    error in normalized coordinates. Left-multiplicative se(3) update:
    T <- exp(xi) T.  Fixed iteration count (compiler-friendly)."""

    def step(carry, _):
        R, t = carry
        pc = pts3d @ R.T + t  # (N, 3)
        x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
        zs = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
        inv_z = 1.0 / zs
        u = x * inv_z
        v = y * inv_z
        r = jnp.stack([u - xy[:, 0], v - xy[:, 1]], axis=-1)  # (N, 2)
        # Jacobian of projection wrt camera-frame point p: (2, 3)
        #   du/dp = [1/z, 0, -x/z^2]; dv/dp = [0, 1/z, -y/z^2]
        # wrt left-perturbation xi = (rho, phi): dp/dxi = [I, -hat(p)]
        Ju = jnp.stack(
            [inv_z, jnp.zeros_like(u), -u * inv_z, -u * v, 1.0 + u * u, -v], axis=-1
        )  # (N, 6)
        Jv = jnp.stack(
            [jnp.zeros_like(u), inv_z, -v * inv_z, -(1.0 + v * v), u * v, u], axis=-1
        )
        # Huber IRLS weights
        rn = jnp.linalg.norm(r, axis=-1)
        hw = jnp.where(rn <= huber, 1.0, huber / jnp.maximum(rn, _EPS))
        ww = w * hw * (z > _EPS)
        J = jnp.stack([Ju, Jv], axis=1)  # (N, 2, 6)
        JtJ = jnp.einsum("nif,n,nig->fg", J, ww, J)
        Jtr = jnp.einsum("nif,n,ni->f", J, ww, r)
        H = JtJ + damping * jnp.eye(6, dtype=R.dtype)
        # H is SPD (damped normal equations): Cholesky, not 6x6 LU.
        L = jnp.linalg.cholesky(H)
        xi = -jax.scipy.linalg.cho_solve((L, True), Jtr)
        dT = so3_exp(xi[3:])
        R_new = dT @ R
        t_new = dT @ t + xi[:3]
        return (R_new, t_new), None

    (R, t), _ = jax.lax.scan(step, (R0, t0), None, length=iters)
    return R, t


def refine_pose_gn_depth(
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    pts3d: jnp.ndarray,
    xy: jnp.ndarray,
    w: jnp.ndarray,
    z_meas: jnp.ndarray,
    w_z: jnp.ndarray,
    baseline: float,
    iters: int = 8,
    huber: float = 3e-3,
    damping: float = 1e-6,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gauss-Newton SE(3) refinement with a stereo/RGB-D depth residual.

    Beyond the 2D reprojection residuals, each point with a depth
    measurement contributes the virtual-right-coordinate residual of
    rectified stereo in normalized units (ORB-SLAM2's 3-DOF stereo edge):
        r_z = b * (1/z_hat - 1/z_meas)
    where b is the (virtual) baseline in meters, so r_z is the normalized
    disparity error — directly commensurate with the reprojection residuals.
    This pins translation along the optical axis and metric scale every
    frame (reference stubs never use the second modality in tracking,
    visual_slam/tracking.py:415-444).

    Args:
      z_meas: (N,) measured camera-frame depths. w_z: (N,) depth validity
        weights (0/1). baseline: meters (stereo: the real baseline; RGB-D:
        a virtual one).
    """
    inv_zm = 1.0 / jnp.maximum(z_meas, _EPS)

    def step(carry, _):
        R, t = carry
        pc = pts3d @ R.T + t  # (N, 3)
        x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
        zs = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
        inv_z = 1.0 / zs
        u = x * inv_z
        v = y * inv_z
        r = jnp.stack([u - xy[:, 0], v - xy[:, 1]], axis=-1)
        Ju = jnp.stack(
            [inv_z, jnp.zeros_like(u), -u * inv_z, -u * v, 1.0 + u * u, -v], axis=-1
        )
        Jv = jnp.stack(
            [jnp.zeros_like(u), inv_z, -v * inv_z, -(1.0 + v * v), u * v, u], axis=-1
        )
        rn = jnp.linalg.norm(r, axis=-1)
        hw = jnp.where(rn <= huber, 1.0, huber / jnp.maximum(rn, _EPS))
        ww = w * hw * (z > _EPS)
        J = jnp.stack([Ju, Jv], axis=1)  # (N, 2, 6)
        JtJ = jnp.einsum("nif,n,nig->fg", J, ww, J)
        Jtr = jnp.einsum("nif,n,ni->f", J, ww, r)

        # Depth residual block. d(1/z)/d(rho) = [0,0,-1/z^2];
        # d(1/z)/d(phi) = -1/z^2 * dz/dphi with dz/dphi = [y,-x,0]
        # (left perturbation, dp/dxi = [I | -hat(p)]).
        rz = baseline * (inv_z - inv_zm)
        Jz = baseline * jnp.stack(
            [
                jnp.zeros_like(u),
                jnp.zeros_like(u),
                -inv_z * inv_z,
                -v * inv_z,
                u * inv_z,
                jnp.zeros_like(u),
            ],
            axis=-1,
        )  # (N, 6)
        hz = jnp.where(jnp.abs(rz) <= huber, 1.0, huber / jnp.maximum(jnp.abs(rz), _EPS))
        wz = w * w_z * hz * (z > _EPS)
        JtJ = JtJ + jnp.einsum("nf,n,ng->fg", Jz, wz, Jz)
        Jtr = Jtr + jnp.einsum("nf,n,n->f", Jz, wz, rz)

        H = JtJ + damping * jnp.eye(6, dtype=R.dtype)
        # H is SPD (damped normal equations): Cholesky, not 6x6 LU.
        L = jnp.linalg.cholesky(H)
        xi = -jax.scipy.linalg.cho_solve((L, True), Jtr)
        dT = so3_exp(xi[3:])
        return (dT @ R, dT @ t + xi[:3]), None

    (R, t), _ = jax.lax.scan(step, (R0, t0), None, length=iters)
    return R, t


def _depth_err2(
    R: jnp.ndarray, t: jnp.ndarray, pts3d: jnp.ndarray, z_meas: jnp.ndarray, baseline: float
) -> jnp.ndarray:
    """Squared normalized-disparity error of the depth measurements."""
    z = pts3d @ R[2] + t[2]
    zs = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    rz = baseline * (1.0 / zs - 1.0 / jnp.maximum(z_meas, _EPS))
    return jnp.where(z > _EPS, rz * rz, 1e6)


@partial(jax.jit, static_argnames=("n_hyp", "refine_iters"))
def ransac_pnp_depth(
    pts3d: jnp.ndarray,
    xy: jnp.ndarray,
    mask: jnp.ndarray,
    z_meas: jnp.ndarray,
    z_valid: jnp.ndarray,
    baseline: float,
    key: jax.Array,
    n_hyp: int = 256,
    thresh: float = 6e-3,
    refine_iters: int = 8,
) -> dict:
    """Fixed-budget RANSAC PnP with per-point depth measurements.

    Hypotheses come from the same 6-point DLT as ``ransac_pnp``; local
    optimization, scoring, and the final polish all include the
    normalized-disparity depth residual, so the winning pose is consistent
    with the second modality (stereo disparity / RGB-D depth) as well as
    reprojection. Inlier classification stays reprojection-based for
    comparability with the mono path.
    """
    from .epipolar import _sample_minimal_sets

    idx = _sample_minimal_sets(key, mask, n_hyp, 6)

    def fit(sample_idx):
        w = jnp.ones(6, dtype=xy.dtype)
        return pnp_dlt(pts3d[sample_idx], xy[sample_idx], w)

    Rs, ts = jax.vmap(fit)(idx)
    mask_f = mask.astype(xy.dtype)
    zw = (z_valid & mask).astype(xy.dtype)

    def local_opt(R, t):
        return refine_pose_gn_depth(
            R, t, pts3d, xy, mask_f, z_meas, zw, baseline, iters=2, huber=4.0 * thresh
        )

    Rs, ts = jax.vmap(local_opt)(Rs, ts)
    errs = jax.vmap(lambda R, t: _reproj_err2(R, t, pts3d, xy))(Rs, ts)
    errs_z = jax.vmap(lambda R, t: _depth_err2(R, t, pts3d, z_meas, baseline))(Rs, ts)
    t2 = thresh * thresh
    cost = jnp.where(mask[None, :], jnp.minimum(errs, t2), 0.0).sum(axis=-1)
    cost = cost + jnp.where((z_valid & mask)[None, :], jnp.minimum(errs_z, t2), 0.0).sum(axis=-1)
    best = jnp.argmin(cost)
    R0, t0 = Rs[best], ts[best]
    inl0 = (_reproj_err2(R0, t0, pts3d, xy) < t2) & mask
    R, t = refine_pose_gn_depth(
        R0, t0, pts3d, xy, inl0.astype(xy.dtype), z_meas, zw, baseline,
        iters=refine_iters, huber=thresh,
    )
    inliers = (_reproj_err2(R, t, pts3d, xy) < t2) & mask
    better = jnp.sum(inliers) >= jnp.sum(inl0)
    R = jnp.where(better, R, R0)
    t = jnp.where(better, t, t0)
    inliers = jnp.where(better, inliers, inl0)
    n_inl = jnp.sum(inliers)
    return {
        "R": R,
        "t": t,
        "T": make_T(R, t),
        "inliers": inliers,
        "n_inliers": n_inl,
        "ok": n_inl >= 6,
    }


@partial(jax.jit, static_argnames=("n_hyp", "refine_iters"))
def ransac_pnp(
    pts3d: jnp.ndarray,
    xy: jnp.ndarray,
    mask: jnp.ndarray,
    key: jax.Array,
    n_hyp: int = 256,
    thresh: float = 6e-3,
    refine_iters: int = 8,
) -> dict:
    """Fixed-budget RANSAC PnP in normalized image coordinates.

    Mirrors cv2.solvePnPRansac (iterationsCount=100, reprojectionError=3.0 px
    ~ 3/f normalized, confidence=0.99; reference motion_estimation.py:107-118)
    with a hypothesis batch + argmin selection + GN polish.

    Args:
      pts3d: (N, 3) world points. xy: (N, 2) normalized observations.
      mask: (N,) validity. thresh: inlier threshold in normalized coords
        (pixels / focal_length).

    Returns dict(R, t, T (4,4), inliers (N,), n_inliers, ok).
    """
    from .epipolar import _sample_minimal_sets  # local import, no cycle at module level

    idx = _sample_minimal_sets(key, mask, n_hyp, 6)

    def fit(sample_idx):
        w = jnp.ones(6, dtype=xy.dtype)
        return pnp_dlt(pts3d[sample_idx], xy[sample_idx], w)

    Rs, ts = jax.vmap(fit)(idx)

    # Per-hypothesis local optimization (vmapped LO-RANSAC, like the
    # essential solver): two Huber-GN steps over the full correspondence set
    # turn noisy minimal DLT fits into strong candidates, so a small
    # hypothesis budget suffices.
    mask_f = mask.astype(xy.dtype)

    def local_opt(R, t):
        return refine_pose_gn(R, t, pts3d, xy, mask_f, iters=2, huber=4.0 * thresh)

    Rs, ts = jax.vmap(local_opt)(Rs, ts)
    errs = jax.vmap(lambda R, t: _reproj_err2(R, t, pts3d, xy))(Rs, ts)  # (H, N)
    t2 = thresh * thresh
    cost = jnp.where(mask[None, :], jnp.minimum(errs, t2), 0.0).sum(axis=-1)
    best = jnp.argmin(cost)
    R0, t0 = Rs[best], ts[best]
    inl0 = (_reproj_err2(R0, t0, pts3d, xy) < t2) & mask
    # Polish on inliers (Huber at the inlier threshold).
    R, t = refine_pose_gn(
        R0, t0, pts3d, xy, inl0.astype(xy.dtype), iters=refine_iters, huber=thresh
    )
    inliers = (_reproj_err2(R, t, pts3d, xy) < t2) & mask
    better = jnp.sum(inliers) >= jnp.sum(inl0)
    R = jnp.where(better, R, R0)
    t = jnp.where(better, t, t0)
    inliers = jnp.where(better, inliers, inl0)
    n_inl = jnp.sum(inliers)
    return {
        "R": R,
        "t": t,
        "T": make_T(R, t),
        "inliers": inliers,
        "n_inliers": n_inl,
        "ok": n_inl >= 6,
    }
