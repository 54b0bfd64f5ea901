"""SO(3)/SE(3) Lie-group operations, pure JAX (jit/vmap friendly).

Device replacement for the reference's closed-form rotation/pose helpers
(reference: visual_slam/utils/geometry.py:10-190, visual_slam/map/pose.py:13-180,
scipy Rotation usage).  Everything here is branch-free, fixed-shape, and safe to
vmap over batches of rotations/poses.

Conventions (matching the reference):
  - Poses stored as 4x4 homogeneous transforms ``T_w2c`` (world -> camera).
  - Rotations are 3x3 matrices; axis-angle vectors ("rotvec") are in radians.
  - Quaternions are ``(w, x, y, z)`` scalar-first.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """so(3) hat operator: (..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(W: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`hat`: (..., 3, 3) -> (..., 3)."""
    return jnp.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], axis=-1)


def so3_exp(w: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues exponential map: axis-angle (..., 3) -> rotation (..., 3, 3).

    Branch-free Taylor fallback near theta=0 (replaces cv2.Rodrigues,
    reference: visual_slam/utils/motion_estimation.py:120-122).
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    # sin(t)/t and (1-cos(t))/t^2 with small-angle Taylor guards.
    use_taylor = theta2 < 1e-8
    a = jnp.where(use_taylor, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS))
    W = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """Logarithm map: rotation (..., 3, 3) -> axis-angle (..., 3).

    Uses the quaternion route, which is numerically stable across the full
    range of angles including near pi.
    """
    q = rotmat_to_quat(R)
    return quat_to_rotvec(q)


def quat_to_rotvec(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w,x,y,z) -> axis-angle vector."""
    q = q * jnp.sign(q[..., :1] + _EPS)  # hemisphere with w >= 0
    w, v = q[..., 0], q[..., 1:]
    vn = jnp.linalg.norm(v, axis=-1)
    angle = 2.0 * jnp.arctan2(vn, w)
    small = vn < 1e-8
    scale = jnp.where(small, 2.0 / jnp.clip(w, _EPS), angle / jnp.where(small, 1.0, vn))
    return v * scale[..., None]


def rotvec_to_quat(w: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle -> unit quaternion (w,x,y,z)."""
    theta = jnp.linalg.norm(w, axis=-1, keepdims=True)
    half = 0.5 * theta
    small = theta < 1e-8
    k = jnp.where(small, 0.5 - theta * theta / 48.0, jnp.sin(half) / jnp.where(small, 1.0, theta))
    return jnp.concatenate([jnp.cos(half), w * k], axis=-1)


def quat_to_rotmat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion (w,x,y,z) -> rotation matrix (..., 3, 3).

    Replaces the reference's numba ``qvec2rotmat`` (utils/geometry.py:161-171).
    """
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def rotmat_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w,x,y,z), branch-free.

    Computes all four Shepperd candidates and selects the best-conditioned one
    with ``where`` (replaces the reference's eigendecomposition rotmat2qvec,
    utils/geometry.py:174-190) — vmappable, no data-dependent control flow.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate quaternions, each scaled by 4*component^2 (always >= 0).
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    # Pick the candidate with the largest leading term (best conditioning).
    vals = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], axis=-1)
    idx = jnp.argmax(vals, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    q = jnp.take_along_axis(cands, idx[..., None, None], axis=-2)[..., 0, :]
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q * jnp.sign(q[..., :1] + _EPS)


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) exponential: twist (..., 6) [rho, phi] -> 4x4 transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    A = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    B = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / (theta2 + _EPS))
    C = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / (theta2 + _EPS))
    W = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    V = eye + B[..., None, None] * W + C[..., None, None] * (W @ W)
    t = (V @ rho[..., None])[..., 0]
    return make_T(R, t)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """4x4 transform -> twist (..., 6) [rho, phi]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    phi = so3_log(R)
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    half = 0.5 * theta
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.where(small, 1.0, jnp.sin(half) + _EPS)) / (theta2 + _EPS),
    )
    W = hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = eye - 0.5 * W + cot_term[..., None, None] * (W @ W)
    rho = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def make_T(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Assemble (..., 4, 4) from rotation and translation (reference poseRt,
    utils/geometry.py:10-21)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,))
    return jnp.concatenate([top, bottom[..., None, :]], axis=-2)


def inv_T(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form SE(3) inverse (reference inv_T, utils/geometry.py:29-40)."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_T(Rt, -(Rt @ t[..., None])[..., 0])


def compose(Ta: jnp.ndarray, Tb: jnp.ndarray) -> jnp.ndarray:
    """SE(3) composition Ta @ Tb."""
    return Ta @ Tb


def rotation_angle(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle in radians from trace (reference compute_parallax,
    utils/motion_estimation.py:293-309)."""
    tr = jnp.trace(R, axis1=-2, axis2=-1)
    c = jnp.clip((tr - 1.0) * 0.5, -1.0, 1.0)
    return jnp.arccos(c)


def project_to_so3(M: jnp.ndarray) -> jnp.ndarray:
    """Nearest rotation matrix to M via SVD (det +1 enforced)."""
    U, _, Vt = jnp.linalg.svd(M)
    d = jnp.linalg.det(U @ Vt)
    D = jnp.concatenate(
        [jnp.ones_like(d)[..., None], jnp.ones_like(d)[..., None], d[..., None]], axis=-1
    )
    return (U * D[..., None, :]) @ Vt


def det3x3(M: jnp.ndarray) -> jnp.ndarray:
    """Closed-form 3x3 determinant over (..., 3, 3).

    ``jnp.linalg.det`` lowers to a batched LU factorization; this
    elementwise cofactor expansion fuses with its neighbours. Use this in
    any batched hot path."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form cofactor inverse over (..., 3, 3) (elementwise; no LU —
    the same relowering backend/ba.py uses for the Schur point blocks)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = e * i - f * h
    c01 = c * h - b * i
    c02 = b * f - c * e
    c10 = f * g - d * i
    c11 = a * i - c * g
    c12 = c * d - a * f
    c20 = d * h - e * g
    c21 = b * g - a * h
    c22 = a * e - b * d
    det = a * c00 + b * c10 + c * c20
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def project_to_so3_newton(M: jnp.ndarray, iters: int = 5) -> jnp.ndarray:
    """Nearest rotation to M (det(M) > 0) by Higham-scaled Newton polar
    iteration: X <- (g X + (X^-1)^T / g) / 2 with g = |det X|^(-1/3).

    Pure elementwise math (closed-form 3x3 inverse + determinant) instead
    of a batched iterative SVD (agrees with SVD to ~5e-7). Quadratic
    convergence once the singular values near 1; 5 iterations cover the
    noisy-DLT inputs RANSAC feeds it. det(M) <= 0 inputs (a reflection fit
    — a degenerate minimal sample) converge to an improper factor and
    simply lose the RANSAC argmax; callers needing the exact nearest
    rotation for such inputs must use the SVD ``project_to_so3``."""
    X = M

    def body(X, _):
        Xit = jnp.swapaxes(inv3x3(X), -1, -2)
        d = jnp.abs(det3x3(X)) + 1e-12
        g = d ** (-1.0 / 3.0)
        X = 0.5 * (g[..., None, None] * X + Xit / g[..., None, None])
        return X, None

    X, _ = jax.lax.scan(body, X, None, length=iters)
    return X


# Euler conversions (reference yaw/pitch/roll matrices, utils/geometry.py:107-154).
def euler_to_rotmat(rpy: jnp.ndarray) -> jnp.ndarray:
    """XYZ-intrinsic (roll, pitch, yaw) -> R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.stack(
        [
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
            jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
            jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def rotmat_to_euler(R: jnp.ndarray) -> jnp.ndarray:
    """R -> (roll, pitch, yaw) with R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    sp = -R[..., 2, 0]
    pitch = jnp.arcsin(jnp.clip(sp, -1.0, 1.0))
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)

def se3_inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form rigid-transform inverse: [R t]^-1 = [R^T, -R^T t].
    Exact for SE(3) and avoids ``jnp.linalg.inv``'s general 4x4 LU (a
    factorization per matrix, and pivoting noise on a matrix whose inverse is
    analytic). Batched over leading dims."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -jnp.einsum("...ij,...j->...i", Rt, t)
    out = jnp.zeros_like(T)
    out = out.at[..., :3, :3].set(Rt)
    out = out.at[..., :3, 3].set(ti)
    return out.at[..., 3, 3].set(1.0)
