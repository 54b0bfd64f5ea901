"""Levenberg-Marquardt bundle adjustment with Schur-complement landmark
elimination, pure JAX — the centerpiece of the device back-end.

Device replacement for the reference's TorchOptimizer
(visual_slam/optimization/torch_optimizer.py): where the reference runs Adam
with a per-observation Python loop (torch_optimizer.py:148-178 — its
documented bottleneck, docs/article.md:675), this solver batches ALL
observations as a dense (M points x W poses) grid and runs a damped LM loop
whose every step is fixed-shape linear algebra:

  * residuals + analytic Jacobians over the (M, W) grid in one shot,
  * Huber IRLS robustification (reference huber_delta semantics),
  * normal-equation blocks via einsum (U: per-pose 6x6, V: per-point 3x3,
    Y: per-obs 6x3),
  * Schur complement S = U - Y V^-1 Y^T reducing to a (6W, 6W) dense solve,
  * landmark back-substitution with batched 3x3 inverses,
  * gain-ratio accept/reject with adaptive damping, fixed iteration count.

Gauge fixing matches the reference (first keyframe frozen,
torch_optimizer.py:54-57) via a ``pose_fixed`` mask.

Observations are in *normalized* image coordinates (pixels premultiplied by
K^-1), so intrinsics never enter the solver; thresholds in pixels are divided
by the focal length at the call site.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.lie import so3_exp

_EPS = 1e-9


class BAProblem(NamedTuple):
    """Fixed-capacity bundle-adjustment window.

    The dense (M, W) observation grid holds at most one observation per
    (landmark, keyframe) pair — exactly the SLAM structure (a keypoint index
    per KF per map point, reference observation.py:4-100).
    """

    T_w2c: jnp.ndarray  # (W, 4, 4) keyframe poses, world -> camera
    points: jnp.ndarray  # (M, 3) landmark positions (world)
    uv: jnp.ndarray  # (M, W, 2) normalized observations
    obs_valid: jnp.ndarray  # (M, W) bool
    pose_valid: jnp.ndarray  # (W,) bool — slot in use
    pose_fixed: jnp.ndarray  # (W,) bool — gauge-frozen (e.g. first KF)

    @property
    def n_poses(self) -> int:
        return self.T_w2c.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @classmethod
    def from_dense(cls, problem: BAProblem, k_slots: int) -> "BASparse":
        """Re-layout a dense (M, W) problem into ``k_slots`` observation
        slots per landmark, keeping each landmark's first ``k_slots``
        observations in keyframe order (host-side numpy)."""
        import numpy as np

        valid = np.asarray(problem.obs_valid)
        uv = np.asarray(problem.uv)
        M = valid.shape[0]
        s_uv = np.zeros((M, k_slots, 2), np.float32)
        s_pose = np.zeros((M, k_slots), np.int32)
        s_valid = np.zeros((M, k_slots), bool)
        for i in range(M):
            js = np.nonzero(valid[i])[0][:k_slots]
            s_uv[i, : len(js)] = uv[i, js]
            s_pose[i, : len(js)] = js
            s_valid[i, : len(js)] = True
        return cls(
            T_w2c=problem.T_w2c, points=problem.points, uv=jnp.asarray(s_uv),
            obs_pose=jnp.asarray(s_pose), obs_valid=jnp.asarray(s_valid),
            pose_valid=problem.pose_valid, pose_fixed=problem.pose_fixed,
        )


def _residuals_and_jacobians(T_w2c, points, uv, w):
    """Residuals r (M, W, 2), pose Jacobians Jp (M, W, 2, 6) for the left
    se(3) perturbation, point Jacobians Jx (M, W, 2, 3), and depth mask."""
    R = T_w2c[:, :3, :3]  # (W, 3, 3)
    t = T_w2c[:, :3, 3]  # (W, 3)
    # Camera-frame points: (M, W, 3)
    pc = jnp.einsum("wab,mb->mwa", R, points) + t[None]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    inv_z = 1.0 / zs
    u = x * inv_z
    v = y * inv_z
    r = jnp.stack([u, v], axis=-1) - uv  # (M, W, 2)
    zero = jnp.zeros_like(u)
    # d(proj)/d xi with xi = (rho, phi), left perturbation T <- exp(xi) T.
    Ju = jnp.stack([inv_z, zero, -u * inv_z, -u * v, 1.0 + u * u, -v], axis=-1)
    Jv = jnp.stack([zero, inv_z, -v * inv_z, -(1.0 + v * v), u * v, u], axis=-1)
    Jp = jnp.stack([Ju, Jv], axis=-2)  # (M, W, 2, 6)
    # d(proj)/d pc @ d pc / dX = A @ R: A = [[1/z,0,-x/z^2],[0,1/z,-y/z^2]]
    A = jnp.stack(
        [
            jnp.stack([inv_z, zero, -u * inv_z], axis=-1),
            jnp.stack([zero, inv_z, -v * inv_z], axis=-1),
        ],
        axis=-2,
    )  # (M, W, 2, 3)
    Jx = jnp.einsum("mwab,wbc->mwac", A, R)  # (M, W, 2, 3)
    in_front = z > _EPS
    return r, Jp, Jx, in_front


def _inv3x3(A):
    """Closed-form cofactor inverse of batched 3x3 matrices (..., 3, 3).

    ``jnp.linalg.inv`` lowers to a batched LU with pivoting, which was the
    single largest term of the whole solve at M=4096 landmarks on earlier
    hardware. The adjugate formula is exact, branch-free, and pure elementwise math;
    the damped V blocks are symmetric positive-definite so no pivoting is
    ever needed."""
    a = A[..., 0, 0]; b = A[..., 0, 1]; c = A[..., 0, 2]
    d = A[..., 1, 0]; e = A[..., 1, 1]; f = A[..., 1, 2]
    g = A[..., 2, 0]; h = A[..., 2, 1]; i = A[..., 2, 2]
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
    inv_det = 1.0 / jnp.where(jnp.abs(det) < _EPS, _EPS, det)
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=-1),
            jnp.stack([c10, c11, c12], axis=-1),
            jnp.stack([c20, c21, c22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def _robust_weights(r, huber):
    """Huber IRLS weights from residual norms (M, W)."""
    rn = jnp.linalg.norm(r, axis=-1)
    return jnp.where(rn <= huber, 1.0, huber / jnp.maximum(rn, _EPS))


def _cost(r, w_obs, in_front, huber, axis_name=None):
    """Total robust (Huber) cost. r: (M, W, 2), w_obs/in_front: (M, W). With
    ``axis_name``, M is a sharded axis and the sum is completed by psum.

    Behind-camera observations pay a large FIXED penalty instead of zero:
    with them merely masked out, "push every landmark behind the cameras"
    is a global minimum (cost 0) and f32 LM paths do find that basin on
    weak-parallax windows (observed: window cost 3e-3 -> 1e-16 with
    landmarks meters away — map destroyed while 'converged'). The penalty
    makes any step that loses cheirality strictly worse than the worst
    plausible inlier residual, so accept/reject can never walk there."""
    rn2 = jnp.sum(r * r, axis=-1)
    rn = jnp.sqrt(rn2 + _EPS)
    quad = 0.5 * rn2
    lin = huber * (rn - 0.5 * huber)
    rho = jnp.where(rn <= huber, quad, lin)
    pen = 20.0 * huber  # >> rho at any clamped in-image residual
    c = jnp.sum(jnp.where(in_front, rho, pen) * w_obs)
    if axis_name is not None:
        c = jax.lax.psum(c, axis_name)
    return c


def _solve_step(T_w2c, points, uv, w_obs, pose_free, lam, huber, axis_name=None):
    """One LM linear solve: returns (dxi (W, 6), dX (M, 3)).

    With ``axis_name`` set, the landmark axis M is SHARDED across a device
    mesh (shard_map): each device builds partial pose blocks (U, S_cross, b)
    over its landmark shard, a psum over the mesh completes the reduction,
    the tiny (6W, 6W) Schur system is solved replicated, and landmark
    back-substitution stays local — one all-reduce of O(W^2) data per
    iteration rides the device interconnect.
    """
    M, W = uv.shape[:2]
    r, Jp, Jx, in_front = _residuals_and_jacobians(T_w2c, points, uv, w_obs > 0)
    w = w_obs * _robust_weights(r, huber) * in_front  # (M, W)
    # Zero pose Jacobians of fixed/invalid poses (gauge).
    Jp = Jp * pose_free[None, :, None, None]
    Jpw = Jp * w[..., None, None]
    Jxw = Jx * w[..., None, None]

    # Normal-equation blocks. Contractions over the BIG m axis stay einsums
    # (matmuls); every 2/3-wide contraction below is UNROLLED to broadcast
    # multiply-adds, which fuse — a dot_general over a 3-wide axis lowers to
    # per-m padded matmuls (identical costs either way).
    U = jnp.einsum("mwai,mwaj->wij", Jpw, Jp)  # (W, 6, 6)
    V = jnp.einsum("mwai,mwaj->mij", Jxw, Jx)  # (M, 3, 3)
    gp = jnp.einsum("mwai,mwa->wi", Jpw, r)  # (W, 6)
    gx = jnp.einsum("mwai,mwa->mi", Jxw, r)  # (M, 3)
    # Y (M, W, 6, 3): unroll the 2-wide residual axis.
    Y = (
        Jpw[:, :, 0, :, None] * Jx[:, :, 0, None, :]
        + Jpw[:, :, 1, :, None] * Jx[:, :, 1, None, :]
    )

    # Complete the pose-block reductions across landmark shards BEFORE
    # damping (damping must be added exactly once).
    if axis_name is not None:
        U = jax.lax.psum(U, axis_name)
        gp = jax.lax.psum(gp, axis_name)

    # Damp.
    U = U + lam * jnp.eye(6)[None]
    V = V + lam * jnp.eye(3)[None]
    Vinv = _inv3x3(V)  # batched 3x3, closed form

    # Schur complement on landmarks. T_blk = Y @ Vinv per landmark:
    # unroll the 3-wide contraction (see cliff note above).
    T_blk = (
        Y[:, :, :, 0, None] * Vinv[:, None, None, 0, :]
        + Y[:, :, :, 1, None] * Vinv[:, None, None, 1, :]
        + Y[:, :, :, 2, None] * Vinv[:, None, None, 2, :]
    )  # (M, W, 6, 3)
    S_cross = jnp.einsum("muik,mvjk->uivj", T_blk, Y)  # (W, 6, W, 6)
    b_local = -jnp.einsum("mwik,mk->wi", T_blk, gx)  # (W, 6) partial
    if axis_name is not None:
        S_cross = jax.lax.psum(S_cross, axis_name)
        b_local = jax.lax.psum(b_local, axis_name)
    b = gp + b_local
    S = jnp.zeros((W, 6, W, 6)).at[jnp.arange(W), :, jnp.arange(W), :].add(U) - S_cross

    # Fixed/invalid pose slots: identity rows/cols, zero rhs.
    free = pose_free  # (W,)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S.at[jnp.arange(W), :, jnp.arange(W), :].add(
        jnp.eye(6)[None] * (1.0 - free)[:, None, None]
    )
    b = b * free[:, None]

    Sd = S.reshape(W * 6, W * 6)
    # S is symmetric positive definite (damped normal equations; fixed
    # slots carry identity rows), so Cholesky replaces LU-with-pivoting —
    # the cheaper factorization for the per-iteration (6W, 6W) solve.
    L = jnp.linalg.cholesky(Sd)
    dxi = -jax.scipy.linalg.cho_solve((L, True), b.reshape(W * 6)).reshape(W, 6)
    # Back-substitute landmarks: dX = -Vinv (gx + Y^T dxi_summed).
    YtdP = jnp.einsum("mwij,wi->mj", Y, dxi)  # (M, 3)
    g2 = gx + YtdP
    dX = -(
        Vinv[:, :, 0] * g2[:, None, 0]
        + Vinv[:, :, 1] * g2[:, None, 1]
        + Vinv[:, :, 2] * g2[:, None, 2]
    )
    return dxi, dX


def _apply_step(T_w2c, points, dxi, dX):
    dR = so3_exp(dxi[:, 3:])  # (W, 3, 3)
    R = T_w2c[:, :3, :3]
    t = T_w2c[:, :3, 3]
    R_new = dR @ R
    t_new = jnp.einsum("wij,wj->wi", dR, t) + dxi[:, :3]
    T_new = T_w2c.at[:, :3, :3].set(R_new).at[:, :3, 3].set(t_new)
    return T_new, points + dX


@partial(jax.jit, static_argnames=("n_iter", "axis_name"))
def bundle_adjust(
    problem: BAProblem,
    n_iter: int = 20,
    huber: float = 5e-3,
    lam0: float = 1e-3,
    axis_name: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, dict]:
    """Run the damped LM loop. Returns (T_w2c', points', info).

    ``huber`` is in normalized-coordinate units (pixels / focal). The
    iteration count is static; accept/reject logic is branch-free selects,
    mirroring classic LM: lambda shrinks x0.5 on improvement, grows x4 on a
    rejected step. ``axis_name`` names a mesh axis sharding the landmark
    dimension (see _solve_step) — use via backend.parallel.
    """
    w_obs = (problem.obs_valid).astype(jnp.float32)
    pose_free = (
        problem.pose_valid & ~problem.pose_fixed
    ).astype(jnp.float32)

    def cost_of(T, X):
        r, _, _, in_front = _residuals_and_jacobians(T, X, problem.uv, w_obs > 0)
        return _cost(r, w_obs, in_front, huber, axis_name=axis_name)

    def body(carry, _):
        T, X, lam, c = carry
        dxi, dX = _solve_step(
            T, X, problem.uv, w_obs, pose_free, lam, huber, axis_name=axis_name
        )
        T_new, X_new = _apply_step(T, X, dxi, dX)
        c_new = cost_of(T_new, X_new)
        accept = c_new < c
        T = jnp.where(accept, T_new, T)
        X = jnp.where(accept, X_new, X)
        c = jnp.where(accept, c_new, c)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-9, 1e6)
        return (T, X, lam, c), c

    c0 = cost_of(problem.T_w2c, problem.points)
    (T, X, lam, c), cs = jax.lax.scan(
        body, (problem.T_w2c, problem.points, jnp.asarray(lam0), c0), None, length=n_iter
    )
    info = {"cost0": c0, "cost": c, "costs": cs, "lambda": lam}
    return T, X, info


def residual_norms(
    T_w2c: jnp.ndarray, points: jnp.ndarray, uv: jnp.ndarray, obs_valid: jnp.ndarray
) -> jnp.ndarray:
    """Per-observation reprojection error norms (M, W) in normalized coords;
    invalid/behind-camera observations get +inf."""
    r, _, _, in_front = _residuals_and_jacobians(T_w2c, points, uv, obs_valid)
    rn = jnp.linalg.norm(r, axis=-1)
    return jnp.where(obs_valid & in_front, rn, jnp.inf)


@partial(jax.jit, static_argnames=("n_iter", "n_iter2"))
def bundle_adjust_robust(
    problem: BAProblem,
    n_iter: int = 10,
    n_iter2: int = 10,
    huber: float = 5e-3,
    lam0: float = 1e-3,
    trim_factor: float = 3.0,
) -> tuple[jnp.ndarray, jnp.ndarray, dict]:
    """Two-stage BA with interim outlier gating (the ORB-SLAM local-BA
    pattern): robust solve, drop observations with residual >
    ``trim_factor * huber``, re-solve on the trimmed set.

    Returns (T, X, info) where info['obs_kept'] is the post-trim mask.
    """
    T, X, info1 = bundle_adjust(problem, n_iter=n_iter, huber=huber, lam0=lam0)
    rn = residual_norms(T, X, problem.uv, problem.obs_valid)
    kept = problem.obs_valid & (rn < trim_factor * huber)
    problem2 = problem._replace(T_w2c=T, points=X, obs_valid=kept)
    T, X, info2 = bundle_adjust(problem2, n_iter=n_iter2, huber=huber, lam0=lam0)
    info = {
        "cost0": info1["cost0"],
        "cost": info2["cost"],
        "obs_kept": kept,
        "n_trimmed": jnp.sum(problem.obs_valid) - jnp.sum(kept),
    }
    return T, X, info


# ---------------------------------------------------------------------------
# Landmark-MINOR dense BA (layout variant)
#
# The (M, W, 2, 6)-shaped intermediates of the solver above put tiny dims
# (2, 6), (6, 3), (3, 3) in the two MINOR axes, which a tiled memory layout
# pads. This variant runs the SAME LM/Schur math with the landmark axis LAST everywhere
# ((W, 2, M), (W, 6, 3, M), (3, 3, M), ...), so every elementwise panel and
# every reduction contracts over a well-tiled minor axis.
# ---------------------------------------------------------------------------


def _residuals_and_jacobians_lm(T_w2c, X, uv_lm, w):
    """Landmark-minor twin of _residuals_and_jacobians.

    X: (3, M) points; uv_lm: (W, 2, M) measurements; w: (W, M) mask.
    Returns r (W, 2, M), Jp (W, 2, 6, M), Jx (W, 2, 3, M), in_front (W, M).
    """
    R = T_w2c[:, :3, :3]  # (W, 3, 3)
    t = T_w2c[:, :3, 3]  # (W, 3)
    pc = jnp.einsum("wab,bm->wam", R, X) + t[..., None]  # (W, 3, M)
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]  # (W, M)
    zs = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    inv_z = 1.0 / zs
    u = x * inv_z
    v = y * inv_z
    r = jnp.stack([u, v], axis=1) - uv_lm  # (W, 2, M)
    zero = jnp.zeros_like(u)
    Ju = jnp.stack([inv_z, zero, -u * inv_z, -u * v, 1.0 + u * u, -v], axis=1)
    Jv = jnp.stack([zero, inv_z, -v * inv_z, -(1.0 + v * v), u * v, u], axis=1)
    Jp = jnp.stack([Ju, Jv], axis=1)  # (W, 2, 6, M)
    # Jx[w, a, c, m] = A[w, a, b, m] R[w, b, c]; A rows built explicitly.
    A0 = jnp.stack([inv_z, zero, -u * inv_z], axis=1)  # (W, 3, M)
    A1 = jnp.stack([zero, inv_z, -v * inv_z], axis=1)
    A = jnp.stack([A0, A1], axis=1)  # (W, 2, 3, M)
    Jx = jnp.einsum("wbc,wabm->wacm", R, A)  # (W, 2, 3, M)
    in_front = z > _EPS
    return r, Jp, Jx, in_front


def _inv3x3_lm(A):
    """Closed-form cofactor inverse in (3, 3, M) layout (minor axis M)."""
    a = A[0, 0]; b = A[0, 1]; c = A[0, 2]
    d = A[1, 0]; e = A[1, 1]; f = A[1, 2]
    g = A[2, 0]; h = A[2, 1]; i = A[2, 2]
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
    inv_det = 1.0 / jnp.where(jnp.abs(det) < _EPS, _EPS, det)
    adj = jnp.stack(
        [
            jnp.stack([c00, c01, c02], axis=0),
            jnp.stack([c10, c11, c12], axis=0),
            jnp.stack([c20, c21, c22], axis=0),
        ],
        axis=0,
    )  # (3, 3, M)
    return adj * inv_det[None, None]


def _cost_lm(r, w_obs, in_front, huber):
    """_cost in (W, 2, M)/(W, M) layout (same cheirality penalty)."""
    rn2 = jnp.sum(r * r, axis=1)  # (W, M)
    rn = jnp.sqrt(rn2 + _EPS)
    quad = 0.5 * rn2
    lin = huber * (rn - 0.5 * huber)
    rho = jnp.where(rn <= huber, quad, lin)
    pen = 20.0 * huber
    return jnp.sum(jnp.where(in_front, rho, pen) * w_obs)


def _solve_step_lm(T_w2c, X, uv_lm, w_obs, pose_free, lam, huber):
    """One LM linear solve in landmark-minor layout: X (3, M), uv_lm
    (W, 2, M), w_obs (W, M). Returns (dxi (W, 6), dX (3, M))."""
    W = uv_lm.shape[0]
    r, Jp, Jx, in_front = _residuals_and_jacobians_lm(T_w2c, X, uv_lm, w_obs > 0)
    rn = jnp.sqrt(jnp.sum(r * r, axis=1))  # (W, M)
    hub = jnp.where(rn <= huber, 1.0, huber / jnp.maximum(rn, _EPS))
    w = w_obs * hub * in_front  # (W, M)
    Jp = Jp * pose_free[:, None, None, None]

    Jpw = Jp * w[:, None, None]  # (W, 2, 6, M)
    U = jnp.einsum("waim,wajm->wij", Jpw, Jp)  # (W, 6, 6)
    V = jnp.einsum("waim,wm,wajm->ijm", Jx, w, Jx)  # (3, 3, M)
    Y = jnp.einsum("waim,wajm->wijm", Jpw, Jx)  # (W, 6, 3, M)
    gp = jnp.einsum("waim,wam->wi", Jpw, r)  # (W, 6)
    gx = jnp.einsum("waim,wm,wam->im", Jx, w, r)  # (3, M)

    U = U + lam * jnp.eye(6)[None]
    V = V + lam * jnp.eye(3)[:, :, None]
    Vinv = _inv3x3_lm(V)  # (3, 3, M)

    T_blk = jnp.einsum("wijm,jkm->wikm", Y, Vinv)  # (W, 6, 3, M)
    S_cross = jnp.einsum("uikm,vjkm->uivj", T_blk, Y)  # (W, 6, W, 6)
    b_local = -jnp.einsum("wikm,km->wi", T_blk, gx)  # (W, 6)
    b = gp + b_local
    S = jnp.zeros((W, 6, W, 6)).at[jnp.arange(W), :, jnp.arange(W), :].add(U) - S_cross

    free = pose_free
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S.at[jnp.arange(W), :, jnp.arange(W), :].add(
        jnp.eye(6)[None] * (1.0 - free)[:, None, None]
    )
    b = b * free[:, None]

    Sd = S.reshape(W * 6, W * 6)
    L = jnp.linalg.cholesky(Sd)
    dxi = -jax.scipy.linalg.cho_solve((L, True), b.reshape(W * 6)).reshape(W, 6)
    YtdP = jnp.einsum("wijm,wi->jm", Y, dxi)  # (3, M)
    dX = -jnp.einsum("ijm,jm->im", Vinv, gx + YtdP)
    return dxi, dX


@partial(jax.jit, static_argnames=("n_iter",))
def bundle_adjust_lm(
    problem: BAProblem,
    n_iter: int = 20,
    huber: float = 5e-3,
    lam0: float = 1e-3,
) -> tuple[jnp.ndarray, jnp.ndarray, dict]:
    """``bundle_adjust`` with the landmark-minor solver. Identical inputs,
    outputs, and LM control flow; only the on-device data layout differs
    (results match to f32 summation-order noise — parity-tested)."""
    w_obs = problem.obs_valid.astype(jnp.float32).T  # (W, M)
    uv_lm = jnp.transpose(problem.uv, (1, 2, 0))  # (W, 2, M)
    pose_free = (problem.pose_valid & ~problem.pose_fixed).astype(jnp.float32)

    def cost_of(T, X):
        r, _, _, in_front = _residuals_and_jacobians_lm(T, X, uv_lm, w_obs > 0)
        return _cost_lm(r, w_obs, in_front, huber)

    def body(carry, _):
        T, X, lam, c = carry
        dxi, dX = _solve_step_lm(T, X, uv_lm, w_obs, pose_free, lam, huber)
        T_new, X_new = _apply_step(T, X.T, dxi, dX.T)
        X_new = X_new.T
        c_new = cost_of(T_new, X_new)
        accept = c_new < c
        T = jnp.where(accept, T_new, T)
        X = jnp.where(accept, X_new, X)
        c = jnp.where(accept, c_new, c)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-9, 1e6)
        return (T, X, lam, c), c

    X0 = problem.points.T  # (3, M)
    c0 = cost_of(problem.T_w2c, X0)
    (T, X, lam, c), cs = jax.lax.scan(
        body, (problem.T_w2c, X0, jnp.asarray(lam0), c0), None, length=n_iter
    )
    info = {"cost0": c0, "cost": c, "costs": cs, "lambda": lam}
    return T, X.T, info


@partial(jax.jit, static_argnames=("n_iter", "n_iter2"))
def bundle_adjust_robust_lm(
    problem: BAProblem,
    n_iter: int = 10,
    n_iter2: int = 10,
    huber: float = 5e-3,
    lam0: float = 1e-3,
    trim_factor: float = 3.0,
) -> tuple[jnp.ndarray, jnp.ndarray, dict]:
    """``bundle_adjust_robust`` on the landmark-minor solver (same two-stage
    trim; the interim residual pass also runs in the fast layout)."""
    T, X, info1 = bundle_adjust_lm(problem, n_iter=n_iter, huber=huber, lam0=lam0)
    uv_lm = jnp.transpose(problem.uv, (1, 2, 0))
    r, _, _, in_front = _residuals_and_jacobians_lm(
        T, X.T, uv_lm, problem.obs_valid.T
    )
    rn = jnp.sqrt(jnp.sum(r * r, axis=1)).T  # (M, W)
    rn = jnp.where(problem.obs_valid & in_front.T, rn, jnp.inf)
    kept = problem.obs_valid & (rn < trim_factor * huber)
    problem2 = problem._replace(T_w2c=T, points=X, obs_valid=kept)
    T, X, info2 = bundle_adjust_lm(problem2, n_iter=n_iter2, huber=huber, lam0=lam0)
    info = {
        "cost0": info1["cost0"],
        "cost": info2["cost"],
        "obs_kept": kept,
        "n_trimmed": jnp.sum(problem.obs_valid) - jnp.sum(kept),
    }
    return T, X, info


# ---------------------------------------------------------------------------
# Sparse landmark-major BA
#
# The dense (M, W) grid above is ~97-98 % empty at SLAM map density (a
# landmark is observed by a handful of keyframes, not the whole window), and
# its Schur cross term ``muik,mvjk->uivj`` is O(M W^2) — the dominant device
# cost of every boundary solve once W reaches the 32/64 bucket floors.
# The sparse layout stores K observation SLOTS per landmark (pose index +
# measurement), so residuals/Jacobians/V/Y cost O(M K) instead of O(M W);
# pose-indexed reductions fold a one-hot indicator into dense einsums
# (matmuls instead of segment_sum scatters). The Schur cross term is
# scattered to dense per-pose slots and contracted in one (W6, M3)x(M3, W6)
# matmul, so it stays O(M W^2) like the dense solver; the win is the K-axis
# terms and the (M, K) working set. Same LM/Schur math, same info dict.
# ---------------------------------------------------------------------------


class BASparse(NamedTuple):
    """Fixed-capacity landmark-major bundle-adjustment window.

    Each landmark carries up to K observation slots; ``obs_pose`` holds the
    keyframe slot index of each observation (0 where invalid — the weight
    masks it out, the scatter lands harmlessly on slot 0).
    """

    T_w2c: jnp.ndarray  # (W, 4, 4) keyframe poses, world -> camera
    points: jnp.ndarray  # (M, 3) landmark positions (world)
    uv: jnp.ndarray  # (M, K, 2) normalized observations
    obs_pose: jnp.ndarray  # (M, K) int32 pose-slot index per observation
    obs_valid: jnp.ndarray  # (M, K) bool
    pose_valid: jnp.ndarray  # (W,) bool
    pose_fixed: jnp.ndarray  # (W,) bool

    @property
    def n_poses(self) -> int:
        return self.T_w2c.shape[0]

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @classmethod
    def from_dense(cls, problem: BAProblem, k_slots: int) -> "BASparse":
        """Re-layout a dense (M, W) problem into ``k_slots`` observation
        slots per landmark, keeping each landmark's first ``k_slots``
        observations in keyframe order (host-side numpy)."""
        import numpy as np

        valid = np.asarray(problem.obs_valid)
        uv = np.asarray(problem.uv)
        M = valid.shape[0]
        s_uv = np.zeros((M, k_slots, 2), np.float32)
        s_pose = np.zeros((M, k_slots), np.int32)
        s_valid = np.zeros((M, k_slots), bool)
        for i in range(M):
            js = np.nonzero(valid[i])[0][:k_slots]
            s_uv[i, : len(js)] = uv[i, js]
            s_pose[i, : len(js)] = js
            s_valid[i, : len(js)] = True
        return cls(
            T_w2c=problem.T_w2c, points=problem.points, uv=jnp.asarray(s_uv),
            obs_pose=jnp.asarray(s_pose), obs_valid=jnp.asarray(s_valid),
            pose_valid=problem.pose_valid, pose_fixed=problem.pose_fixed,
        )


def _pose_onehot(obs_pose, W, dtype=jnp.float32):
    """(M, K, W) one-hot pose indicator — the gather-free access path to
    per-observation pose data. Constant across LM iterations: build ONCE
    per solve, outside the scan."""
    return jax.nn.one_hot(obs_pose, W, dtype=dtype)


def _residuals_and_jacobians_sparse(T_w2c, points, uv, onehot):
    """Sparse counterpart of :func:`_residuals_and_jacobians`; shapes are
    (M, K, ...). Pose blocks arrive via one-hot contraction instead of
    ``T_w2c[obs_pose]``: tiny unaligned gathers of 3x3 blocks lowered to a
    serial per-element loop on earlier hardware, while the one-hot matmul
    is a plain contraction on any backend."""
    Rg = jnp.einsum("mkw,wab->mkab", onehot, T_w2c[:, :3, :3])  # (M, K, 3, 3)
    tg = jnp.einsum("mkw,wa->mka", onehot, T_w2c[:, :3, 3])  # (M, K, 3)
    pc = jnp.einsum("mkab,mb->mka", Rg, points) + tg
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    inv_z = 1.0 / zs
    u = x * inv_z
    v = y * inv_z
    r = jnp.stack([u, v], axis=-1) - uv  # (M, K, 2)
    zero = jnp.zeros_like(u)
    Ju = jnp.stack([inv_z, zero, -u * inv_z, -u * v, 1.0 + u * u, -v], axis=-1)
    Jv = jnp.stack([zero, inv_z, -v * inv_z, -(1.0 + v * v), u * v, u], axis=-1)
    Jp = jnp.stack([Ju, Jv], axis=-2)  # (M, K, 2, 6)
    A = jnp.stack(
        [
            jnp.stack([inv_z, zero, -u * inv_z], axis=-1),
            jnp.stack([zero, inv_z, -v * inv_z], axis=-1),
        ],
        axis=-2,
    )  # (M, K, 2, 3)
    Jx = jnp.einsum("mkab,mkbc->mkac", A, Rg)  # (M, K, 2, 3)
    in_front = z > _EPS
    return r, Jp, Jx, in_front


def _solve_step_sparse(
    T_w2c, points, uv, onehot, pf_obs, w_obs, pose_free, lam, huber,
    axis_name=None,
):
    """One LM linear solve on the sparse layout: returns (dxi, dX).

    GATHER-FREE: every ``[obs_pose]`` access (pose blocks, pose_free mask,
    back-substituted dxi) is a one-hot contraction instead of a tiny
    unaligned gather. Pose-indexed reductions (U, gp, S_cross, b) fold the
    same ONE-HOT indicator into dense einsums instead of
    ``jax.ops.segment_sum``, whose ~1M-element scatter can serialize, while
    the one-hot contraction is a plain matmul. Landmark blocks (V, gx,
    back-subst) reduce locally over the K axis; 3-wide contractions are
    unrolled to broadcast multiply-adds (same relowering as the dense
    solver). With ``axis_name``, the landmark axis is sharded exactly as in
    the dense solver (psum completes pose blocks)."""
    M, K = uv.shape[:2]
    W = T_w2c.shape[0]
    r, Jp, Jx, in_front = _residuals_and_jacobians_sparse(
        T_w2c, points, uv, onehot
    )
    w = w_obs * _robust_weights(r, huber) * in_front  # (M, K)
    Jp = Jp * pf_obs[..., None, None]
    Jpw = Jp * w[..., None, None]
    Jxw = Jx * w[..., None, None]

    U = jnp.einsum("mkai,mkaj,mkw->wij", Jpw, Jp, onehot)  # (W, 6, 6)
    gp = jnp.einsum("mkai,mka,mkw->wi", Jpw, r, onehot)  # (W, 6)
    V = jnp.einsum("mkai,mkaj->mij", Jxw, Jx)  # (M, 3, 3)
    gx = jnp.einsum("mkai,mka->mi", Jxw, r)  # (M, 3)
    # Y (M, K, 6, 3): unroll the 2-wide residual axis.
    Y = (
        Jpw[:, :, 0, :, None] * Jx[:, :, 0, None, :]
        + Jpw[:, :, 1, :, None] * Jx[:, :, 1, None, :]
    )

    if axis_name is not None:
        U = jax.lax.psum(U, axis_name)
        gp = jax.lax.psum(gp, axis_name)

    U = U + lam * jnp.eye(6)[None]
    V = V + lam * jnp.eye(3)[None]
    Vinv = _inv3x3(V)  # (M, 3, 3), closed form

    # T_blk = Y @ Vinv per observation: unroll the 3-wide contraction.
    T_blk = (
        Y[:, :, :, 0, None] * Vinv[:, None, None, 0, :]
        + Y[:, :, :, 1, None] * Vinv[:, None, None, 1, :]
        + Y[:, :, :, 2, None] * Vinv[:, None, None, 2, :]
    )  # (M, K, 6, 3)
    # Cross blocks: scatter each landmark's K observation blocks into dense
    # per-pose slots via the one-hot matmul, then contract landmarks away in
    # ONE big (W6, M3) x (M3, W6) matmul. Versus the pairwise (M, K, K)
    # form + pair segment_sum this trades O(M K^2) "ideal" FLOPs for
    # O(M W^2) matmul FLOPs and no scatter (same trade as the dense
    # solver's cross term).
    Tb_w = jnp.einsum("mkil,mkw->mwil", T_blk, onehot)  # (M, W, 6, 3)
    Y_w = jnp.einsum("mkjl,mkw->mwjl", Y, onehot)  # (M, W, 6, 3)
    S_cross = jnp.einsum("muil,mvjl->uivj", Tb_w, Y_w)  # (W, 6, W, 6)
    b_local = -jnp.einsum("mkil,ml,mkw->wi", T_blk, gx, onehot)  # (W, 6)
    if axis_name is not None:
        S_cross = jax.lax.psum(S_cross, axis_name)
        b_local = jax.lax.psum(b_local, axis_name)
    b = gp + b_local
    S = jnp.zeros((W, 6, W, 6)).at[jnp.arange(W), :, jnp.arange(W), :].add(U) - S_cross

    free = pose_free
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S = S.at[jnp.arange(W), :, jnp.arange(W), :].add(
        jnp.eye(6)[None] * (1.0 - free)[:, None, None]
    )
    b = b * free[:, None]

    Sd = S.reshape(W * 6, W * 6)
    # S is symmetric positive definite (damped normal equations; fixed
    # slots carry identity rows), so Cholesky replaces LU-with-pivoting —
    # the cheaper factorization for the per-iteration (6W, 6W) solve.
    L = jnp.linalg.cholesky(Sd)
    dxi = -jax.scipy.linalg.cho_solve((L, True), b.reshape(W * 6)).reshape(W, 6)
    dxi_obs = jnp.einsum("mkw,wi->mki", onehot, dxi)  # gather-free dxi[obs_pose]
    YtdP = jnp.einsum("mkij,mki->mj", Y, dxi_obs)  # (M, 3)
    g2 = gx + YtdP
    dX = -(
        Vinv[:, :, 0] * g2[:, None, 0]
        + Vinv[:, :, 1] * g2[:, None, 1]
        + Vinv[:, :, 2] * g2[:, None, 2]
    )
    return dxi, dX


@partial(jax.jit, static_argnames=("n_iter", "axis_name"))
def bundle_adjust_sparse(
    problem: BASparse,
    n_iter: int = 20,
    huber: float = 5e-3,
    lam0: float = 1e-3,
    axis_name: str | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, dict]:
    """Damped LM loop on the sparse layout — same semantics and info dict as
    :func:`bundle_adjust`."""
    w_obs = problem.obs_valid.astype(jnp.float32)
    pose_free = (problem.pose_valid & ~problem.pose_fixed).astype(jnp.float32)
    # Constant across LM iterations: build ONCE, outside the scan.
    onehot = _pose_onehot(problem.obs_pose, problem.T_w2c.shape[0])
    pf_obs = jnp.einsum("mkw,w->mk", onehot, pose_free)

    def cost_of(T, X):
        r, _, _, in_front = _residuals_and_jacobians_sparse(
            T, X, problem.uv, onehot
        )
        return _cost(r, w_obs, in_front, huber, axis_name=axis_name)

    def body(carry, _):
        T, X, lam, c = carry
        dxi, dX = _solve_step_sparse(
            T, X, problem.uv, onehot, pf_obs, w_obs, pose_free, lam, huber,
            axis_name=axis_name,
        )
        T_new, X_new = _apply_step(T, X, dxi, dX)
        c_new = cost_of(T_new, X_new)
        accept = c_new < c
        T = jnp.where(accept, T_new, T)
        X = jnp.where(accept, X_new, X)
        c = jnp.where(accept, c_new, c)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-9, 1e6)
        return (T, X, lam, c), c

    c0 = cost_of(problem.T_w2c, problem.points)
    (T, X, lam, c), cs = jax.lax.scan(
        body, (problem.T_w2c, problem.points, jnp.asarray(lam0), c0), None,
        length=n_iter,
    )
    info = {"cost0": c0, "cost": c, "costs": cs, "lambda": lam}
    return T, X, info


def residual_norms_sparse(
    T_w2c: jnp.ndarray,
    points: jnp.ndarray,
    uv: jnp.ndarray,
    obs_pose: jnp.ndarray,
    obs_valid: jnp.ndarray,
) -> jnp.ndarray:
    """Per-observation reprojection error norms (M, K); invalid or
    behind-camera observations get +inf."""
    r, _, _, in_front = _residuals_and_jacobians_sparse(
        T_w2c, points, uv, _pose_onehot(obs_pose, T_w2c.shape[0])
    )
    rn = jnp.linalg.norm(r, axis=-1)
    return jnp.where(obs_valid & in_front, rn, jnp.inf)


@partial(jax.jit, static_argnames=("n_iter", "n_iter2"))
def bundle_adjust_robust_sparse(
    problem: BASparse,
    n_iter: int = 10,
    n_iter2: int = 10,
    huber: float = 5e-3,
    lam0: float = 1e-3,
    trim_factor: float = 3.0,
) -> tuple[jnp.ndarray, jnp.ndarray, dict]:
    """Two-stage BA with interim outlier gating — sparse counterpart of
    :func:`bundle_adjust_robust`; info['obs_kept'] is (M, K)."""
    T, X, info1 = bundle_adjust_sparse(problem, n_iter=n_iter, huber=huber, lam0=lam0)
    rn = residual_norms_sparse(T, X, problem.uv, problem.obs_pose, problem.obs_valid)
    kept = problem.obs_valid & (rn < trim_factor * huber)
    problem2 = problem._replace(T_w2c=T, points=X, obs_valid=kept)
    T, X, info2 = bundle_adjust_sparse(problem2, n_iter=n_iter2, huber=huber, lam0=lam0)
    info = {
        "cost0": info1["cost0"],
        "cost": info2["cost"],
        "obs_kept": kept,
        "n_trimmed": jnp.sum(problem.obs_valid) - jnp.sum(kept),
    }
    return T, X, info


def mean_reprojection_error(
    T_w2c: jnp.ndarray,
    points: jnp.ndarray,
    uv: jnp.ndarray,
    obs_valid: jnp.ndarray,
    focal: float = 1.0,
) -> jnp.ndarray:
    """Masked mean reprojection error over the window, in pixels if ``focal``
    is the focal length (reference Map.compute_mean_reprojection_error,
    map.py:97-141)."""
    r, _, _, in_front = _residuals_and_jacobians(T_w2c, points, uv, obs_valid)
    rn = jnp.linalg.norm(r, axis=-1) * focal
    w = obs_valid & in_front
    n = jnp.maximum(jnp.sum(w), 1)
    return jnp.sum(jnp.where(w, rn, 0.0)) / n
