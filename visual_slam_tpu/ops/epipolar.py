"""Two-view epipolar geometry: essential/fundamental estimation with
fixed-budget vmapped RANSAC and cheirality-based pose recovery. Pure JAX.

Device replacement for cv2.findEssentialMat + cv2.recoverPose
(reference: visual_slam/utils/motion_estimation.py:11-50) and the
cv2.findFundamentalMat RANSAC match filter (visual_slam/utils/matching.py:93-140).

Design: OpenCV's adaptive RANSAC becomes a *fixed* batch of N_HYP hypotheses —
each hypothesis samples a minimal set, fits a model with the normalized
8-point algorithm, and scores all correspondences by Sampson distance; the
best-scoring model wins and is re-fit on its inliers.  The whole procedure is
one jitted, branch-free program: `vmap` over hypotheses, `argmax` selection.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .lie import make_T
from .linalg import nullspace_vector
from .triangulation import triangulate_dlt, projection_from_T

_EPS = 1e-9


def _hartley_normalize(x: jnp.ndarray, w: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Weighted Hartley normalization: translate to centroid, scale mean
    distance to sqrt(2). Returns (x_norm, S) with x_h_norm = S @ x_h."""
    wsum = jnp.maximum(jnp.sum(w), _EPS)
    mean = jnp.sum(x * w[:, None], axis=0) / wsum
    d = jnp.sqrt(jnp.sum((x - mean) ** 2, axis=-1) + _EPS)
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.sum(d * w) / wsum, _EPS)
    S = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype=x.dtype
    )
    S = S.at[0, 0].set(scale).at[1, 1].set(scale)
    S = S.at[0, 2].set(-scale * mean[0]).at[1, 2].set(-scale * mean[1])
    return (x - mean) * scale, S


def eight_point(
    x1: jnp.ndarray, x2: jnp.ndarray, w: jnp.ndarray, essential: bool = True
) -> jnp.ndarray:
    """Weighted normalized 8-point algorithm.

    Args:
      x1, x2: (N, 2) correspondences (normalized camera coords for E,
        pixels for F). N can be the minimal 8 or a full inlier set.
      w: (N,) weights in [0, 1] — soft mask; rows with w=0 don't contribute.
      essential: project onto the essential manifold (sv -> (1,1,0)) instead
        of rank-2 fundamental (sv -> (s1,s2,0)).

    Returns (3, 3) matrix with x2_h^T M x1_h = 0.
    """
    x1n, S1 = _hartley_normalize(x1, w)
    x2n, S2 = _hartley_normalize(x2, w)
    u1, v1 = x1n[:, 0], x1n[:, 1]
    u2, v2 = x2n[:, 0], x2n[:, 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=-1)
    AtA = (A * w[:, None]).T @ A  # (9, 9)
    # ops/linalg.nullspace_vector picks the solver per backend.
    f = nullspace_vector(AtA)
    Fn = f.reshape(3, 3)
    # Denormalize first: the similarity transforms do not preserve singular
    # values, so the manifold projection must happen in the original frame.
    F = S2.T @ Fn @ S1
    U, s, Vt = jnp.linalg.svd(F)
    if essential:
        s_new = jnp.array([1.0, 1.0, 0.0], dtype=s.dtype)
    else:
        s_new = s.at[2].set(0.0)
    F = (U * s_new[None, :]) @ Vt
    norm = jnp.linalg.norm(F) + _EPS
    return F / norm


def sampson_error(M: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """First-order geometric (Sampson) distance of x2^T M x1 = 0. (N,)"""
    x1h = jnp.concatenate([x1, jnp.ones_like(x1[..., :1])], axis=-1)
    x2h = jnp.concatenate([x2, jnp.ones_like(x2[..., :1])], axis=-1)
    Mx1 = x1h @ M.T  # (N, 3)
    Mtx2 = x2h @ M  # (N, 3)
    num = jnp.sum(x2h * Mx1, axis=-1) ** 2
    den = Mx1[..., 0] ** 2 + Mx1[..., 1] ** 2 + Mtx2[..., 0] ** 2 + Mtx2[..., 1] ** 2
    return num / jnp.maximum(den, _EPS)


def _sample_minimal_sets(
    key: jax.Array, mask: jnp.ndarray, n_hyp: int, set_size: int
) -> jnp.ndarray:
    """(n_hyp, set_size) indices drawn from entries where mask is True.

    Sampling with replacement within a set is possible but rare and merely
    yields a degenerate hypothesis that loses the score argmax — acceptable in
    a fixed-budget RANSAC.
    """
    logits = jnp.where(mask, 0.0, -1e9)
    return jax.random.categorical(key, logits[None, :], shape=(n_hyp, set_size))


@partial(jax.jit, static_argnames=("n_hyp",))
def ransac_essential(
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    mask: jnp.ndarray,
    key: jax.Array,
    n_hyp: int = 256,
    thresh: float = 3e-3,
) -> dict:
    """Fixed-budget RANSAC for the essential matrix on normalized coords.

    Mirrors cv2.findEssentialMat(USAC_MSAC, threshold=0.003) as used by the
    reference (motion_estimation.py:26-38), with the adaptive loop replaced by
    ``n_hyp`` parallel hypotheses (one vmapped 8-point solve each).

    Returns dict(E, inliers (N,) bool, n_inliers, score).
    """
    n = x1.shape[0]
    keys = jax.random.split(key, 2)
    idx = _sample_minimal_sets(keys[0], mask, n_hyp, 8)  # (H, 8)

    def fit(sample_idx):
        s1 = x1[sample_idx]
        s2 = x2[sample_idx]
        w = jnp.ones(8, dtype=x1.dtype)
        return eight_point(s1, s2, w, essential=True)

    Es = jax.vmap(fit)(idx)  # (H, 3, 3)
    t2 = thresh * thresh

    # Per-hypothesis local optimization: minimal 8-point fits amplify noise
    # heavily, so anneal EVERY hypothesis with wide->narrow inlier refits
    # before scoring.  This is the fixed-shape version of LO-RANSAC — the
    # local optimization is vmapped across the whole hypothesis batch.
    def local_opt(E):
        for factor in (64.0, 16.0, 4.0, 1.0):
            inl = (sampson_error(E, x1, x2) < factor * t2) & mask
            E = eight_point(x1, x2, inl.astype(x1.dtype), essential=True)
        return E

    Es = jax.vmap(local_opt)(Es)
    errs = jax.vmap(lambda E: sampson_error(E, x1, x2))(Es)  # (H, N)
    # MSAC score: truncated quadratic cost (lower = better).
    cost = jnp.where(mask[None, :], jnp.minimum(errs, t2), 0.0).sum(axis=-1)
    best = jnp.argmin(cost)
    E = Es[best]
    inliers = (sampson_error(E, x1, x2) < t2) & mask
    return {
        "E": E,
        "inliers": inliers,
        "n_inliers": jnp.sum(inliers),
        "score": cost[best],
    }


@partial(jax.jit, static_argnames=("n_hyp",))
def ransac_fundamental(
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    mask: jnp.ndarray,
    key: jax.Array,
    n_hyp: int = 128,
    thresh: float = 1.0,
) -> dict:
    """RANSAC fundamental matrix on *pixel* coords — the geometric match
    filter (reference matching.py:93-140, cv2.findFundamentalMat USAC_MSAC,
    ransacReprojThreshold default 1.0)."""
    idx = _sample_minimal_sets(key, mask, n_hyp, 8)

    def fit(sample_idx):
        w = jnp.ones(8, dtype=x1.dtype)
        return eight_point(x1[sample_idx], x2[sample_idx], w, essential=False)

    Fs = jax.vmap(fit)(idx)
    t2 = thresh * thresh

    def local_opt(F):
        for factor in (64.0, 16.0, 4.0, 1.0):
            inl = (sampson_error(F, x1, x2) < factor * t2) & mask
            F = eight_point(x1, x2, inl.astype(x1.dtype), essential=False)
        return F

    Fs = jax.vmap(local_opt)(Fs)
    errs = jax.vmap(lambda F: sampson_error(F, x1, x2))(Fs)
    cost = jnp.where(mask[None, :], jnp.minimum(errs, t2), 0.0).sum(axis=-1)
    best = jnp.argmin(cost)
    F = Fs[best]
    inliers = (sampson_error(F, x1, x2) < t2) & mask
    return {"F": F, "inliers": inliers, "n_inliers": jnp.sum(inliers)}


def decompose_essential(E: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """E -> 4 candidate (R, t) pairs: (4, 3, 3) and (4, 3). ||t|| = 1."""
    U, _, Vt = jnp.linalg.svd(E)
    # Ensure proper rotations.
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def recover_pose(
    E: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray, mask: jnp.ndarray
) -> dict:
    """Select the (R, t) with maximal cheirality support — the fixed-shape
    analogue of cv2.recoverPose (reference motion_estimation.py:40-45).

    Convention matches the reference: returned (R, t) is T_ref->cur, i.e.
    x2 ~ R x1 + t, with camera 1 at the origin.

    Returns dict(R, t, T (4,4), good (N,) cheirality mask for the winner).
    """
    Rs, ts = decompose_essential(E)
    P1 = jnp.concatenate([jnp.eye(3, dtype=E.dtype), jnp.zeros((3, 1), E.dtype)], axis=1)

    def score(R, t):
        T2 = make_T(R, t)
        P2 = projection_from_T(T2)
        pts, w_ok = triangulate_dlt(P1, P2, x1, x2)
        z1 = pts[:, 2]
        z2 = pts @ R[2] + t[2]
        good = w_ok & (z1 > 0) & (z2 > 0) & mask
        return jnp.sum(good), good, pts

    counts, goods, ptss = jax.vmap(score)(Rs, ts)
    k = jnp.argmax(counts)
    return {
        "R": Rs[k],
        "t": ts[k],
        "T": make_T(Rs[k], ts[k]),
        "good": goods[k],
        "pts3d": ptss[k],
        "n_good": counts[k],
    }


def estimate_motion_2d2d(
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    mask: jnp.ndarray,
    key: jax.Array,
    n_hyp: int = 256,
    thresh: float = 3e-3,
) -> dict:
    """Full 2D-2D relative-motion pipeline: RANSAC-E + pose recovery.

    Mirrors the reference's estimate_motion_from_2d2d
    (motion_estimation.py:11-50): returns R, t (T_ref->cur), inlier mask.
    """
    res = ransac_essential(x1, x2, mask, key, n_hyp=n_hyp, thresh=thresh)
    pose = recover_pose(res["E"], x1, x2, res["inliers"])
    return {
        "R": pose["R"],
        "t": pose["t"],
        "T": pose["T"],
        "E": res["E"],
        "inliers": pose["good"],
        "n_inliers": pose["n_good"],
    }
