"""The XLA matching and patch paths against plain numpy references: the
brute-force Hamming matcher, its batched loop-detection form, the
projection-guided matcher's tie-breaks, and the ORB patch gather."""
import numpy as np
import jax.numpy as jnp
import pytest

from visual_slam_tpu.ops import matching as m_ops

BIG = m_ops.BIG


def _packed(rng, k):
    return rng.integers(0, 2**32, (k, 8), dtype=np.uint32)


def _hamming_np(d1, d2, v1, v2):
    bits1 = np.unpackbits(d1.view(np.uint8), axis=-1).astype(np.int64)
    bits2 = np.unpackbits(d2.view(np.uint8), axis=-1).astype(np.int64)
    d = (bits1[:, None, :] != bits2[None, :, :]).sum(-1).astype(np.float64)
    return np.where(v1[:, None] & v2[None, :], d, BIG)


def _match_np(d1, d2, v1, v2, ratio=0.75):
    """Lowe ratio + cross-check + unique-train, first-index tie-breaks."""
    D = _hamming_np(d1, d2, v1, v2)
    ti = np.argmin(D, axis=1)
    rows = np.arange(len(d1))
    best = D[rows, ti]
    masked = D.copy()
    masked[rows, ti] = np.inf
    second = masked.min(axis=1)
    ok = (best < BIG * 0.5) & (best < ratio * second)
    ok &= np.argmin(D, axis=0)[ti] == rows
    for j in np.unique(ti[ok]):
        q = np.nonzero(ok & (ti == j))[0]
        keep = q[np.argmin(best[q])]
        ok[q[q != keep]] = False
    return ti, best, ok


def test_match_descriptors_self_identity(rng):
    d = _packed(rng, 200)
    v = np.ones(200, bool)
    out = m_ops.match_descriptors(d, d, v, v, ratio=0.9)
    assert np.asarray(out["valid"]).all()
    np.testing.assert_array_equal(np.asarray(out["train_idx"]), np.arange(200))
    np.testing.assert_array_equal(np.asarray(out["distance"]), 0)


@pytest.mark.parametrize("k1,k2", [(300, 257), (129, 77)])
def test_match_descriptors_vs_numpy(rng, k1, k2):
    d1 = _packed(rng, k1)
    # Half the queries have a noisy true match among the train rows.
    d2 = _packed(rng, k2)
    n_true = min(k1, k2) // 2
    flips = (rng.random((n_true, 8, 32)) < 0.05).astype(np.uint32)
    noise = np.sum(flips << np.arange(32, dtype=np.uint32), -1, dtype=np.uint32)
    d2[:n_true] = d1[:n_true] ^ noise
    v1 = rng.random(k1) > 0.1
    v2 = rng.random(k2) > 0.1
    out = m_ops.match_descriptors(d1, d2, v1, v2)
    ti, best, ok = _match_np(d1, d2, v1, v2)
    assert ok.sum() > 10
    np.testing.assert_array_equal(np.asarray(out["valid"]), ok)
    np.testing.assert_array_equal(np.asarray(out["train_idx"])[ok], ti[ok])
    np.testing.assert_array_equal(np.asarray(out["distance"])[ok], best[ok])


def test_match_descriptors_batched_equals_per_candidate(rng):
    k, C = 160, 3
    dq = _packed(rng, k)
    vq = rng.random(k) > 0.1
    aq = rng.uniform(0, 2 * np.pi, k).astype(np.float32)
    dc = np.stack([np.where(rng.random((k, 1)) < 0.5, dq, _packed(rng, k)) for _ in range(C)])
    vc = rng.random((C, k)) > 0.1
    ac = rng.uniform(0, 2 * np.pi, (C, k)).astype(np.float32)
    out = m_ops.match_descriptors_batched(dq, dc, vq, vc, aq, ac)
    for c in range(C):
        ref = m_ops.match_descriptors(dq, dc[c], vq, vc[c], aq, ac[c],
                                      use_orientation=True)
        for key in ("train_idx", "distance", "valid", "n_matches"):
            np.testing.assert_array_equal(np.asarray(out[key][c]), np.asarray(ref[key]))
    assert int(np.asarray(out["n_matches"]).sum()) > 0


def _guided_np(uv, visible, lm_desc, kp_xy, kp_desc, kp_valid, radius,
               ratio=0.8, max_distance=80.0):
    """Keypoint-aligned guided association: per landmark the best keypoint
    inside the radius (ratio + absolute gate), then per keypoint the
    lowest-distance landmark, ties toward the lower landmark index."""
    D = _hamming_np(lm_desc, kp_desc, visible, kp_valid)
    d2 = ((uv[:, None, :] - kp_xy[None, :, :]) ** 2).sum(-1)
    D = np.where(d2 <= radius * radius, D, BIG)
    kp_of_lm = np.argmin(D, axis=1)
    rows = np.arange(len(D))
    best = D[rows, kp_of_lm]
    masked = D.copy()
    masked[rows, kp_of_lm] = np.inf
    ok = (best < BIG * 0.5) & (best <= max_distance) & (best < ratio * masked.min(1))
    lm_idx = np.zeros(len(kp_xy), np.int64)
    valid = np.zeros(len(kp_xy), bool)
    for j in range(len(kp_xy)):
        cand = np.nonzero(ok & (kp_of_lm == j))[0]
        if len(cand):
            dmin = best[cand].min()
            lm_idx[j] = cand[best[cand] == dmin].min()
            valid[j] = True
    return lm_idx, valid & kp_valid


def test_guided_match_tiebreak_vs_numpy(rng):
    """Integer Hamming makes every decision exact, so lm_idx/valid agree
    exactly, including distance ties (duplicated landmark descriptors)
    broken toward the lower landmark index."""
    from visual_slam_tpu.ops.guided_matching import guided_match
    from visual_slam_tpu.ops.projection import project_points

    M, Kp = 300, 200
    W, H, F = 320.0, 240.0, 260.0
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]], np.float32)
    T = np.eye(4, dtype=np.float32)
    lm_pos = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M),
                       rng.uniform(4, 30, M)], 1).astype(np.float32)
    lm_desc = _packed(rng, M)
    lm_desc[1:60:2] = lm_desc[0:60:2]  # 30 pairs of equal descriptors
    lm_valid = rng.random(M) > 0.1
    kp_xy = np.stack([rng.uniform(0, W, Kp), rng.uniform(0, H, Kp)], 1).astype(np.float32)
    kp_desc = _packed(rng, Kp)
    uv, z = (np.asarray(a) for a in project_points(jnp.asarray(K), jnp.asarray(T),
                                                     jnp.asarray(lm_pos)))
    for j in range(0, 120, 3):
        kp_desc[j % Kp] = lm_desc[j]
        kp_xy[j % Kp] = uv[j] + rng.uniform(-5, 5, 2)
    kp_valid = rng.random(Kp) > 0.1
    radius = 12.0
    out = guided_match(lm_pos, lm_desc, lm_valid, T, K, kp_xy, kp_desc,
                       kp_valid, W, H, radius_px=radius)
    visible = (lm_valid & (z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
               & (uv[:, 1] >= 0) & (uv[:, 1] < H))
    lm_idx, valid = _guided_np(uv, visible, lm_desc, kp_xy, kp_desc, kp_valid, radius)
    assert valid.sum() > 10  # the fixture actually matches
    np.testing.assert_array_equal(np.asarray(out["valid"]), valid)
    np.testing.assert_array_equal(np.asarray(out["lm_idx"])[valid], lm_idx[valid])
    np.testing.assert_array_equal(np.asarray(out["pts3d"])[valid], lm_pos[lm_idx[valid]])


def test_extract_patches_vs_numpy_slicing(rng):
    from visual_slam_tpu.ops.orb import PATCH, RADIUS, extract_patches

    img = rng.uniform(0, 255, (90, 130)).astype(np.float32)
    yx = np.stack([rng.integers(0, 90, 40), rng.integers(0, 130, 40)], 1).astype(np.int32)
    got = np.asarray(extract_patches(jnp.asarray(img), jnp.asarray(yx)))
    padded = np.pad(img, RADIUS + 1, mode="edge")
    for i, (y, x) in enumerate(yx):
        ref = padded[y + 1:y + 1 + PATCH, x + 1:x + 1 + PATCH]
        np.testing.assert_array_equal(got[i], ref)
    # Interior keypoints see the plain image window.
    y, x = 40, 60
    inner = np.asarray(extract_patches(jnp.asarray(img), jnp.asarray([[y, x]], np.int32)))[0]
    np.testing.assert_array_equal(inner, img[y - RADIUS:y + RADIUS + 1, x - RADIUS:x + RADIUS + 1])
