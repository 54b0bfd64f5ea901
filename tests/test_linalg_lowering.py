"""ops/matching.min2 (exact vs the lax.top_k it replaces) and
ops/linalg.nullspace_vector (batched eigh on every backend)."""
import numpy as np
import jax
import jax.numpy as jnp

from visual_slam_tpu.ops.matching import min2


def test_min2_matches_topk(rng):
    d = rng.uniform(0, 100, (64, 129)).astype(np.float32)
    # Inject exact duplicates to exercise tie-breaks.
    d[5, 7] = d[5, 99] = 1.5
    d[10, :] = 3.0
    dj = jnp.asarray(d)
    neg2, idx2 = jax.lax.top_k(-dj, 2)
    best, second, ti = min2(dj)
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(idx2[:, 0]))
    np.testing.assert_array_equal(np.asarray(best), np.asarray(-neg2[:, 0]))
    np.testing.assert_array_equal(np.asarray(second), np.asarray(-neg2[:, 1]))


def test_nullspace_vector_cpu_is_eigh(rng):
    """nullspace_vector is eigh's smallest-eigenvalue vector bit-for-bit —
    the contract that keeps every CPU fixture's f32 luck untouched — and
    it is a nullvector of a rank-deficient Gram."""
    import jax.numpy as jnp
    from visual_slam_tpu.ops.linalg import nullspace_vector

    B = rng.normal(size=(6, 11, 12)).astype(np.float32)
    AtA = jnp.asarray(np.einsum("bij,bik->bjk", B, B))
    x = nullspace_vector(AtA)
    ref = jnp.linalg.eigh(AtA)[1][..., :, 0]
    np.testing.assert_array_equal(np.asarray(x), np.asarray(ref))
    r = np.linalg.norm(np.einsum("bij,bj->bi", np.asarray(AtA), np.asarray(x)), axis=-1)
    assert np.all(r < 2e-3 * np.trace(np.asarray(AtA), axis1=-2, axis2=-1))
