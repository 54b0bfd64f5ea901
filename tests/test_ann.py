"""Approximate-NN Hamming matching (ops/ann.py): the IVF escape hatch for
huge descriptor databases."""
import numpy as np
import pytest

from visual_slam_tpu.ops.ann import build_ivf_index, ivf_search
from visual_slam_tpu.ops.matching import match_descriptors


def _random_db(rng, n, words=8):
    return rng.integers(0, 2**32, size=(n, words), dtype=np.uint32)


def _perturb(rng, desc, flip_bits=8):
    out = desc.copy()
    for _ in range(flip_bits):
        word = rng.integers(0, desc.shape[1])
        bit = rng.integers(0, 32)
        out[:, word] ^= np.uint32(1 << bit) * rng.integers(
            0, 2, desc.shape[0]
        ).astype(np.uint32)
    return out


@pytest.fixture(scope="module")
def db():
    rng = np.random.default_rng(0)
    n = 2048
    desc = _random_db(rng, n)
    valid = np.ones(n, bool)
    valid[-32:] = False  # padding tail must never be matched
    index = build_ivf_index(desc, valid, n_clusters=64, seed=1)
    return rng, desc, valid, index


def test_ivf_recall_vs_exact(db):
    """Queries that ARE (noisy copies of) database rows: the IVF top-1 must
    agree with exact brute force for nearly all queries — random 256-bit
    codes are far apart, so the true row is the unambiguous NN and recall
    measures only whether probing found its bucket."""
    rng, desc, valid, index = db
    q_rows = rng.choice(np.nonzero(valid)[0], size=256, replace=False)
    qdesc = _perturb(rng, desc[q_rows])
    qvalid = np.ones(len(q_rows), bool)

    approx = ivf_search(index, qdesc, qvalid, n_probe=8, ratio=0.9)
    ti = np.asarray(approx["train_idx"])
    ok = np.asarray(approx["valid"])
    recall = float((ok & (ti == q_rows)).mean())
    assert recall >= 0.9, recall

    exact = match_descriptors(
        qdesc, desc, qvalid, valid, ratio=0.9, cross_check=False
    )
    ti_e = np.asarray(exact["train_idx"])
    ok_e = np.asarray(exact["valid"])
    both = ok & ok_e
    agree = float((ti[both] == ti_e[both]).mean())
    assert agree >= 0.95, agree
    # Where they agree, distances are EXACT (the fine stage is exact).
    same = both & (ti == ti_e)
    np.testing.assert_allclose(
        np.asarray(approx["distance"])[same], np.asarray(exact["distance"])[same]
    )


def test_ivf_never_matches_invalid_rows(db):
    rng, desc, valid, index = db
    # Query exact copies of the INVALID tail rows: they must not match
    # themselves (not in the index); any match must be a valid row.
    qdesc = desc[-16:]
    res = ivf_search(index, qdesc, np.ones(16, bool), n_probe=8, ratio=0.0)
    ti = np.asarray(res["train_idx"])
    ok = np.asarray(res["valid"])
    assert valid[ti[ok]].all()


def test_ivf_invalid_queries_masked(db):
    rng, desc, valid, index = db
    qdesc = desc[:8]
    qvalid = np.zeros(8, bool)
    res = ivf_search(index, qdesc, qvalid, n_probe=4)
    assert not np.asarray(res["valid"]).any()


def test_flann_matcher_routes_to_ivf():
    """FlannMatcher: exact below the threshold, IVF at/above it — and the
    IVF result still recalls the planted matches."""
    import jax.numpy as jnp

    from visual_slam_tpu.frontend.matcher import FlannMatcher
    from visual_slam_tpu.ops.detector import Features

    rng = np.random.default_rng(3)
    n_train, n_query = 512, 64
    desc = _random_db(rng, n_train)
    q_rows = rng.choice(n_train, size=n_query, replace=False)
    qdesc = _perturb(rng, desc[q_rows])

    def feats(d):
        k = d.shape[0]
        return Features(
            xy=jnp.zeros((k, 2)), response=jnp.ones(k), angle=jnp.zeros(k),
            octave=jnp.zeros(k, jnp.int32), size=jnp.ones(k),
            desc=jnp.asarray(d), valid=jnp.ones(k, bool),
        )

    m = FlannMatcher(ann_threshold=256, n_probe=8, n_clusters=16, ratio=0.9)
    assert m._index is None
    f_train = feats(desc)
    res = m.match(feats(qdesc), f_train)
    assert m._index is not None  # IVF path taken
    ti = np.asarray(res["train_idx"])
    ok = np.asarray(res["valid"])
    assert float((ok & (ti == q_rows)).mean()) >= 0.85
    # Same train block object again: the cached index is reused, not rebuilt
    # (the cache keys on the block's identity — keyframe feature blocks are
    # immutable).
    idx_obj = m._index
    m.match(feats(qdesc), f_train)
    assert m._index is idx_obj
