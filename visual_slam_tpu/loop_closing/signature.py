"""Compact global keyframe signatures for O(1)-per-keyframe place recognition.

The round-2 loop detector brute-matched the query keyframe against EVERY old
keyframe — one batched dispatch, but compute and the candidate buffer grew
linearly with map size. This module adds the standard SLAM fix (a
bag-of-visual-words global descriptor, the role DBoW2 plays in ORB-SLAM)
built for the device:

* a fixed random binary codebook of V visual words (no offline training —
  random codebooks retain enough discrimination for shortlist recall, and
  keep the framework dataset-free);
* word assignment for all K descriptors is ONE (K, 256) x (256, V) matmul
  (Hamming distance via +/-1 projection), one-hot histogram,
  L2 normalization — a single tiny program per keyframe;
* place similarity is a host-side (V,) . (V, N) matvec over the signature
  table — microseconds at thousands of keyframes, no device round trip.

Detection then verifies only the top-``shortlist`` scorers with the existing
batched geometric pipeline, so per-keyframe cost is flat in map size.

The reference has no loop closing at all (loop_closing/base.py is 0 bytes).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.orb import N_BITS, unpack_bits

N_WORDS_VOCAB = 256  # visual-word count V


def _make_codebook(seed: int = 77) -> np.ndarray:
    """(256, V) +/-1 projection of V random binary words: for bit vector b
    in {0,1}^256, Hamming(b, w) = const - b . (2w - 1), so argmax of the
    projection is the nearest word."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2, size=(N_WORDS_VOCAB, N_BITS))
    return (2.0 * words - 1.0).T.astype(np.float32)


_CODEBOOK = jnp.asarray(_make_codebook())  # module-level device constant


def _make_codebook_float(dim: int = 128, seed: int = 78) -> np.ndarray:
    """(dim, V) random unit directions: visual words for FLOAT descriptor
    families (SIFT/GradHist, stored bitcast — see matching.is_binary_desc).
    Nearest word under L2 on unit-norm descriptors = argmax projection."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(N_WORDS_VOCAB, dim)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    return w.T


_CODEBOOK_F = jnp.asarray(_make_codebook_float())


@jax.jit
def keyframe_signature(desc: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """(K, 8) packed rBRIEF (or (K, 128) bitcast float descriptors) + (K,)
    mask -> (V,) L2-normalized visual-word histogram. The codebook follows
    the descriptor width (static, per-shape trace)."""
    if int(desc.shape[-1]) == 8:
        bits = unpack_bits(desc, dtype=jnp.float32)  # (K, 256)
        codebook = _CODEBOOK
    else:
        bits = jax.lax.bitcast_convert_type(desc, jnp.float32)  # (K, 128)
        codebook = _CODEBOOK_F
    proj = jax.lax.dot_general(
        bits, codebook,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (K, V); argmax = nearest word
    word = jnp.argmax(proj, axis=-1)
    hist = jnp.sum(
        jax.nn.one_hot(word, N_WORDS_VOCAB, dtype=jnp.float32)
        * valid.astype(jnp.float32)[:, None],
        axis=0,
    )
    return hist / jnp.maximum(jnp.linalg.norm(hist), 1e-9)


def batch_signatures(descs: np.ndarray, valids: np.ndarray) -> np.ndarray:
    """(N, K, 8) + (N, K) -> (N, V) in one vmapped dispatch (used to backfill
    signatures for resumed/legacy keyframes)."""
    sigs = jax.vmap(keyframe_signature)(jnp.asarray(descs), jnp.asarray(valids))
    return np.asarray(sigs)


def score_signatures(query: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Centered-cosine place similarity of ``query`` (V,) against ``table``
    (N, V) — host-side, microseconds at thousands of keyframes.

    Centering (subtracting the table's mean histogram) plays the role of
    TF-IDF down-weighting: words every keyframe uses carry no place
    information, and raw cosine between near-uniform histograms saturates
    near 1.0 (no margin). Deviations from the map-wide mean are what
    discriminate places."""
    mu = table.mean(axis=0)
    qc = query - mu
    tc = table - mu
    qn = qc / max(float(np.linalg.norm(qc)), 1e-9)
    tn = tc / np.maximum(np.linalg.norm(tc, axis=1, keepdims=True), 1e-9)
    return tn @ qn
