"""Approximate nearest-neighbour Hamming matching (IVF), fixed-shape.

The reference's ``FlannMatcher`` is a KD-tree ANN over float-cast
descriptors (visual_slam/feature/matcher.py:77-103) — an asymptotic escape
hatch for descriptor sets too large to brute-force. KD-trees are pointer
machines and do not map to a fixed-shape device program; the idiomatic
equivalent is an IVF (inverted-file) index, the FAISS coarse-quantizer pattern, built from
fixed-shape gathers + matmuls:

* build: pick ``C`` anchor descriptors, assign every database descriptor to
  its nearest anchor (one Hamming matmul), bucket them with a fixed
  per-bucket capacity ``B`` (overflow truncates — the standard IVF recall
  trade),
* search: queries score the ``C`` anchors (one small matmul), probe their
  top-``P`` buckets, and run EXACT packed-XOR/popcount Hamming on just the
  ``P*B`` gathered candidates (``jax.lax.population_count`` on the packed
  uint32 words — no bit-unpack blowup), then Lowe-ratio + unique-train as
  in the exact matcher.

Complexity per query: O(C + P*B) vs exact O(N); with C = sqrt-ish(N),
P*B << N this is the classic IVF speedup while every shape stays static.

For SLAM-sized blocks (K <= 4096) the exact matmul matcher is faster and is
the default everywhere; ``frontend.matcher.FlannMatcher`` routes to this
module above ``ann_threshold`` database rows.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .matching import BIG, hamming_distance_matrix, min2, unique_train


class IVFIndex(NamedTuple):
    """Fixed-capacity inverted-file index over packed binary descriptors."""

    anchors: jnp.ndarray  # (C, 8) uint32 coarse centroids (sampled rows)
    bucket_desc: jnp.ndarray  # (C, B, 8) uint32
    bucket_ids: jnp.ndarray  # (C, B) int32 original row index (-1 = pad)
    bucket_valid: jnp.ndarray  # (C, B) bool

    @property
    def n_clusters(self) -> int:
        return self.anchors.shape[0]

    @property
    def bucket_cap(self) -> int:
        return self.bucket_ids.shape[1]


def build_ivf_index(
    desc,
    valid,
    n_clusters: int = 64,
    bucket_cap: int | None = None,
    seed: int = 0,
) -> IVFIndex:
    """Build the index (host-side bucket fill; the (N, C) assignment runs
    on device as one Hamming matmul). Rebuild when the database changes —
    index construction is the offline half of the ANN contract."""
    desc_np = np.asarray(desc)
    valid_np = np.asarray(valid).astype(bool)
    N = desc_np.shape[0]
    rng = np.random.default_rng(seed)
    valid_rows = np.nonzero(valid_np)[0]
    if len(valid_rows) == 0:
        raise ValueError("build_ivf_index: no valid descriptors")
    C = min(n_clusters, len(valid_rows))
    anchor_rows = rng.choice(valid_rows, size=C, replace=False)
    anchors = desc_np[anchor_rows]

    d = np.asarray(
        hamming_distance_matrix(
            jnp.asarray(desc_np), jnp.asarray(anchors),
            jnp.asarray(valid_np), jnp.ones(C, bool),
        )
    )  # (N, C)
    assign = np.argmin(d, axis=1)
    assign[~valid_np] = -1

    counts = np.bincount(assign[valid_np], minlength=C)
    if bucket_cap is None:
        # Headroom over the mean occupancy; multiple-of-64 for clean tiling.
        bucket_cap = int(np.ceil(2.0 * max(counts.max(), 1) / 64.0)) * 64
    B = bucket_cap

    bucket_desc = np.zeros((C, B, desc_np.shape[1]), desc_np.dtype)
    bucket_ids = np.full((C, B), -1, np.int32)
    bucket_valid = np.zeros((C, B), bool)
    n_trunc = 0
    for c in range(C):
        rows = np.nonzero(assign == c)[0]
        if len(rows) > B:
            n_trunc += len(rows) - B
            rows = rows[:B]
        bucket_desc[c, : len(rows)] = desc_np[rows]
        bucket_ids[c, : len(rows)] = rows
        bucket_valid[c, : len(rows)] = True
    if n_trunc:
        import logging

        logging.getLogger("ann").info(
            "IVF build: %d/%d descriptors truncated by bucket_cap=%d "
            "(recall trade — raise bucket_cap or n_clusters)",
            n_trunc, int(valid_np.sum()), B,
        )
    return IVFIndex(
        anchors=jnp.asarray(anchors),
        bucket_desc=jnp.asarray(bucket_desc),
        bucket_ids=jnp.asarray(bucket_ids),
        bucket_valid=jnp.asarray(bucket_valid),
    )


@partial(jax.jit, static_argnames=("n_probe", "ratio", "n_train"))
def ivf_search(
    index: IVFIndex,
    qdesc: jnp.ndarray,
    qvalid: jnp.ndarray,
    n_probe: int = 4,
    ratio: float = 0.75,
    n_train: int | None = None,
) -> dict:
    """Match (Q, 8) packed queries against the index.

    Returns the exact matcher's fixed-shape table: ``train_idx (Q,)``,
    ``distance (Q,)``, ``valid (Q,)``, ``n_matches`` — so it is a drop-in
    for :func:`ops.matching.match_descriptors` (minus cross-check, which an
    inverted file cannot answer without a second index).
    """
    Q = qdesc.shape[0]
    P = min(n_probe, index.n_clusters)
    # Coarse stage: one small matmul against the anchors.
    d_coarse = hamming_distance_matrix(
        qdesc, index.anchors, qvalid, jnp.ones(index.n_clusters, bool)
    )  # (Q, C)
    _, probe = jax.lax.top_k(-d_coarse, P)  # (Q, P)

    cand_desc = index.bucket_desc[probe]  # (Q, P, B, 8)
    cand_valid = index.bucket_valid[probe]  # (Q, P, B)
    cand_ids = index.bucket_ids[probe]  # (Q, P, B)

    # Fine stage: exact Hamming on packed words — XOR + population_count,
    # no 256-bit unpack (the gathered candidate set is small; the
    # elementwise op beats materializing (Q, P, B, 256) bit planes).
    x = jnp.bitwise_xor(qdesc[:, None, None, :], cand_desc)
    d = jnp.sum(jax.lax.population_count(x), axis=-1).astype(jnp.float32)
    d = jnp.where(cand_valid & qvalid[:, None, None], d, BIG)
    d = d.reshape(Q, -1)  # (Q, P*B)
    ids = cand_ids.reshape(Q, -1)

    best, second, ti_flat = min2(d)  # reductions, not a top_k sort
    ti = jnp.take_along_axis(ids, ti_flat[:, None], axis=1)[:, 0]
    ok = (best < BIG * 0.5) & qvalid
    if ratio > 0:
        # A probe set can end with a single finite candidate; treat a BIG
        # second-best as "no competitor" (pass), matching knn(2) semantics.
        ok &= (second >= BIG * 0.5) | (best < ratio * second)
    ti = jnp.maximum(ti, 0)
    if n_train is not None:
        ok = unique_train(ti, best, ok, n_train)
    return {
        "train_idx": ti,
        "distance": best,
        "valid": ok,
        "n_matches": jnp.sum(ok),
    }
