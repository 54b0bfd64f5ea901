"""Matcher classes over the matmul distance kernels.

API parity with the reference matchers (visual_slam/feature/base.py:37-45 ABC;
matcher.py:12-103 BFMatcherHamming / BFMatcherL2 / FlannMatcher). All exact
brute-force search — one distance matmul beats approximate KD-trees at
these descriptor counts, so FlannMatcher is an alias of the L2 matcher (the
reference's FLANN exists only because CPU brute force is slow).
"""
from __future__ import annotations

import abc

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.detector import Features
from ..ops import matching as m_ops


class MatchResult(dict):
    """dict with train_idx/distance/valid/n_matches (fixed query-aligned shapes)."""


class BaseMatcher(abc.ABC):
    """(reference feature/base.py:37-45)"""

    @abc.abstractmethod
    def match(self, f1: Features, f2: Features) -> MatchResult: ...


class BFMatcherHamming(BaseMatcher):
    """Binary brute-force matcher (reference matcher.py:12-40): crossCheck
    mode or knn(2)+Lowe-ratio; one bf16 matmul under the hood."""

    def __init__(self, ratio: float = 0.75, cross_check: bool = True,
                 use_orientation: bool = False, max_distance: float = 0.0, **_: object):
        self.ratio = float(ratio)
        self.cross_check = bool(cross_check)
        self.use_orientation = bool(use_orientation)
        self.max_distance = float(max_distance)

    def match(self, f1: Features, f2: Features) -> MatchResult:
        res = m_ops.match_descriptors(
            f1.desc, f2.desc, f1.valid, f2.valid, f1.angle, f2.angle,
            ratio=self.ratio, cross_check=self.cross_check,
            use_orientation=self.use_orientation, max_distance=self.max_distance,
        )
        return MatchResult(res)


def _l2_distance_matrix(d1: jnp.ndarray, d2: jnp.ndarray, v1, v2) -> jnp.ndarray:
    n1 = jnp.sum(d1 * d1, axis=-1)
    n2 = jnp.sum(d2 * d2, axis=-1)
    dots = jax.lax.dot_general(
        d1, d2, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    d = jnp.sqrt(jnp.maximum(n1[:, None] + n2[None, :] - 2.0 * dots, 0.0))
    return jnp.where(v1[:, None] & v2[None, :], d, m_ops.BIG)


class BFMatcherL2(BaseMatcher):
    """Float brute-force matcher (reference matcher.py:46-71) via
    ||a-b||^2 = |a|^2 + |b|^2 - 2ab as one matmul."""

    def __init__(self, ratio: float = 0.75, cross_check: bool = True, **_: object):
        self.ratio = float(ratio)
        self.cross_check = bool(cross_check)

    def match(self, f1: Features, f2: Features) -> MatchResult:
        # Metric follows the descriptor width (ops.matching.is_binary_desc):
        # float families take the fused L2 path, binary blocks degrade
        # gracefully to Hamming (L2 on packed words would be meaningless).
        res = m_ops.match_descriptors(
            f1.desc, f2.desc, f1.valid, f2.valid,
            ratio=self.ratio, cross_check=self.cross_check,
        )
        return MatchResult(res)


class FlannMatcher(BFMatcherL2):
    """ANN matcher (reference matcher.py:77-103 is a KD-tree FLANN).

    Below ``ann_threshold`` train rows: exact search (one matmul beats
    any approximate structure at SLAM block sizes — see module docstring).
    At or above it: a Hamming IVF index (ops/ann.py — the fixed-shape
    analogue of the reference's KD-tree, coarse-quantize + probe instead of
    pointer-chasing), built once per train block and cached, giving the
    O(C + P*B) per-query asymptotic escape hatch for huge descriptor
    databases (e.g. map-wide relocalization tables)."""

    def __init__(self, ratio: float = 0.75, cross_check: bool = True,
                 ann_threshold: int = 8192, n_probe: int = 8,
                 n_clusters: int | None = None, **_: object):
        super().__init__(ratio=ratio, cross_check=cross_check)
        self.ann_threshold = int(ann_threshold)
        self.n_probe = int(n_probe)
        self.n_clusters = n_clusters
        self._index_key = None
        self._index = None

    def match(self, f1: Features, f2: Features) -> MatchResult:
        n = int(f2.desc.shape[0])
        binary = int(f2.desc.shape[1]) == 8
        if n < self.ann_threshold or not binary:
            return super().match(f1, f2)
        from ..ops.ann import build_ivf_index, ivf_search

        key = (id(f2.desc), n)
        if self._index is None or self._index_key != key:
            C = self.n_clusters or max(64, 1 << int(np.log2(max(n, 2) ** 0.5)))
            self._index = build_ivf_index(f2.desc, f2.valid, n_clusters=C)
            self._index_key = key
        res = ivf_search(
            self._index, f1.desc, f1.valid,
            n_probe=self.n_probe, ratio=self.ratio, n_train=n,
        )
        return MatchResult(res)
