"""Nullspace extraction for DLT-style fits.

PnP (6-point DLT), the eight-point essential/fundamental fit and DLT
triangulation all need the unit eigenvector of the smallest eigenvalue of a
small PSD Gram matrix, batched over RANSAC hypotheses or points.
"""
from __future__ import annotations

import jax.numpy as jnp


def nullspace_vector(AtA: jnp.ndarray) -> jnp.ndarray:
    """Smallest-eigenvalue eigenvector of a batch of symmetric PSD
    ``(..., n, n)`` Gram matrices, by batched ``eigh`` on every backend.

    ``eigh`` is backward-stable and the numerics every CPU fixture is
    calibrated against. On one H100 it is also the faster solver at the
    PnP-RANSAC shape: 128 12x12 Grams take 0.06 ms per call against
    0.19-0.24 ms for Jacobi-equilibrated Cholesky inverse iteration, on
    consistent and outlier-mixed samples alike (700 W card; PERF.md).
    """
    _, vecs = jnp.linalg.eigh(AtA)
    return vecs[..., :, 0]
