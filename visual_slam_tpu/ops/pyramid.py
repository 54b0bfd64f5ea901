"""Image pyramid + Gaussian smoothing, pure JAX.

Device replacement for the image-pyramid stage inside cv2.ORB
(reference: visual_slam/feature/feature.py:21-26 — nlevels=8,
scale_factor=1.2 defaults).  Each pyramid level has a static shape, so the
whole multi-scale front-end compiles once per input resolution.
"""
from __future__ import annotations


import jax.numpy as jnp
import jax


def gaussian_kernel1d(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def gaussian_blur(img: jnp.ndarray, sigma: float = 2.0, radius: int = 3) -> jnp.ndarray:
    """Separable Gaussian blur via shifted-slice accumulation (no conv op —
    2*(2r+1) shifted adds that XLA fuses into elementwise passes).

    Matches the pre-BRIEF smoothing OpenCV applies (7x7, sigma=2)."""
    k = gaussian_kernel1d(sigma, radius)
    H, W = img.shape
    p = jnp.pad(img, radius, mode="edge")
    # Horizontal pass.
    out = jnp.zeros((H + 2 * radius, W), img.dtype)
    for i in range(2 * radius + 1):
        out = out + k[i] * p[:, i : i + W]
    # Vertical pass.
    out2 = jnp.zeros((H, W), img.dtype)
    for i in range(2 * radius + 1):
        out2 = out2 + k[i] * out[i : i + H, :]
    return out2


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float) -> list[tuple[int, int]]:
    """Static per-level shapes (Python ints — resolved at trace time)."""
    shapes = []
    for l in range(n_levels):
        s = scale**l
        shapes.append((max(int(round(height / s)), 16), max(int(round(width / s)), 16)))
    return shapes


def build_pyramid(img: jnp.ndarray, n_levels: int, scale: float) -> list[jnp.ndarray]:
    """List of (H_l, W_l) float32 levels; level 0 is the input."""
    H, W = img.shape
    shapes = pyramid_shapes(H, W, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        # Resize from the previous level (incremental — sharper than direct
        # decimation from level 0 at deep levels, and cheaper).
        levels.append(
            jax.image.resize(levels[-1], shapes[l], method="linear")
        )
    return levels
