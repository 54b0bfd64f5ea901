"""Oriented rBRIEF descriptors, pure JAX.

Device replacement for cv2.ORB's orientation + descriptor stages
(reference: visual_slam/feature/feature.py:21-47, 180-223): intensity-centroid
orientation over a circular patch and a rotated 256-pair binary test pattern,
packed into 8 uint32 words per keypoint.

The sampling pattern is generated from a fixed-seed isotropic Gaussian (the
original BRIEF construction) rather than copying OpenCV's learned table — the
descriptor is not bit-compatible with cv2.ORB, and doesn't need to be: matching
happens within this framework, and the parity target is geometry (SURVEY.md §7).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

PATCH = 31
RADIUS = PATCH // 2  # 15
PATTERN_CLIP = 12  # keep test points within rotation-safe radius
N_BITS = 256
N_WORDS = N_BITS // 32


def _make_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 2, 2) float32: 256 pairs of (y, x) offsets, Gaussian sigma =
    PATCH/5 (BRIEF G-II construction), clipped to a rotation-safe disk."""
    rng = np.random.default_rng(seed)
    sigma = PATCH / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 2, 2))
    norms = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(norms > PATTERN_CLIP, pts * (PATTERN_CLIP / norms), pts)
    return pts.astype(np.float32)


PATTERN = jnp.asarray(_make_pattern())  # (256, 2 points, 2=(y,x))

# Circular mask for the intensity centroid (disk of radius 15).
_yy, _xx = np.mgrid[-RADIUS : RADIUS + 1, -RADIUS : RADIUS + 1]
DISK = jnp.asarray((_yy**2 + _xx**2 <= RADIUS**2).astype(np.float32))
YY = jnp.asarray(_yy.astype(np.float32))
XX = jnp.asarray(_xx.astype(np.float32))


def extract_patches(img: jnp.ndarray, yx: jnp.ndarray) -> jnp.ndarray:
    """Gather (K, 31, 31) patches centred on integer keypoints ``yx (K, 2)``.

    Out-of-bounds regions replicate the edge (keypoints near the border are
    filtered out upstream by the detector's interior mask anyway)."""
    p = jnp.pad(img, RADIUS + 1, mode="edge")

    def one(c):
        return jax.lax.dynamic_slice(p, (c[0] + 1, c[1] + 1), (PATCH, PATCH))

    return jax.vmap(one)(yx)


_MOMENT_W = jnp.asarray(np.stack(
    [(_xx * (_yy**2 + _xx**2 <= RADIUS**2)).astype(np.float32).reshape(-1),
     (_yy * (_yy**2 + _xx**2 <= RADIUS**2)).astype(np.float32).reshape(-1)],
    axis=-1,
))  # (961, 2): disk-masked x / y moment weights

def orientations(patches: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle per patch: (K, 31, 31) -> (K,) radians. One
    (K, 961) x (961, 2) matmul instead of masked reductions."""
    flat = patches.reshape(patches.shape[0], -1)
    m = jax.lax.dot_general(
        flat, _MOMENT_W,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )  # (K, 2) = (m10, m01)
    return jnp.arctan2(m[:, 1], m[:, 0])


# Steering quantization: the pattern is pre-rotated into N_BINS discrete
# orientations (2pi/30 = 12 degrees, the cv2.ORB quantization) and each bin's
# bilinear sampling is baked into a dense (961 -> 512) weight matrix. Sampling
# ALL bins for ALL patches is then ONE (K, 961) x (961, N_BINS*512) matmul,
# followed by a one-hot bin select — no per-keypoint bilinear gathers.
N_BINS = 30


def _make_rotated_sampling_matrices() -> np.ndarray:
    """(961, N_BINS * 512) bilinear sampling weights: column (b*512 + s)
    samples pattern point s rotated by angle 2pi*b/N_BINS."""
    pat = _make_pattern()  # (256, 2, 2) as (y, x)
    pts = pat.reshape(-1, 2)  # (512, 2)
    S = np.zeros((PATCH * PATCH, N_BINS * 2 * N_BITS), np.float32)
    for b in range(N_BINS):
        th = 2.0 * np.pi * b / N_BINS
        c, s = np.cos(th), np.sin(th)
        ry = s * pts[:, 1] + c * pts[:, 0] + RADIUS
        rx = c * pts[:, 1] - s * pts[:, 0] + RADIUS
        y0 = np.clip(np.floor(ry), 0, PATCH - 2).astype(int)
        x0 = np.clip(np.floor(rx), 0, PATCH - 2).astype(int)
        fy = ry - y0
        fx = rx - x0
        for si in range(2 * N_BITS):
            col = b * 2 * N_BITS + si
            base = y0[si] * PATCH + x0[si]
            S[base, col] += (1 - fy[si]) * (1 - fx[si])
            S[base + 1, col] += (1 - fy[si]) * fx[si]
            S[base + PATCH, col] += fy[si] * (1 - fx[si])
            S[base + PATCH + 1, col] += fy[si] * fx[si]
    return S


# Host-side constant (59 MB). NOTE: always pass this through jit boundaries
# as a traced ARGUMENT (see sampling_matrix()), never close over it — baked
# as an HLO literal it blows up compile time.
SAMPLING_NP = _make_rotated_sampling_matrices()  # (961, 30*512) float32

_sampling_device = None


def sampling_matrix() -> jnp.ndarray:
    """Device-resident copy of the rotated-BRIEF sampling matrix (uploaded
    once per process). Kept f32: a bf16 experiment showed no wall-clock gain
    (the step is not bound by this stream in practice) while bf16 sampling
    noise flips near-tie descriptor bits on low-texture patches."""
    global _sampling_device
    if _sampling_device is None:
        _sampling_device = jnp.asarray(SAMPLING_NP)
    return _sampling_device


def descriptors(
    patches: jnp.ndarray, angles: jnp.ndarray, sampling: jnp.ndarray
) -> jnp.ndarray:
    """Steered BRIEF: (K, 31, 31) blurred patches + (K,) angles -> (K, 8)
    uint32. ``sampling`` is the (961, N_BINS*512) rotated-pattern matrix
    (pass ``sampling_matrix()``)."""
    K = patches.shape[0]
    flat = patches.reshape(K, -1)  # (K, 961)
    samples_all = jax.lax.dot_general(
        flat, sampling,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    ).reshape(K, N_BINS, 2 * N_BITS)
    # Select each keypoint's angle bin with a one-hot contraction (no gather).
    two_pi = 2.0 * jnp.pi
    bins = jnp.floor(jnp.mod(angles, two_pi) / two_pi * N_BINS).astype(jnp.int32) % N_BINS
    onehot = jax.nn.one_hot(bins, N_BINS, dtype=samples_all.dtype)  # (K, 30)
    vals = jnp.einsum("kbs,kb->ks", samples_all, onehot).reshape(K, N_BITS, 2)
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint32)  # (K, 256)
    # Pack into 8 uint32 words.
    b = bits.reshape(-1, N_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32)


_sampling_stack = None


def sampling_stack() -> jnp.ndarray:
    """(N_BINS, 961, 512) per-bin view of the sampling matrix for the
    grouped-matmul descriptor path (``descriptors_sorted``)."""
    global _sampling_stack
    if _sampling_stack is None:
        _sampling_stack = jnp.asarray(
            SAMPLING_NP.reshape(PATCH * PATCH, N_BINS, 2 * N_BITS)
            .transpose(1, 0, 2)
            .copy()
        )
    return _sampling_stack


_RAGGED_DESC = None  # None -> env default, resolved lazily


def set_ragged_descriptors(on: bool) -> None:
    """Select the descriptor path threaded by :func:`active_sampling`:
    bin-sorted grouped matmul (True) or dense 30-bin matmul (False).
    Wired from config.feature.ragged_descriptors by the model facades."""
    global _RAGGED_DESC
    _RAGGED_DESC = bool(on)


def active_sampling() -> jnp.ndarray:
    """The sampling operand matching the active descriptor path — its RANK
    selects the path inside detect_and_describe_with_sampling (2-D = dense
    30-bin matmul, 3-D stack = bin-sorted ragged_dot)."""
    import os

    on = _RAGGED_DESC
    if on is None:
        on = os.environ.get("VSLAM_RAGGED_DESC", "0") == "1"
    return sampling_stack() if on else sampling_matrix()


def descriptors_sorted(
    patches: jnp.ndarray, angles: jnp.ndarray, stack: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Steered BRIEF via bin-sorted grouped matmul: returns (desc (K, 8)
    uint32 in SORTED order, order (K,) the sort permutation).

    The dense path (:func:`descriptors`) computes ALL ``N_BINS`` rotations
    for every keypoint — a (K, P) x (P, N_BINS*512) matmul, ~30x redundant.
    Here keypoints are sorted by orientation bin and
    ``jax.lax.ragged_dot`` (the grouped/MoE matmul primitive) applies each
    bin's (P, 512) matrix to exactly its own rows — no per-bin capacity, no
    overflow, 1/N_BINS the FLOPs. The caller permutes ALL Features fields
    by ``order`` instead of un-sorting the descriptors (cheap row gathers;
    keypoint order is free per frame)."""
    K = patches.shape[0]
    flat = patches.reshape(K, -1)  # (K, P)
    two_pi = 2.0 * jnp.pi
    bins = jnp.floor(jnp.mod(angles, two_pi) / two_pi * N_BINS).astype(jnp.int32) % N_BINS
    order = jnp.argsort(bins)  # stable
    flat_s = flat[order]
    group_sizes = jnp.sum(
        jax.nn.one_hot(bins, N_BINS, dtype=jnp.int32), axis=0
    )  # (N_BINS,)
    vals = jax.lax.ragged_dot(
        flat_s, stack, group_sizes,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.DEFAULT,
    ).reshape(K, N_BITS, 2)
    bits = (vals[..., 0] < vals[..., 1]).astype(jnp.uint32)
    b = bits.reshape(-1, N_WORDS, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    return jnp.sum(b << shifts, axis=-1, dtype=jnp.uint32), order


def unpack_bits(packed: jnp.ndarray, dtype=jnp.bfloat16) -> jnp.ndarray:
    """(K, 8) uint32 -> (K, 256) 0/1 in ``dtype`` (bf16 feeds the
    Hamming-distance matmul; integers <= 256 are exact in bf16's 8-bit
    mantissa and the matmul accumulates in f32)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    bits = (packed[..., None] >> shifts) & jnp.uint32(1)
    return bits.reshape(*packed.shape[:-1], N_BITS).astype(dtype)
