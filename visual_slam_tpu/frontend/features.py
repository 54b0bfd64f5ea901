"""Feature detector classes over the jitted device front-end.

API parity with the reference detector zoo (visual_slam/feature/base.py:8-34
ABC; feature.py:13-328 ORB/SIFT/FastBrief/FastOrbAnms): ``detect``,
``compute``, ``detectAndCompute``. All binary-descriptor detectors route to
the fused JAX pipeline (ops/detector.py); spatial balancing is the grid
top-k built into the detector (the fixed-shape replacement for ANMS/SSC,
reference feature.py:244-328).
"""
from __future__ import annotations

import abc

import numpy as np
import jax.numpy as jnp

from ..ops.detector import Features, detect_and_describe


class BaseFeature2D(abc.ABC):
    """(reference feature/base.py:8-34)"""

    # uint32 words per descriptor row: 8 for binary 256-bit families,
    # 128 for float families (f32 bitcast — matching.is_binary_desc).
    desc_words = 8

    @abc.abstractmethod
    def detectAndCompute(self, image: np.ndarray) -> Features: ...

    def detect(self, image: np.ndarray) -> Features:
        return self.detectAndCompute(image)

    def compute(self, image: np.ndarray, features: Features) -> Features:
        return features


class FastOrbFeature2D(BaseFeature2D):
    """FAST + oriented rBRIEF, fused on-device (replaces ORBFeature2D /
    FastOrbAnmsFeature2D / FastBriefFeature2D, reference feature.py:13-47,
    89-127, 132-223)."""

    def __init__(
        self,
        num_features: int = 1000,
        fast_threshold: float = 20.0,
        n_levels: int = 4,
        scale_factor: float = 1.2,
        grid: int = 8,
        **_: object,
    ):
        self.num_features = int(num_features)
        self.fast_threshold = float(fast_threshold)
        self.n_levels = int(n_levels)
        self.scale_factor = float(scale_factor)
        self.grid = int(grid)

    score = "fast"

    def detectAndCompute(self, image: np.ndarray) -> Features:
        img = jnp.asarray(np.ascontiguousarray(image), jnp.float32)
        return detect_and_describe(
            img,
            num_features=self.num_features,
            threshold=self.fast_threshold,
            n_levels=self.n_levels,
            scale=self.scale_factor,
            grid=self.grid,
            score=self.score,
        )


class ShiTomasiOrbFeature2D(FastOrbFeature2D):
    """Shi-Tomasi (min-eigenvalue) scoring + rBRIEF description, fully
    on-device (ops/fast.py::shi_tomasi_scores; the reference's
    SHI_TOMASI_ORB factory entry delegates to cv2.goodFeaturesToTrack).
    ``fast_threshold`` is reinterpreted as the cv2-style relative quality
    level; values > 1 (FAST units from shared configs) map to 0.01."""

    score = "shi_tomasi"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.fast_threshold > 1.0:
            self.fast_threshold = 0.01


class GradHistFeature2D(BaseFeature2D):
    """On-device float-descriptor family: FAST (or Shi-Tomasi) keypoints +
    the 128-d gradient-histogram descriptor computed fully on device
    (ops/floatdesc.py), L2-matched. The SIFT-class option with no host/cv2
    dependency (the reference's float family delegates to cv2.SIFT)."""

    score = "fast"
    desc_words = 128

    def __init__(
        self,
        num_features: int = 1000,
        fast_threshold: float = 20.0,
        n_levels: int = 4,
        scale_factor: float = 1.2,
        grid: int = 8,
        **_: object,
    ):
        self.num_features = int(num_features)
        self.fast_threshold = float(fast_threshold)
        self.n_levels = int(n_levels)
        self.scale_factor = float(scale_factor)
        self.grid = int(grid)

    def detectAndCompute(self, image: np.ndarray) -> Features:
        from ..ops.floatdesc import detect_and_describe_gradhist

        img = jnp.asarray(np.ascontiguousarray(image), jnp.float32)
        return detect_and_describe_gradhist(
            img,
            num_features=self.num_features,
            threshold=self.fast_threshold,
            n_levels=self.n_levels,
            scale=self.scale_factor,
            grid=self.grid,
            score=self.score,
        )


class ShiTomasiGradHistFeature2D(GradHistFeature2D):
    """Shi-Tomasi scoring + GradHist float descriptors, all on device."""

    score = "shi_tomasi"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.fast_threshold > 1.0:
            self.fast_threshold = 0.01


class DoGSiftFeature2D(BaseFeature2D):
    """On-device SIFT: DoG scale-space extrema detection + the 128-d
    GradHist descriptor, one jitted device program (ops/sift.py). The
    device-first counterpart of the reference's cv2.SIFT family
    (visual_slam/feature/feature.py:53-83)."""

    desc_words = 128

    def __init__(
        self,
        num_features: int = 1000,
        n_octaves: int = 4,
        n_scales: int = 3,
        contrast_threshold: float = 0.04,
        edge_threshold: float = 10.0,
        grid: int = 8,
        **_: object,
    ):
        self.num_features = int(num_features)
        self.n_octaves = int(n_octaves)
        self.n_scales = int(n_scales)
        self.contrast_threshold = float(contrast_threshold)
        self.edge_threshold = float(edge_threshold)
        self.grid = int(grid)

    def detectAndCompute(self, image: np.ndarray) -> Features:
        from ..ops.sift import detect_and_describe_sift

        img = jnp.asarray(np.ascontiguousarray(image), jnp.float32)
        return detect_and_describe_sift(
            img,
            num_features=self.num_features,
            n_octaves=self.n_octaves,
            n_scales=self.n_scales,
            contrast_threshold=self.contrast_threshold,
            edge_threshold=self.edge_threshold,
            grid=self.grid,
        )


class SIFTFeature2D(BaseFeature2D):
    """Float-descriptor fallback via OpenCV (host-side; reference
    feature.py:53-83). The binary on-device detectors are the first-class
    path."""

    desc_words = 128

    def __init__(self, num_features: int = 1000, **_: object):
        import cv2

        self.num_features = int(num_features)
        self._sift = cv2.SIFT_create(nfeatures=num_features)

    def detectAndCompute(self, image: np.ndarray) -> Features:
        img8 = np.clip(np.asarray(image), 0, 255).astype(np.uint8)
        kps, desc = self._sift.detectAndCompute(img8, None)
        K = self.num_features
        xy = np.zeros((K, 2), np.float32)
        response = np.zeros((K,), np.float32)
        angle = np.zeros((K,), np.float32)
        octave = np.zeros((K,), np.int32)
        size = np.zeros((K,), np.float32)
        valid = np.zeros((K,), bool)
        d = np.zeros((K, 128), np.float32)
        n = min(len(kps), K)
        for i in range(n):
            kp = kps[i]
            xy[i] = kp.pt
            response[i] = kp.response
            angle[i] = np.deg2rad(kp.angle) if kp.angle >= 0 else 0.0
            size[i] = kp.size
            valid[i] = True
            if desc is not None:
                d[i] = desc[i]
        # Float descriptors are stored bit-cast into the uint32 block so the
        # Features pytree shape stays uniform; L2 matchers re-cast.
        desc_u32 = d.view(np.uint32).reshape(K, 128)
        return Features(
            xy=jnp.asarray(xy),
            response=jnp.asarray(response),
            angle=jnp.asarray(angle),
            octave=jnp.asarray(octave),
            size=jnp.asarray(size),
            desc=jnp.asarray(desc_u32),
            valid=jnp.asarray(valid),
        )
