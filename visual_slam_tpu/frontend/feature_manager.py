"""Detector/matcher factories and the FeatureManager facade.

API parity with the reference (visual_slam/feature/feature_manager.py:15-62):
same factory names (orb, fast_orb_anms, sift, fastbrief / bf_hamming,
bf-l2, flann) mapped onto the on-device JAX implementations.
"""
from __future__ import annotations

from ..config import FeatureConfig
from .features import (
    BaseFeature2D,
    DoGSiftFeature2D,
    FastOrbFeature2D,
    GradHistFeature2D,
    ShiTomasiGradHistFeature2D,
    ShiTomasiOrbFeature2D,
    SIFTFeature2D,
)
from .matcher import BaseMatcher, BFMatcherHamming, BFMatcherL2, FlannMatcher

_DETECTORS = {
    "orb": FastOrbFeature2D,
    "fast_orb": FastOrbFeature2D,
    "fast_orb_anms": FastOrbFeature2D,  # grid top-k subsumes ANMS balancing
    "fastbrief": FastOrbFeature2D,
    "shi_tomasi_orb": ShiTomasiOrbFeature2D,
    "sift": DoGSiftFeature2D,  # on-device DoG + GradHist (ops/sift.py)
    "dog_gradhist": DoGSiftFeature2D,
    "sift_cv2": SIFTFeature2D,  # host cv2 fallback (reference parity)
    "gradhist": GradHistFeature2D,  # on-device float family
    "fast_gradhist": GradHistFeature2D,
    "shi_tomasi_gradhist": ShiTomasiGradHistFeature2D,
}

_MATCHERS = {
    "bf_hamming": BFMatcherHamming,
    "bf-hamming": BFMatcherHamming,
    "hamming": BFMatcherHamming,
    "bf-l2": BFMatcherL2,
    "l2": BFMatcherL2,
    "flann": FlannMatcher,
}


def feature_factory(name: str, **params) -> BaseFeature2D:
    """(reference feature_manager.py:15-26)"""
    key = name.lower()
    if key not in _DETECTORS:
        raise ValueError(f"Unknown detector '{name}'; available: {sorted(_DETECTORS)}")
    return _DETECTORS[key](**params)


def matcher_factory(name: str, **params) -> BaseMatcher:
    """(reference feature_manager.py:29-38)"""
    key = name.lower()
    if key not in _MATCHERS:
        raise ValueError(f"Unknown matcher '{name}'; available: {sorted(_MATCHERS)}")
    return _MATCHERS[key](**params)


class FeatureManager:
    """Holds the configured detector + matcher pair (reference
    feature_manager.py:41-62)."""

    def __init__(self, config: FeatureConfig):
        self.config = config
        det_params = dict(
            num_features=config.num_features,
            fast_threshold=config.fast_threshold,
            n_levels=config.num_pyramid_levels,
            scale_factor=config.scale_factor,
            grid=config.grid_cells,
        )
        det_params.update(config.detector_params)
        self.detector = feature_factory(config.detector_name, **det_params)
        self.matcher = matcher_factory(config.matcher_name, **config.matcher_params)

    def detectAndCompute(self, image):
        return self.detector.detectAndCompute(image)

    def match(self, f1, f2):
        return self.matcher.match(f1, f2)
