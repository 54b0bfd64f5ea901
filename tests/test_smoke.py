"""Import smoke: every public module loads (catches import rot early)."""
import importlib

import pytest

MODULES = [
    "visual_slam_tpu",
    "visual_slam_tpu.camera",
    "visual_slam_tpu.config",
    "visual_slam_tpu.state",
    "visual_slam_tpu.sensor_type",
    "visual_slam_tpu.slam",
    "visual_slam_tpu.tracking",
    "visual_slam_tpu.initializer",
    "visual_slam_tpu.processing",
    "visual_slam_tpu.pipeline",
    "visual_slam_tpu.ops",
    "visual_slam_tpu.ops.lie",
    "visual_slam_tpu.ops.projection",
    "visual_slam_tpu.ops.triangulation",
    "visual_slam_tpu.ops.epipolar",
    "visual_slam_tpu.ops.pnp",
    "visual_slam_tpu.ops.fast",
    "visual_slam_tpu.ops.orb",
    "visual_slam_tpu.ops.pyramid",
    "visual_slam_tpu.ops.detector",
    "visual_slam_tpu.ops.matching",
    "visual_slam_tpu.ops.guided_matching",
    "visual_slam_tpu.ops.keypoint_filters",
    "visual_slam_tpu.ops.linalg",
    "visual_slam_tpu.frontend",
    "visual_slam_tpu.frontend.filters",
    "visual_slam_tpu.backend",
    "visual_slam_tpu.backend.optimizer",
    "visual_slam_tpu.backend.adam",
    "visual_slam_tpu.map",
    "visual_slam_tpu.local_mapping",
    "visual_slam_tpu.handlers",
    "visual_slam_tpu.loop_closing",
    "visual_slam_tpu.trackingalgorithm",
    "visual_slam_tpu.parallel",
    "visual_slam_tpu.models",
    "visual_slam_tpu.io",
    "visual_slam_tpu.utils",
    "visual_slam_tpu.utils.metrics",
    "visual_slam_tpu.utils.serialization",
    "visual_slam_tpu.utils.profiling",
    "visual_slam_tpu.viz",
]


@pytest.mark.parametrize("name", MODULES)
def test_import(name):
    importlib.import_module(name)


def test_public_symbols():
    import visual_slam_tpu as v

    assert v.SLAM and v.Processing and v.Config and v.State
    from visual_slam_tpu.models import (  # noqa: F401
        BatchedVO, CompiledSLAM, CompiledVO, MonoVO, RGBDVO, StereoVO,
    )
