"""visual_slam_tpu — a JAX/XLA monocular, stereo and RGB-D visual SLAM
framework with the capabilities of AntonSHBK/visual-slam-core, redesigned for
an accelerator: fixed-shape functional pipeline state, vmapped fixed-budget
RANSAC, matmul-based descriptor matching, and a Levenberg-Marquardt/Schur
bundle adjustment back-end."""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Geometry (SE(3) chains, 8-point systems, normal equations) needs true f32
# matmuls; a GPU's default f32 matmul may run in TF32 (about three decimal
# digits). Hot large matmuls (descriptor sampling and distances) request the
# default precision explicitly.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the pipeline's programs are shape-stable
# across runs, so serialized executables are reused by every later process.
# JAX_COMPILATION_CACHE_DIR, when set, is JAX's own setting and is left as
# it is; otherwise the cache lives at one fixed path inside the checkout, so
# every process run from it finds what earlier ones compiled.
_ENV_CACHE_DIR = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
CACHE_DIR = _ENV_CACHE_DIR or _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if not _ENV_CACHE_DIR:
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .config import Config  # noqa: F401
from .state import State  # noqa: F401
from .sensor_type import SensorType  # noqa: F401
from .camera import Camera, PinholeCamera  # noqa: F401


def __getattr__(name):
    # Lazy heavyweight imports (pull in the full pipeline stack on demand).
    if name == "SLAM":
        from .slam import SLAM

        return SLAM
    if name == "Processing":
        from .processing import Processing

        return Processing
    if name == "Tracking":
        from .tracking import Tracking

        return Tracking
    if name == "Initializer":
        from .initializer import Initializer

        return Initializer
    raise AttributeError(f"module 'visual_slam_tpu' has no attribute {name!r}")
