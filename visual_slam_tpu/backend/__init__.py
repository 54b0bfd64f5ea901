"""Bundle-adjustment back-end: LM + Schur solver and the optimizer facade
(device replacement of the reference's visual_slam/optimization package)."""

from .ba import (  # noqa: F401
    BAProblem,
    bundle_adjust,
    bundle_adjust_robust,
    mean_reprojection_error,
    residual_norms,
)
