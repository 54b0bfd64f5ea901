"""Pure-JAX compute kernels: Lie groups, projection, two-view geometry, PnP,
features, matching. The on-device analogue of the reference's
visual_slam/utils/* numba+OpenCV layer."""

from . import lie, projection, triangulation, epipolar, pnp  # noqa: F401
from . import fast, orb, pyramid, detector, matching  # noqa: F401
