"""Loop closing: brute-force matmul place recognition + SE(3) pose-graph
optimization (working implementations of the reference's 0-byte stubs)."""

from .pose_graph import PoseGraph, build_sequential_graph, optimize_pose_graph  # noqa: F401
from .loop_closing import LoopClosing  # noqa: F401
