"""Local (windowed) bundle-adjustment handler.

API parity with the reference LocalHandler (visual_slam/handlers/
local_handler.py:28-83): take the last ``max_neighbors`` keyframes, run the
window BA, log reprojection error before/after. ``cull_bad_points`` is real
here (observation trimming happens inside the LM writeback,
backend/optimizer.py) and ``update_covisibility`` lives in LocalMapping.
"""
from __future__ import annotations

from ..map import Map
from .base_handler import BaseHandler


class LocalHandler(BaseHandler):
    def __init__(self, slam_map: Map, optimizer, camera, config, **kwargs):
        super().__init__(run_timeout=config.local_mapping.run_timeout, **kwargs)
        self.map = slam_map
        self.optimizer = optimizer
        self.camera = camera
        self.config = config
        self.window = max(config.optimization.window_size, config.local_mapping.max_neighbors)
        self.last_result: dict = {}
        self._trigger_count = 0

    def step(self) -> None:
        """(reference local_handler.py:28-74)

        Policy: while the map fits a couple of window buckets, run full-map
        BA (every pose free — a compiled LM solve is milliseconds, so
        there is no reason to accept windowing drift on small maps); switch
        to sliding-window BA with fixed out-of-window anchors at scale."""
        self._trigger_count += 1
        every = max(self.config.optimization.ba_every_n_keyframes, 1)
        if self._trigger_count % every != 0:
            return
        all_kfs = self.map.get_keyframes()
        if len(all_kfs) <= 2:
            return
        log_err = self.config.optimization.log_reprojection_error
        err_before = (
            self.map.compute_mean_reprojection_error(self.camera.K) if log_err else -1.0
        )
        # Hold the map lock across pack+solve+writeback: a keyframe inserted
        # or a pose updated mid-solve makes the writeback overwrite newer
        # state with results from a stale snapshot (observed in the threaded
        # e2e: BA "improving" reprojection 0.6 -> 2.0 px). The compiled solve
        # is milliseconds, so blocking concurrent map access is cheap.
        with self.map._lock:
            if len(all_kfs) <= max(
                self.config.optimization.global_ba_max_keyframes, 2 * self.window
            ):
                result = self.map.optimize_global(self.optimizer)
            else:
                result = self.map.optimize_local(self.optimizer, all_kfs[-self.window :])
        err_after = (
            self.map.compute_mean_reprojection_error(self.camera.K) if log_err else -1.0
        )
        result["reproj_before_px"] = err_before
        result["reproj_after_px"] = err_after
        self.last_result = result
        self.logger.debug(
            "local BA over %d KFs: reproj %.3fpx -> %.3fpx", len(all_kfs), err_before, err_after
        )
