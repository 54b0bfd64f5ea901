"""Optimizer facade: packs host map objects into fixed-shape BAProblems,
runs the jitted LM/Schur solver, writes results back.

API parity with the reference optimizer stack
(visual_slam/optimization/base_optimizer.py:11-50 ABC;
torch_optimizer.py TorchOptimizer): ``optimize_initial`` (two-view),
``optimize_local`` (window), ``optimize_global`` (all keyframes — a real
implementation, unlike the reference's ``pass`` stub, torch_optimizer.py:
319-320). A gradient-descent fallback (optax Adam over the same residual
model) is provided for parity experiments with the reference's optimizer.

Shapes are bucketed (windows to multiples of the configured window size,
landmarks to powers of two) so each bucket compiles once.
"""
from __future__ import annotations

import abc
import logging
from typing import List, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from ..config import Config
from ..map.keyframe import KeyFrame
from ..map.map_point import MapPoint
from .ba import (
    BAProblem,
    BASparse,
    bundle_adjust_robust,
    bundle_adjust_robust_lm,
    bundle_adjust_robust_sparse,
)


class BaseOptimizer(abc.ABC):
    """(reference base_optimizer.py:11-50)"""

    def __init__(self, config: Config, camera, logger: logging.Logger | None = None):
        self.config = config
        self.camera = camera
        self.logger = logger or logging.getLogger(self.__class__.__name__)

    @abc.abstractmethod
    def optimize_initial(self, keyframes: Sequence[KeyFrame]) -> dict: ...

    @abc.abstractmethod
    def optimize_local(
        self, keyframes: Sequence[KeyFrame], map_points: Sequence[MapPoint]
    ) -> dict: ...

    @abc.abstractmethod
    def optimize_global(
        self, keyframes: Sequence[KeyFrame], map_points: Sequence[MapPoint]
    ) -> dict: ...


def _next_pow2(n: int, lo: int = 64) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def _bucket4(n: int, lo: int) -> int:
    """Next bucket in a x4 ladder (lo, 4lo, 16lo, ...). Every BA shape is a
    separate compile, so shape buckets must be few: a x4 ladder gives at most 4 distinct landmark
    shapes across a map growing 64 -> 16384."""
    v = lo
    while v < n:
        v *= 4
    return v


class LMOptimizer(BaseOptimizer):
    """Levenberg-Marquardt + Schur bundle adjustment (the primary solver)."""

    def _pack(
        self,
        keyframes: List[KeyFrame],
        map_points: List[MapPoint],
        w_bucket: int,
        m_bucket: int,
        fixed_flags: List[bool],
    ):
        W = w_bucket
        M = m_bucket
        Kmat = np.asarray(self.camera.K, np.float64)
        Kinv = np.linalg.inv(Kmat)
        kf_slot = {kf.keyframe_id: j for j, kf in enumerate(keyframes)}

        T = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
        pose_valid = np.zeros(W, bool)
        for j, kf in enumerate(keyframes):
            T[j] = kf.T_w2c
            pose_valid[j] = True

        pts = np.zeros((M, 3), np.float32)
        uv = np.zeros((M, W, 2), np.float32)
        obs_valid = np.zeros((M, W), bool)
        # Slot index of each packed observation, for O(#removed) culling in
        # the writeback (a dense per-obs Python loop was a large host cost
        # per boundary; the loops below only collect indices).
        kp_of = np.full((M, W), -1, np.int32)
        used_points: List[MapPoint] = list(map_points[:M])
        ii: List[int] = []
        jj: List[int] = []
        kk: List[int] = []
        for i, mp in enumerate(used_points):
            pts[i] = mp.position
            for kf_id, cam_id, kp_idx in mp.observations.items():
                j = kf_slot.get(kf_id)
                if j is None or cam_id != 0:
                    continue
                ii.append(i)
                jj.append(j)
                kk.append(kp_idx)
        if ii:
            ia = np.asarray(ii)
            ja = np.asarray(jj)
            ka = np.asarray(kk)
            kp_all = np.stack([kf.keypoints(0) for kf in keyframes])  # (Wr, K, 2)
            uv_pix = kp_all[ja, ka]
            uv[ia, ja] = uv_pix @ Kinv[:2, :2].T + Kinv[:2, 2]
            obs_valid[ia, ja] = True
            kp_of[ia, ja] = ka

        pose_fixed = np.zeros(W, bool)
        for j, fx in enumerate(fixed_flags):
            pose_fixed[j] = fx
        problem = BAProblem(
            T_w2c=jnp.asarray(T),
            points=jnp.asarray(pts),
            uv=jnp.asarray(uv),
            obs_valid=jnp.asarray(obs_valid),
            pose_valid=jnp.asarray(pose_valid),
            pose_fixed=jnp.asarray(pose_fixed),
        )
        return problem, used_points, kf_slot, obs_valid, kp_of

    def _pack_sparse(
        self,
        keyframes: List[KeyFrame],
        map_points: List[MapPoint],
        w_bucket: int,
        m_bucket: int,
        fixed_flags: List[bool],
    ):
        """Landmark-major pack: K observation slots per landmark
        (backend/ba.py BASparse) instead of the dense (M, W) grid. Landmarks
        with more than K observations inside the window keep an evenly-spread
        subset for this solve (geometry-preserving; count logged)."""
        W = w_bucket
        M = m_bucket
        K = self.config.optimization.obs_cap
        Kmat = np.asarray(self.camera.K, np.float64)
        Kinv = np.linalg.inv(Kmat)
        kf_slot = {kf.keyframe_id: j for j, kf in enumerate(keyframes)}

        T = np.tile(np.eye(4, dtype=np.float32), (W, 1, 1))
        pose_valid = np.zeros(W, bool)
        for j, kf in enumerate(keyframes):
            T[j] = kf.T_w2c
            pose_valid[j] = True

        pts = np.zeros((M, 3), np.float32)
        uv = np.zeros((M, K, 2), np.float32)
        obs_pose = np.zeros((M, K), np.int32)
        obs_valid = np.zeros((M, K), bool)
        kp_of = np.full((M, K), -1, np.int32)
        used_points: List[MapPoint] = list(map_points[:M])
        ii: List[int] = []
        ss: List[int] = []
        jj: List[int] = []
        kk: List[int] = []
        n_over = 0
        for i, mp in enumerate(used_points):
            pts[i] = mp.position
            obs: List[tuple] = []
            for kf_id, cam_id, kp_idx in mp.observations.items():
                j = kf_slot.get(kf_id)
                if j is None or cam_id != 0:
                    continue
                obs.append((j, kp_idx))
            if len(obs) > K:
                n_over += 1
                sel = np.unique(
                    np.round(np.linspace(0, len(obs) - 1, K)).astype(int)
                )
                obs = [obs[q] for q in sel]
            for k, (j, kp_idx) in enumerate(obs):
                ii.append(i)
                ss.append(k)
                jj.append(j)
                kk.append(kp_idx)
        if n_over:
            self.logger.debug(
                "sparse BA pack: %d landmarks exceed obs_cap=%d this window "
                "(evenly-spread subset kept)", n_over, K,
            )
        if ii:
            ia = np.asarray(ii)
            sa = np.asarray(ss)
            ja = np.asarray(jj)
            ka = np.asarray(kk)
            kp_all = np.stack([kf.keypoints(0) for kf in keyframes])
            uv_pix = kp_all[ja, ka]
            uv[ia, sa] = uv_pix @ Kinv[:2, :2].T + Kinv[:2, 2]
            obs_pose[ia, sa] = ja
            obs_valid[ia, sa] = True
            kp_of[ia, sa] = ka

        pose_fixed = np.zeros(W, bool)
        for j, fx in enumerate(fixed_flags):
            pose_fixed[j] = fx
        problem = BASparse(
            T_w2c=jnp.asarray(T),
            points=jnp.asarray(pts),
            uv=jnp.asarray(uv),
            obs_pose=jnp.asarray(obs_pose),
            obs_valid=jnp.asarray(obs_valid),
            pose_valid=jnp.asarray(pose_valid),
            pose_fixed=jnp.asarray(pose_fixed),
        )
        return problem, used_points, kf_slot, obs_valid, kp_of, obs_pose

    def _select_points(self, map_points, cap: int):
        """Respect the landmark cap by keeping the BEST-OBSERVED points, not
        a positional prefix, and say so (no silent caps): dropped landmarks
        are neither optimized nor outlier-trimmed this solve."""
        if len(map_points) <= cap:
            return map_points
        ranked = sorted(map_points, key=lambda mp: -mp.num_observations())
        self.logger.warning(
            "BA landmark cap: optimizing the %d best-observed of %d landmarks "
            "(%d dropped this solve; raise config.optimization.max_points to "
            "include them)", cap, len(map_points), len(map_points) - cap,
        )
        return ranked[:cap]

    @staticmethod
    def _reimpose_mono_gauge(T_np, X_np, keyframes, fixed_flags):
        """Mono gauge re-projection: with only KF0 fixed, SCALE is a null
        direction of the cost and f32 LM steps random-walk along it (observed
        as abrupt map-scale halvings). A similarity about KF0's camera center
        leaves every reprojection invariant, so re-impose the pre-solve
        KF0->KF1 baseline length exactly. Mutates T_np in place; returns the
        re-scaled X_np plus the applied similarity as (s, b) with
        x -> s*x + b (None if nothing was applied) so callers can version it
        on the map (Map.record_gauge_transform) for in-flight pose catch-up.
        Every solver's global BA must apply this (CLAUDE.md)."""
        def center(Tm):
            return -Tm[:3, :3].T @ Tm[:3, 3]

        C0 = center(T_np[0])
        d_before = np.linalg.norm(
            np.asarray(keyframes[1].t_c2w) - np.asarray(keyframes[0].t_c2w)
        )
        d_after = np.linalg.norm(center(T_np[1]) - C0)
        if d_after > 1e-9 and d_before > 1e-9:
            s = d_before / d_after
            for j in range(len(keyframes)):
                if fixed_flags[j]:
                    continue
                Cj = C0 + s * (center(T_np[j]) - C0)
                T_np[j, :3, 3] = -T_np[j, :3, :3] @ Cj
            X_np = C0 + s * (X_np - C0)
            return X_np, (s, (1.0 - s) * C0)
        return X_np, None

    def solve_start(
        self, keyframes, map_points, w_bucket, fixed_flags=None,
        renormalize_scale=False,
    ):
        """Pack + DISPATCH the LM/Schur solve without waiting. Returns an
        opaque pending handle for :meth:`solve_finish`. Lets a caller
        overlap the device solve with subsequent tracking and apply the
        writeback at its next keyframe boundary (a synchronous solve puts
        its device round trips inside the boundary's critical path)."""
        cfg = self.config.optimization
        if fixed_flags is None:
            # Gauge: first KF frozen (reference torch_optimizer.py:54-57).
            fixed_flags = [j == 0 for j in range(len(keyframes))]
        map_points = self._select_points(map_points, cfg.max_points)
        m_bucket = min(
            _bucket4(len(map_points), lo=cfg.point_bucket_floor),
            max(cfg.max_points, cfg.point_bucket_floor),
        )
        focal = float(self.camera.K[0, 0])
        n1 = max(cfg.n_iter // 2, 1)
        # Every distinct (W, M) pair is a separate XLA compile: record them
        # so a bench/run can PROVE it stayed in one bucket.
        if not hasattr(self, "shapes_seen"):
            self.shapes_seen = set()
        self.shapes_seen.add((w_bucket, m_bucket))
        if cfg.sparse_obs == "auto":
            use_sparse = w_bucket >= cfg.sparse_auto_min_window
        else:
            use_sparse = bool(cfg.sparse_obs)
        if use_sparse:
            problem, used_points, kf_slot, packed_valid, kp_of, obs_pose = (
                self._pack_sparse(
                    keyframes, map_points, w_bucket, m_bucket, fixed_flags
                )
            )
            T, X, info = bundle_adjust_robust_sparse(
                problem,
                n_iter=n1,
                n_iter2=max(cfg.n_iter - n1, 1),
                huber=cfg.huber_delta / focal,
                lam0=cfg.lm_lambda0,
                trim_factor=3.0,
            )
        else:
            problem, used_points, kf_slot, packed_valid, kp_of = self._pack(
                keyframes, map_points, w_bucket, m_bucket, fixed_flags
            )
            obs_pose = None
            solve = (
                bundle_adjust_robust_lm if cfg.lm_minor
                else bundle_adjust_robust
            )
            T, X, info = solve(
                problem,
                n_iter=n1,
                n_iter2=max(cfg.n_iter - n1, 1),
                huber=cfg.huber_delta / focal,
                lam0=cfg.lm_lambda0,
                trim_factor=3.0,
            )
        return {
            "T": T, "X": X, "info": info,
            "keyframes": list(keyframes), "used_points": used_points,
            "kf_slot": kf_slot, "packed_valid": packed_valid, "kp_of": kp_of,
            "obs_pose": obs_pose,
            "fixed_flags": fixed_flags, "renormalize_scale": renormalize_scale,
        }

    def solve_finish(self, pending: dict) -> dict:
        """Fetch + write back a :meth:`solve_start` dispatch. Keyframes or
        landmarks culled in the meantime are written harmlessly (dead
        objects) — the map reads only live ones."""
        import jax

        keyframes = pending["keyframes"]
        used_points = pending["used_points"]
        kf_slot = pending["kf_slot"]
        packed_valid = pending["packed_valid"]
        kp_of = pending["kp_of"]
        fixed_flags = pending["fixed_flags"]
        renormalize_scale = pending["renormalize_scale"]
        # One batched fetch for poses, landmarks, and solver info.
        T_np, X_np, info = jax.device_get(
            (pending["T"], pending["X"], pending["info"])
        )
        T_np = np.array(T_np)  # writable (gauge re-projection mutates)
        X_np = np.array(X_np)
        gauge_transform = None
        if renormalize_scale and len(keyframes) >= 2:
            X_np, gauge_transform = self._reimpose_mono_gauge(
                T_np, X_np, keyframes, fixed_flags
            )
        for j, kf in enumerate(keyframes):
            if not kf.is_fixed and not fixed_flags[j]:
                kf.update_pose(T_np[j].astype(np.float64))
        X64 = X_np.astype(np.float64)
        for i, mp in enumerate(used_points):
            mp.position = X64[i]
        # Drop observations the solver rejected (real implementation of the
        # reference's cull_bad_points stub, local_handler.py:79-80). Only
        # the REMOVED set is iterated — typically a handful per solve.
        removed = packed_valid & ~np.asarray(info["obs_kept"])
        obs_pose = pending["obs_pose"]

        def _remove_if_current(kf, kp_idx: int, mp) -> None:
            # Async-solve guard: between pack and writeback, landmark FUSION
            # (or a relinked association) may have re-pointed this keypoint
            # slot at a DIFFERENT landmark — removing it then deletes a good
            # link made after the snapshot (observed as the threaded-mode
            # ATE tail). Only remove the link the solver actually judged.
            if kf.get_map_point(0, kp_idx) is mp:
                kf.remove_map_point(0, kp_idx)

        if obs_pose is not None:  # sparse (M, K) layout: pose slot per obs
            for i, k in zip(*np.nonzero(removed)):
                _remove_if_current(
                    keyframes[int(obs_pose[i, k])], int(kp_of[i, k]),
                    used_points[i],
                )
        else:
            for i, j in zip(*np.nonzero(removed)):
                _remove_if_current(keyframes[j], int(kp_of[i, j]), used_points[i])
        for i in set(np.nonzero(removed)[0].tolist()):
            # Only fully orphaned landmarks die here: single-observation
            # points still serve PnP tracking, and keyframe culling may
            # legitimately reduce a good landmark to one observation.
            if used_points[i].num_observations() < 1:
                used_points[i].set_bad()
        return {
            "cost0": float(info["cost0"]),
            "cost": float(info["cost"]),
            "n_trimmed": int(info["n_trimmed"]),
            "n_points": len(used_points),
            "n_keyframes": len(keyframes),
            "gauge_transform": gauge_transform,
        }

    def _solve_and_writeback(
        self, keyframes, map_points, w_bucket, fixed_flags=None,
        renormalize_scale=False,
    ):
        return self.solve_finish(self.solve_start(
            keyframes, map_points, w_bucket,
            fixed_flags=fixed_flags, renormalize_scale=renormalize_scale,
        ))

    def _cap_anchors(self, anchors, window, pts):
        """Bound out-of-window fixed anchors so the pose bucket never grows
        past ``pose_bucket_floor`` at sequence scale: every bucket rung is a
        fresh multi-second compile, and on a long run the set of old keyframes
        observing window landmarks grows without bound. Keeps the anchors
        sharing the MOST observations with the window's landmarks (they
        constrain the landmark updates best); says what it dropped."""
        cap = max(0, self.config.optimization.pose_bucket_floor - len(window))
        if len(anchors) <= cap:
            return anchors
        counts = {a.keyframe_id: 0 for a in anchors}
        for mp in pts:
            for kf_id in mp.observations.get_keyframe_ids():
                if kf_id in counts:
                    counts[kf_id] += 1
        kept = sorted(anchors, key=lambda a: -counts[a.keyframe_id])[:cap]
        self.logger.debug(
            "BA anchor cap: keeping the %d best-connected of %d anchors "
            "(pose bucket held at %d)", cap, len(anchors),
            self.config.optimization.pose_bucket_floor,
        )
        return kept

    # -- public entry points ------------------------------------------------
    def optimize_initial(self, keyframes):
        kfs = list(keyframes)
        if len(kfs) < 2:
            return {"skipped": True}
        points = {}
        for kf in kfs:
            for mp in list(kf.map_points.values()):
                if not mp.is_bad:
                    points[mp.id] = mp
        if len(points) < 10:  # (reference torch_optimizer.py:99-101 bails <10 obs)
            return {"skipped": True}
        # No scale renormalization here: the 20-iteration two-view solve
        # barely moves the gauge, and A/B runs showed re-pinning the
        # pre-solve baseline only perturbs downstream keyframe decisions.
        return self._solve_and_writeback(kfs, list(points.values()), w_bucket=2)

    def optimize_local(self, keyframes, map_points, fixed_keyframes=()):
        """Window BA. ``fixed_keyframes`` are out-of-window anchors that
        observe window landmarks: they join the problem with frozen poses so
        landmark updates stay consistent with the rest of the map (the
        ORB-SLAM local-BA structure; absent in the reference)."""
        kfs = list(keyframes)
        anchors = [kf for kf in fixed_keyframes if kf not in kfs]
        pts = [mp for mp in map_points if not mp.is_bad]
        if len(kfs) < 2 or len(pts) < 10:
            return {"skipped": True}
        anchors = self._cap_anchors(anchors, kfs, pts)
        all_kfs = anchors + kfs
        fixed = [True] * len(anchors) + [False] * len(kfs)
        if not anchors:
            fixed[0] = True  # gauge
        w_bucket = _bucket4(
            max(self.config.optimization.window_size, len(all_kfs)),
            lo=self.config.optimization.pose_bucket_floor,
        )
        return self._solve_and_writeback(all_kfs, pts, w_bucket=w_bucket, fixed_flags=fixed)

    def optimize_local_start(self, keyframes, map_points, fixed_keyframes=()):
        """Async variant of :meth:`optimize_local`: dispatch only; finish
        with :meth:`solve_finish`. Returns None when skipped."""
        kfs = list(keyframes)
        anchors = [kf for kf in fixed_keyframes if kf not in kfs]
        pts = [mp for mp in map_points if not mp.is_bad]
        if len(kfs) < 2 or len(pts) < 10:
            return None
        anchors = self._cap_anchors(anchors, kfs, pts)
        all_kfs = anchors + kfs
        fixed = [True] * len(anchors) + [False] * len(kfs)
        if not anchors:
            fixed[0] = True
        w_bucket = _bucket4(
            max(self.config.optimization.window_size, len(all_kfs)),
            lo=self.config.optimization.pose_bucket_floor,
        )
        return self.solve_start(all_kfs, pts, w_bucket=w_bucket, fixed_flags=fixed)

    def optimize_global_start(self, keyframes, map_points):
        """Async variant of :meth:`optimize_global` (gauge renormalization
        happens at finish). Returns None when skipped."""
        kfs = list(keyframes)
        pts = [mp for mp in map_points if not mp.is_bad]
        if len(kfs) < 2 or len(pts) < 10:
            return None
        w_bucket = _bucket4(len(kfs), lo=self.config.optimization.pose_bucket_floor)
        return self.solve_start(kfs, pts, w_bucket=w_bucket, renormalize_scale=True)

    def optimize_global(self, keyframes, map_points):
        kfs = list(keyframes)
        pts = [mp for mp in map_points if not mp.is_bad]
        if len(kfs) < 2 or len(pts) < 10:
            return {"skipped": True}
        w_bucket = _bucket4(len(kfs), lo=self.config.optimization.pose_bucket_floor)
        return self._solve_and_writeback(
            kfs, pts, w_bucket=w_bucket, renormalize_scale=True
        )
