"""Loop detection + closure.

A working implementation of the reference's declared-but-absent loop closing
(visual_slam/loop_closing/base.py is 0 bytes; slam.py:44 sets
``loop_closing = None``; README.md:47 lists it as not implemented).

Detection is brute-force descriptor place recognition, the fixed-shape
choice: the query keyframe's packed descriptors are matched against EVERY
candidate keyframe in ONE batched matmul Hamming program
(``match_descriptors_batched`` — candidate blocks stacked and padded to a
power-of-two bucket, so dispatch count is O(1) and recompiles are
log-bounded regardless of map size). Candidates are gated to exclude the
recent window, scored by ratio-test match count; the top-2 scorers are
geometrically verified with the PnP solver against their landmarks. Success
yields a corrected relative-pose edge, a measured relative scale (median
depth ratio over PnP-inlier landmark pairs — stabler than a baseline ratio),
and a Sim(3) essential-graph optimization over odometry + covisibility +
loop edges, then (optional) global BA.
"""
from __future__ import annotations

import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..map import KeyFrame, Map
from ..ops.matching import match_descriptors_batched
from ..ops.pnp import ransac_pnp
from ..ops.projection import normalize_points
from .pose_graph import (
    build_sequential_graph,
    build_sim3_graph,
    optimize_pose_graph,
    optimize_sim3_graph,
)


def _bucket(n: int, floor: int = 64) -> int:
    """Next power-of-two capacity >= n (recompile ladder for the candidate
    batch axis). Floor 64: padded candidates cost one near-free masked matmul
    each, while every ladder rung below costs a full recompile of the batched
    matcher — 4 recompiles saved on a typical growing map (measured 3.7 s/KF
    of detection overhead on the CPU test rig, dominated by exactly these)."""
    c = floor
    while c < n:
        c *= 2
    return c


class LoopClosing:
    def __init__(
        self,
        slam_map: Map,
        camera,
        config,
        optimizer=None,
        min_gap: int = 10,
        min_matches: int = 40,
        min_inliers: int = 20,
        cooldown: int = 10,
        logger: Optional[logging.Logger] = None,
    ):
        self.map = slam_map
        self.camera = camera
        self.config = config
        self.optimizer = optimizer
        self.min_gap = min_gap  # exclude this many most-recent KFs
        self.min_matches = min_matches
        self.min_inliers = min_inliers
        self.logger = logger or logging.getLogger("loop_closing")
        self._key = jax.random.PRNGKey(99)
        self.closed_loops: list[tuple[int, int]] = []
        # Suppress detection for ``cooldown`` keyframes after a closure
        # (ORB-SLAM's mnLastLoopKFid guard): one revisit should correct the
        # map once, not re-trigger pose-graph + global BA on every
        # subsequent keyframe of the overlap.
        self.cooldown = cooldown
        self._last_closed_kf_id: int = -(1 << 30)
        # kf_id -> (desc, valid, angle) numpy blocks (features are immutable)
        self._feat_cache: dict[int, tuple] = {}
        # O(1)-per-keyframe place recognition: compact global signature per
        # keyframe (loop_closing/signature.py). The host-side signature
        # table shortlists candidates so the batched geometric matcher runs
        # on a CONSTANT candidate bucket regardless of map size (instead of
        # O(#keyframes) detection compute + cache).
        self.shortlist_size = int(
            getattr(config.loop_closing, "shortlist_size", 8) or 8
        )
        self.use_signature = bool(
            getattr(config.loop_closing, "use_signature", True)
        )
        self._sig_table: dict[int, np.ndarray] = {}  # kf_id -> (V,)

    def note_signature(self, kf_id: int, sig: "np.ndarray") -> None:
        """Record an externally computed global signature for ``kf_id``.

        The devpromo chunk computes promoted frames' signatures on device
        inside the compact boundary fetch (pipeline.CompactChunk.sig), so
        detection's query signature is a cache hit instead of a dedicated
        device round trip."""
        self._sig_table[int(kf_id)] = np.asarray(sig, np.float32)

    # -- detection ---------------------------------------------------------
    def detect(self, kf: KeyFrame) -> Optional[dict]:
        """Best verified loop candidate for ``kf``, or None.

        One batched device dispatch scores every candidate; the top-2 by
        ratio-test match count are geometrically verified in order (a single
        bad ratio-test winner must not kill detection for the keyframe)."""
        kfs = self.map.get_keyframes()
        # Evict cache entries for culled/fused keyframes (amortized: only
        # when the dead fraction is noticeable — long runs otherwise leak
        # host memory and pay signature-stack cost for dead IDs).
        if len(self._sig_table) > len(kfs) + 64 or (
            len(self._feat_cache) > len(kfs) + 64
        ):
            live = {k.keyframe_id for k in kfs}
            for table in (self._sig_table, self._feat_cache):
                for kf_id in [k for k in table if k not in live]:
                    del table[kf_id]
        if len(kfs) <= self.min_gap + 1:
            return None
        candidates = [
            k for k in kfs[: -self.min_gap]
            if k.keyframe_id != kf.keyframe_id and k.get_features(0) is not None
        ]
        if not candidates:
            return None
        f_q = kf.get_features(0)
        if self.use_signature:
            candidates = self._signature_shortlist(kf, candidates)
            if not candidates:
                return None
        C = len(candidates)
        Cpad = _bucket(C)
        # Keyframe feature blocks are immutable: materialize each candidate's
        # device arrays to host ONCE (a blocking device->host copy costs a
        # full round trip on remote-attached devices; re-fetching 3 arrays
        # per candidate per keyframe scaled O(map size) dispatches).
        feats = []
        for c in candidates:
            cached = self._feat_cache.get(c.keyframe_id)
            if cached is None:
                fc = c.get_features(0)
                cached = (
                    np.asarray(fc.desc), np.asarray(fc.valid), np.asarray(fc.angle)
                )
                self._feat_cache[c.keyframe_id] = cached
            feats.append(cached)
        pad = Cpad - C
        desc_c = np.stack([f[0] for f in feats] + [feats[0][0]] * pad)
        valid_c = np.stack([f[1] for f in feats] + [np.zeros_like(feats[0][1])] * pad)
        angle_c = np.stack([f[2] for f in feats] + [feats[0][2]] * pad)
        res = match_descriptors_batched(
            f_q.desc, jnp.asarray(desc_c), f_q.valid, jnp.asarray(valid_c),
            f_q.angle, jnp.asarray(angle_c),
            ratio=0.75, cross_check=True, use_orientation=True,
        )
        counts = np.asarray(res["n_matches"])[:C]
        train_idx = np.asarray(res["train_idx"])[:C]
        match_ok = np.asarray(res["valid"])[:C]
        order = np.argsort(-counts)
        for rank in order[:2]:
            n = int(counts[rank])
            if n < self.min_matches:
                break
            cand = candidates[rank]
            verified = self._verify(kf, cand, train_idx[rank], match_ok[rank])
            if verified is not None:
                verified.update({"candidate": cand, "n_matches": n})
                return verified
        return None

    def _signature_shortlist(
        self, kf: KeyFrame, candidates: list[KeyFrame]
    ) -> list[KeyFrame]:
        """Top-``shortlist_size`` candidates by global-signature similarity.

        Signatures are computed once per keyframe (one tiny device program,
        loop_closing/signature.py) and scored host-side with a (V,) . (V, N)
        matvec — flat per-keyframe cost at any map size. Missing signatures
        (resumed maps, keyframes predating enablement) are backfilled in one
        vmapped dispatch."""
        from .signature import batch_signatures, keyframe_signature, score_signatures

        missing = [c for c in candidates if c.keyframe_id not in self._sig_table]
        if missing:
            descs = np.stack([c.descriptors(0) for c in missing])
            valids = np.stack([c.valid_mask(0) for c in missing])
            for c, sig in zip(missing, batch_signatures(descs, valids)):
                self._sig_table[c.keyframe_id] = sig
        q = self._sig_table.get(kf.keyframe_id)
        if q is None:
            f_q = kf.get_features(0)
            q = np.asarray(keyframe_signature(f_q.desc, f_q.valid))
            self._sig_table[kf.keyframe_id] = q
        table = np.stack([self._sig_table[c.keyframe_id] for c in candidates])
        scores = score_signatures(q, table)  # centered cosine (idf analogue)
        top = np.argsort(-scores)[: self.shortlist_size]
        return [candidates[int(i)] for i in top]

    def _verify(
        self, kf: KeyFrame, cand: KeyFrame, train_idx: np.ndarray, match_ok: np.ndarray
    ) -> Optional[dict]:
        """Geometric verification: PnP of kf's keypoints against cand's
        landmarks -> corrected T_kf_w2c in the candidate's frame, plus the
        measured relative map scale (median depth ratio over inlier pairs
        where kf has its own landmark for the matched feature)."""
        pos, has = cand.point_arrays(0)
        ti = np.asarray(train_idx)
        ok = np.asarray(match_ok) & has[ti]
        if ok.sum() < self.min_inliers:
            return None
        pts3d = pos[ti]
        f_q = kf.get_features(0)
        Kinv = jnp.asarray(self.camera.Kinv, jnp.float32)
        xy_norm = normalize_points(Kinv, f_q.xy)
        self._key, sub = jax.random.split(self._key)
        pnp = ransac_pnp(
            jnp.asarray(pts3d, jnp.float32), xy_norm, jnp.asarray(ok), sub,
            n_hyp=256, thresh=3.0 / self.camera.fx,
        )
        n_inl = int(pnp["n_inliers"])
        if not bool(pnp["ok"]) or n_inl < self.min_inliers:
            return None
        T_corrected = np.asarray(pnp["T"], np.float64)
        inliers = np.asarray(pnp["inliers"])
        s_meas = self._measure_scale(kf, pts3d, inliers, T_corrected)
        return {"T_kf_corrected": T_corrected, "n_inliers": n_inl, "s_meas": s_meas}

    def _measure_scale(
        self, kf: KeyFrame, pts3d: np.ndarray, inliers: np.ndarray, T_corr: np.ndarray
    ) -> Optional[float]:
        """Relative map scale at kf vs the candidate: for every PnP-inlier
        feature of kf that also has its OWN landmark (triangulated at the
        drifted local scale), the ratio of its depth through kf's drifted
        pose to the matched candidate landmark's depth through the corrected
        pose measures the accumulated drift factor; the median over pairs is
        robust to individual triangulation errors. None if too few pairs
        (caller falls back to the baseline ratio)."""
        T_d = np.asarray(kf.T_w2c, np.float64)
        ratios = []
        for q in np.nonzero(inliers)[0]:
            mp_own = kf.get_map_point(0, int(q))
            if mp_own is None or mp_own.is_bad:
                continue
            z_own = (T_d[:3, :3] @ mp_own.position + T_d[:3, 3])[2]
            z_cand = (T_corr[:3, :3] @ pts3d[q] + T_corr[:3, 3])[2]
            if z_own > 1e-6 and z_cand > 1e-6:
                ratios.append(z_own / z_cand)
        if len(ratios) >= 5:
            return float(np.clip(np.median(ratios), 0.2, 5.0))
        return None

    # -- closure -----------------------------------------------------------
    def _covisibility_edges(
        self,
        kfs: list[KeyFrame],
        min_shared: int = 15,
        max_weight_at: int = 50,
        max_span: int = 10,
    ) -> list[tuple[int, int, float]]:
        """Non-sequential covisibility pairs (row indices) weighted by shared
        landmark count — the essential-graph edges that distribute loop error
        through the map instead of only along the odometry chain.

        Pairs are limited to a temporal span: a covisibility edge carries the
        CURRENT (drifted) relative pose at relative scale 1 as its
        measurement, which is only trustworthy between temporally-near
        keyframes (little accumulated drift between them). A distant
        covisible pair is a previous loop — its constraint belongs in a loop
        edge with a measured scale, not here, where its scale-1 drifted
        measurement would fight the closure."""
        row_of = {k.keyframe_id: r for r, k in enumerate(kfs)}
        counts: dict[tuple[int, int], int] = {}
        for mp in self.map.get_map_points():
            if mp.is_bad:
                continue
            rows = sorted({row_of[k] for k in mp.observations.get_keyframe_ids() if k in row_of})
            for a in range(len(rows)):
                for b in range(a + 1, len(rows)):
                    if rows[b] - rows[a] > max_span:
                        continue
                    key = (rows[a], rows[b])
                    counts[key] = counts.get(key, 0) + 1
        # Weight: covisibility strength, discounted by 1/sqrt(span) — drift
        # noise in the scale-1 measurement accumulates with temporal span, so
        # a longer-range edge carries proportionally less information.
        return [
            (i, j, min(1.0, c / max_weight_at) / float(np.sqrt(j - i)))
            for (i, j), c in counts.items()
            if c >= min_shared and j - i > 1
        ]

    def close(self, kf: KeyFrame, detection: dict, use_sim3: bool = True) -> dict:
        """Apply a verified loop: Sim(3) essential-graph optimization over
        all keyframes (odometry chain + covisibility edges + the loop edge),
        then optional global BA.

        Landmark correction follows the ORB-SLAM CorrectLoop recipe for this
        graph's node semantics (see optimize_sim3_graph): a landmark anchored
        at keyframe r is taken to r's OLD camera frame, its camera-frame
        coordinates DIVIDE by r's optimized node scale (the accumulated drift
        factor — dividing deflates drift-inflated local structure), then map
        out through r's corrected SE(3) pose. This is reprojection-exact at
        the anchor view.
        """
        kfs = self.map.get_keyframes()
        idx = {k.keyframe_id: i for i, k in enumerate(kfs)}
        i = idx[kf.keyframe_id]
        j = idx[detection["candidate"].keyframe_id]
        # Edge measurement: corrected relative pose T_i @ inv(T_j) with the
        # PnP-corrected pose for node i.
        T_i_corr = detection["T_kf_corrected"]
        T_j = kfs[j].T_w2c
        T_meas = T_i_corr @ np.linalg.inv(T_j)
        poses = np.stack([k.T_w2c for k in kfs]).astype(np.float32)

        s_meas = detection.get("s_meas")
        if s_meas is None:
            # Fallback: drifted-vs-corrected baseline ratio (coarser — used
            # only when too few landmark pairs exist for the depth median).
            # The ratio is only a scale estimate when the corrected baseline
            # is an appreciable length: a revisit AT the candidate viewpoint
            # has d_corr ~ 0 and the ratio measures drift distance, not
            # scale — default to 1 there (observed: an unguarded ratio hit
            # the 5.0 clip and warped a consistent map by 20x reprojection).
            def center(T):
                return -T[:3, :3].T @ T[:3, 3]

            centers = np.stack([center(k.T_w2c) for k in kfs])
            med_baseline = float(
                np.median(np.linalg.norm(np.diff(centers, axis=0), axis=-1))
            ) if len(kfs) > 1 else 0.0
            d_drift = float(np.linalg.norm(center(kfs[i].T_w2c) - center(T_j)))
            d_corr = float(np.linalg.norm(center(T_i_corr) - center(T_j)))
            if d_corr > max(0.5 * med_baseline, 1e-6):
                s_meas = float(np.clip(d_drift / d_corr, 0.2, 5.0))
            else:
                s_meas = 1.0

        covis = self._covisibility_edges(kfs)
        if use_sim3:
            graph = build_sim3_graph(
                poses, loop_edges=[(i, j, T_meas, s_meas)], covis_edges=covis
            )
            T_opt, scales, info = optimize_sim3_graph(graph, n_iter=15)
            scales = np.asarray(scales, np.float64)
        else:
            graph = build_sequential_graph(
                poses, loop_edges=[(i, j, T_meas)] + [
                    # Covisibility edges keep their own (discounted) weights;
                    # at the 5.0 loop weight dozens of drifted covis
                    # measurements would drown the single loop constraint.
                    (a, b, poses[a] @ np.linalg.inv(poses[b]), wt)
                    for a, b, wt in covis
                ],
            )
            T_opt, info = optimize_pose_graph(graph, n_iter=15)
            scales = np.ones(len(kfs))
        T_opt = np.asarray(T_opt, np.float64)

        # Landmark correction (anchor = first observing keyframe).
        kf_row = {k.keyframe_id: r for r, k in enumerate(kfs)}
        T_old = poses.astype(np.float64)
        corrected = 0
        for mp in self.map.get_map_points():
            if mp.is_bad:
                continue
            obs_kfs = mp.observations.get_keyframe_ids()
            rows = [kf_row[k] for k in obs_kfs if k in kf_row]
            if not rows:
                continue
            r = min(rows)  # first (oldest) observing keyframe
            x_cam = T_old[r, :3, :3] @ mp.position + T_old[r, :3, 3]
            x_cam /= scales[r]
            R_new = T_opt[r, :3, :3]
            X_new = R_new.T @ (x_cam - T_opt[r, :3, 3])
            mp.update_position(X_new)
            corrected += 1

        for k, kfr in enumerate(kfs):
            kfr.update_pose(T_opt[k])
        self.closed_loops.append((kf.keyframe_id, detection["candidate"].keyframe_id))
        self._last_closed_kf_id = kf.keyframe_id
        self.logger.info(
            "closed loop %d -> %d (%d inliers, s_meas %.3f, %d covis edges); "
            "pose-graph cost %.5f",
            kf.keyframe_id, detection["candidate"].keyframe_id,
            detection["n_inliers"], s_meas, len(covis), float(info["cost"]),
        )
        result = {
            "pose_graph_cost": float(info["cost"]),
            "loop": (i, j),
            "scale_meas": s_meas,
            "covis_edges": len(covis),
            "landmarks_corrected": corrected,
        }
        if self.optimizer is not None:
            result["global_ba"] = self.map.optimize_global(self.optimizer)
        return result

    def process_keyframe(self, kf: KeyFrame) -> Optional[dict]:
        if kf.keyframe_id - self._last_closed_kf_id < self.cooldown:
            return None
        det = self.detect(kf)
        if det is None:
            return None
        return self.close(kf, det)
