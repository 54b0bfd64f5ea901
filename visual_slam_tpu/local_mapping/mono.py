"""Monocular keyframe handler: neighbour matching + new-landmark triangulation.

API parity with the reference MonoKeyframeHandler
(visual_slam/local_mapping/mono.py:21-258): find the last-N neighbour
keyframes, match the new keyframe against each, reuse the neighbour's map
points (adding observations on the new KF), and triangulate brand-new
landmarks from the remaining matches with depth + parallax gates. All
geometry runs as jitted fixed-shape ops; only the observation bookkeeping is
host-side dict updates.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..map import KeyFrame, MapPoint
from ..ops import triangulation as tri_ops
from ..ops.projection import normalize_points
from .base import BaseKeyframeHandler


class MonoKeyframeHandler(BaseKeyframeHandler):
    def process_keyframe(self, kf: KeyFrame) -> dict:
        neighbors = self._find_neighbors(kf)
        stats = {"reused": 0, "triangulated": 0, "neighbors": len(neighbors)}
        for nb in neighbors:
            r = self._match(kf, nb)
            if r is None:
                continue
            reused, tri_pairs = self._process_existing_points(kf, nb, r)
            created = self._triangulate_new_points(kf, nb, r, tri_pairs)
            stats["reused"] += reused
            stats["triangulated"] += created
        self.logger.debug(
            "KF %d: +%d reused, +%d new landmarks from %d neighbors",
            kf.keyframe_id, stats["reused"], stats["triangulated"], stats["neighbors"],
        )
        return stats

    def _find_neighbors(self, kf: KeyFrame) -> list[KeyFrame]:
        """Last max_neighbors keyframes, excluding kf itself (reference
        mono.py:28-34; the new KF is inserted after processing so the list
        naturally contains only predecessors — we exclude defensively)."""
        n = self.config.local_mapping.max_neighbors
        kfs = [k for k in self.map.get_keyframes() if k.keyframe_id != kf.keyframe_id]
        return kfs[-n:]

    def _match(self, kf: KeyFrame, nb: KeyFrame):
        """(reference mono.py:36-80 — note the reference accidentally drops
        its nested filter kwargs; here the tracker's configured chain runs)"""
        f1 = kf.get_features(0)
        f2 = nb.get_features(0)
        if f1 is None or f2 is None:
            return None
        return self.tracker.match(f1, f2)

    def _process_existing_points(self, kf: KeyFrame, nb: KeyFrame, r):
        """Reuse neighbour landmarks; FUSE duplicates (a descriptor match
        whose two sides carry different landmarks is one physical point
        tracked twice — ORB-SLAM's Fuse step, absent in the reference, so
        its duplicates accumulate); collect pairs needing triangulation
        (reference mono.py:82-124). Returns (n_reused, [(i_kf, i_nb), ...])."""
        reused = 0
        tri_pairs: list[tuple[int, int]] = []
        ti = np.asarray(r.train_idx)
        ok = np.asarray(r.valid)
        for i_kf in np.nonzero(ok)[0]:
            i_nb = int(ti[i_kf])
            mp = nb.get_map_point(0, i_nb)
            mp_kf = kf.get_map_point(0, int(i_kf))
            if mp is not None and not mp.is_bad:
                if mp_kf is None:
                    kf.add_map_point(0, int(i_kf), mp)
                    reused += 1
                elif mp_kf is not mp and not mp_kf.is_bad:
                    # Geometric gate: only fuse when the two estimates agree
                    # to ~10% of their distance from the keyframe (a badly
                    # triangulated twin should be culled, not merged).
                    d = float(np.linalg.norm(mp.position - mp_kf.position))
                    depth = float(
                        np.linalg.norm(mp.position - kf.camera_center)
                    )
                    if d <= 0.1 * max(depth, 1e-6):
                        keep, drop = (
                            (mp, mp_kf)
                            if mp.num_observations() >= mp_kf.num_observations()
                            else (mp_kf, mp)
                        )
                        self.map.fuse_map_points(keep, drop)
            elif mp_kf is None:
                tri_pairs.append((int(i_kf), i_nb))
        return reused, tri_pairs

    def _triangulate_new_points(self, kf: KeyFrame, nb: KeyFrame, r, tri_pairs) -> int:
        """(reference mono.py:126-258)

        The pair arrays are PADDED to the fixed per-frame feature capacity:
        a dynamic pair count would give every keyframe a fresh jit shape and
        a fresh multi-second compile."""
        if len(tri_pairs) < 2:
            return 0
        lcfg = self.config.local_mapping
        cap = int(r.features1.xy.shape[0])
        n = min(len(tri_pairs), cap)
        idx_kf = np.zeros(cap, np.int32)
        idx_nb = np.zeros(cap, np.int32)
        pair_mask = np.zeros(cap, bool)
        idx_kf[:n] = [p[0] for p in tri_pairs[:n]]
        idx_nb[:n] = [p[1] for p in tri_pairs[:n]]
        pair_mask[:n] = True
        Kinv = jnp.asarray(self.camera.Kinv, jnp.float32)
        x_kf = normalize_points(Kinv, r.features1.xy[jnp.asarray(idx_kf)])
        x_nb = normalize_points(Kinv, r.features2.xy[jnp.asarray(idx_nb)])
        T_kf = jnp.asarray(kf.T_w2c, jnp.float32)
        T_nb = jnp.asarray(nb.T_w2c, jnp.float32)
        pts3d, w_ok = tri_ops.triangulate_dlt(
            tri_ops.projection_from_T(T_nb), tri_ops.projection_from_T(T_kf), x_nb, x_kf
        )
        good = w_ok & tri_ops.depth_mask(T_nb, T_kf, pts3d, lcfg.min_depth, lcfg.max_depth)
        par = tri_ops.parallax_angles(T_nb, T_kf, pts3d)
        good &= par >= jnp.deg2rad(lcfg.min_parallax_deg)
        good_np = np.asarray(good) & pair_mask
        pts_np = np.asarray(pts3d)
        img = nb.get_image(0)
        xy_nb = np.asarray(r.features2.xy)
        desc_nb = np.asarray(r.features2.desc)
        created = 0
        for n in np.nonzero(good_np)[0]:
            i_kf, i_nb = tri_pairs[n]
            color = _pixel_color(img, xy_nb[i_nb])
            mp = MapPoint(pts_np[n], color=color, descriptor=desc_nb[i_nb])
            nb.add_map_point(0, i_nb, mp)
            kf.add_map_point(0, i_kf, mp)
            self.map.add_map_point(mp)
            created += 1
        return created


def _pixel_color(img, xy):
    if img is None:
        return np.array([128, 128, 128], np.uint8)
    x = int(np.clip(xy[0], 0, img.shape[1] - 1))
    y = int(np.clip(xy[1], 0, img.shape[0] - 1))
    px = img[y, x]
    if np.ndim(px) == 0:
        return np.array([px, px, px], np.uint8)
    return np.asarray(px, np.uint8)
