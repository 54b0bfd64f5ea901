"""CompiledSLAM: the full SLAM system built around the fused device-resident
tracking step.

The flexible host pipeline (slam.SLAM) issues several device calls per frame;
this variant issues exactly ONE per tracked frame — pipeline.track_step — and
reuses its outputs (features, matches, PnP inliers) for keyframe promotion,
so the per-frame cost equals the benchmark path. Two design rules keep the
device pipeline full:

* The step itself carries the local-map association: a device-resident
  landmark arena (positions + descriptors) is projection-guided-matched
  inside the compiled program (ops.guided_matching), so tracking uses the
  whole local map — not just the reference keyframe block — with zero extra
  dispatches (the ORB-SLAM "track local map" stage; the reference tracks
  against the latest keyframe only, visual_slam/tracking.py:331-413).
* Host decisions (keyframe promotion, LOST) read the PREVIOUS frame's
  scalars, which are already materialized by the time the next frame is
  submitted — no per-frame device->host sync stalls the pipeline. Per-frame
  poses are kept as device arrays and materialized lazily (trajectory()).

Host work happens only at keyframe boundaries: landmark inheritance from the
guided/reference associations, fixed-shape triangulation of new landmarks
against the previous keyframe, bucketed LM/Schur bundle adjustment, and a
reference + arena swap.

This is the deployment configuration for the "full pipeline at sensor rate"
workload (BASELINE config 4).
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..backend.optimizer import LMOptimizer
from ..camera import PinholeCamera
from ..config import Config
from ..map import Frame, KeyFrame, Map, MapPoint
from ..ops import triangulation as tri_ops
from ..ops.projection import normalize_points
from ..pipeline import (
    PromoteRecord,
    TrackOutput,
    apply_correction,
    correction_similarity,
    init_track_state,
    make_track_chunk,
    make_track_chunk_promote,
    make_track_step,
    set_local_map,
    swap_reference,
)
from ..state import State
from ..utils.logging import get_logger


class CompiledSLAM:
    def __init__(
        self,
        camera: PinholeCamera,
        config: Config | None = None,
        log_dir: str | None = None,
    ):
        self.camera = camera
        self.config = config or Config()
        self.logger = get_logger("compiled_slam", log_dir)
        fcfg = self.config.feature
        from ..ops import orb as _orb

        _orb.set_ragged_descriptors(fcfg.ragged_descriptors)
        tcfg = self.config.tracking
        self.map = Map(max_frames=self.config.map.max_frames)
        self.optimizer = LMOptimizer(self.config, camera, logger=self.logger)
        self.state = State.NO_IMAGES_YET
        self._arena_size = int(tcfg.local_map_size)
        # Rectified-stereo deployment: the step takes a (2, H, W) pair,
        # measures per-keypoint depth in-program, and solves depth-aware PnP
        # (pipeline.make_track_step stereo variant).
        self._stereo = (
            self.config.camera.sensor_type == "stereo"
            and tcfg.use_depth_residual
            and float(getattr(camera, "baseline", 0.0)) > 0
        )
        self._step = make_track_step(
            jnp.asarray(camera.K, jnp.float32),
            num_features=fcfg.num_features,
            fast_threshold=fcfg.fast_threshold,
            n_levels=fcfg.num_pyramid_levels,
            scale=fcfg.scale_factor,
            grid=fcfg.grid_cells,
            ratio=tcfg.match_ratio,
            pnp_hypotheses=tcfg.pnp_hypotheses,
            pnp_threshold_px=tcfg.pnp_threshold_px,
            local_map=self._arena_size > 0,
            width=camera.width,
            height=camera.height,
            guided_radius_px=tcfg.guided_radius_px,
            guided_ratio=tcfg.guided_ratio,
            stereo=self._stereo,
            baseline=float(getattr(camera, "baseline", 0.0)),
            stereo_row_tolerance=tcfg.stereo_row_tolerance,
            min_depth=self.config.local_mapping.min_depth,
        )
        self._track_state = None
        self._frames_since_kf = 0
        # Pose blocks: (timestamps tuple, T_w2c device array ((4,4) single
        # frame or (C,4,4) chunk), ref keyframe, ref pose snapshot). Chunked
        # tracking appends one block per chunk so recording a chunk costs
        # zero extra dispatches.
        self.poses: list[tuple[tuple, object, object, object]] = []
        # Multi-frame chunking: scan the fused step over chunk_size frames
        # per dispatch (pipeline.make_track_chunk). Host decisions move to
        # chunk boundaries; per-dispatch latency amortizes 1/C.
        self._chunk_size = max(1, int(tcfg.chunk_size))
        # In-chunk device-side promotion: the chunk swaps its own reference
        # on the keyframe gates, so chunk_size can exceed the sequence's
        # match-decay horizon (see make_track_chunk_promote). Stereo chunks
        # mint reference landmarks from their own disparity depths (r4).
        self._dev_promo = (
            bool(tcfg.device_promotion)
            and self._chunk_size > 1
        )
        lcfg = self.config.local_mapping
        if self._chunk_size <= 1:
            self._chunk = None
        elif self._dev_promo:
            self._chunk = make_track_chunk_promote(
                self._step,
                jnp.asarray(camera.K, jnp.float32),
                min_inliers=tcfg.min_inliers,
                keyframe_interval=tcfg.keyframe_interval,
                kf_min_matches=tcfg.kf_min_matches,
                kf_min_rotation_deg=tcfg.kf_min_rotation_deg,
                kf_min_translation=tcfg.kf_min_translation,
                min_depth=lcfg.min_depth,
                max_depth=lcfg.max_depth,
                min_parallax_deg=lcfg.min_parallax_deg,
                pnp_threshold_px=tcfg.pnp_threshold_px,
                stereo=self._stereo,
            )
        else:
            self._chunk = make_track_chunk(self._step)
        # Slim boundary fetch (devpromo only): gather scalars + promoted-
        # frame blocks on device, sync the compact struct instead of the
        # full stacked chunk output (config.tracking.compact_fetch_promos).
        self._compact_P = int(getattr(tcfg, "compact_fetch_promos", 0))
        if self._dev_promo and self._compact_P > 0:
            from ..pipeline import make_compact_chunk

            self._compact_fn = make_compact_chunk(
                self._compact_P,
                with_sig=bool(self.config.loop_closing.enabled),
            )
        else:
            self._compact_fn = None
        self._chunk_buf: list[tuple[object, float]] = []  # (img_host, ts)
        self._promos_since_heavy = 0
        # Async heavy boundaries (config.tracking.async_boundary): the solve
        # dispatched at one boundary finishes at the next; fsr/T_ref chain
        # device-side so no host re-seed sits between chunks.
        self._async_mode = bool(getattr(tcfg, "async_boundary", False)) and self._dev_promo
        self._async_bnd: Optional[dict] = None
        self._async_cooloff = 0  # sync boundaries left after thin tracking
        self._prev_chunk_async = False
        self._dev_fsr = None
        self._dev_T_ref = None
        # Previous frame's step output, deferred for the host decision:
        # (out, timestamp, ref_kf, arena) — ref/arena AT SUBMIT TIME, so a
        # promotion triggered by an older frame cannot misalign the indices.
        self._pending = None
        self._lm_arena: list[Optional[MapPoint]] = []
        # In-flight keyframe-boundary BA (config.optimization.async_ba):
        # dispatched at one boundary, written back at the next.
        self._ba_pending = None
        # Bootstrap reuses the host initializer (runs once).
        from ..frontend.tracker import FeatureTracker
        from ..initializer import Initializer

        self._feature_tracker = FeatureTracker(fcfg)
        self._initializer = Initializer(
            camera, self.config, self._feature_tracker, self.map, logger=self.logger
        )
        self._initializer.optimizer = self.optimizer
        # Loop closing operates on the same Map the compiled path maintains
        # (keyframes + landmarks), so the host component plugs in directly.
        if self.config.loop_closing.enabled:
            from ..loop_closing import LoopClosing

            self.loop_closing = LoopClosing(
                self.map, camera, self.config, optimizer=self.optimizer,
                logger=self.logger,
            )
        else:
            self.loop_closing = None

    # ------------------------------------------------------------------ API
    def track(self, images, timestamp: float, depth=None) -> dict:
        imgs = list(images) if isinstance(images, (list, tuple)) else [images]
        if self.state == State.LOST:
            return self._relocalize(imgs, timestamp)
        if self.state != State.OK:
            return self._bootstrap(imgs, timestamp, depth)
        if self._chunk is not None:
            return self._track_chunked(imgs, timestamp)
        return self._track_compiled(imgs, timestamp)

    def _img_arg(self, imgs):
        if self._stereo:
            if len(imgs) < 2:
                raise ValueError(
                    "stereo-configured CompiledSLAM needs [left, right] images"
                )
            return jnp.stack([jnp.asarray(imgs[0]), jnp.asarray(imgs[1])])
        # Dtype is preserved (uint8 uploads 4x less than f32; the detector
        # casts on device). Keep one dtype across a run — each is a compile.
        return jnp.asarray(imgs[0])

    def flush(self) -> dict:
        """Apply the deferred decision for the last submitted frame (call at
        sequence end so the final keyframe/LOST decision is not dropped)."""
        info = {}
        if self._chunk_buf:
            info = self._run_chunk()
        if self._pending is not None:
            pending, self._pending = self._pending, None
            info = self._decide(*pending)
        self._finish_async_solve(correct_device=True)
        return info

    def trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """Materialize per-frame poses: (timestamps (N,), T_w2c (N, 4, 4)).
        One stacked device->host transfer, not N (each transfer is a full
        round trip on remote-attached devices).

        Each frame is anchored to its reference keyframe: the recorded pose
        is recomposed as T_rel(at track time) @ T_ref(now), so windowed-BA
        refinements and loop-closure corrections applied to keyframes AFTER
        the frame was tracked propagate into the trajectory (the ORB-SLAM
        relative-trajectory recovery)."""
        self._apply_pending_ba()  # final refinement lands before export
        if not self.poses:
            return np.zeros(0), np.zeros((0, 4, 4))
        ts = np.asarray([t for blk in self.poses for t in blk[0]])
        parts = [T if T.ndim == 3 else T[None] for (_, T, _, _) in self.poses]
        Ts = np.asarray(jnp.concatenate(parts, axis=0), np.float64)
        out = np.empty_like(Ts)
        i = 0
        for (ts_blk, _, ref_kf, T_ref_snap) in self.poses:
            n = len(ts_blk)
            if ref_kf is None:
                out[i : i + n] = Ts[i : i + n]
            else:
                T_rel = Ts[i : i + n] @ np.linalg.inv(T_ref_snap)[None]
                out[i : i + n] = T_rel @ ref_kf.T_w2c[None]
            i += n
        return ts, out

    def shutdown(self) -> None:
        self.flush()
        self._apply_pending_ba()
        self.logger.info(
            "shutdown: %d keyframes, %d landmarks, %d frame poses",
            self.map.num_keyframes(), self.map.num_map_points(), self.num_frames_tracked(),
        )

    def num_frames_tracked(self) -> int:
        return sum(len(blk[0]) for blk in self.poses)

    def metrics(self) -> dict:
        return {
            "state": self.state.name,
            "num_keyframes": self.map.num_keyframes(),
            "num_map_points": self.map.num_map_points(),
            "num_frames": self.num_frames_tracked(),
        }

    def save(self, path) -> None:
        """Checkpoint map + the materialized trajectory (SLAM.save parity)."""
        import json
        from pathlib import Path

        from ..utils.serialization import save_map

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        save_map(self.map, path / "map.npz")
        ts, Ts = self.trajectory()
        np.savez_compressed(path / "trajectory.npz", ts=ts, T_w2c=Ts)
        meta = {"state": self.state.name, "config": self.config.to_dict()}
        (path / "slam.json").write_text(json.dumps(meta, indent=2))

    @classmethod
    def resume(cls, path, camera, log_dir: str | None = None) -> "CompiledSLAM":
        """Restore a checkpointed system: the map is reloaded, the compiled
        step's reference block + landmark arena reinstalled from the last
        keyframe, and tracking continues from its pose."""
        import json
        from pathlib import Path

        from ..utils.serialization import load_map

        path = Path(path)
        meta = json.loads((path / "slam.json").read_text())
        cfg = Config.from_dict(meta["config"])
        slam = cls(camera, cfg, log_dir=log_dir)
        slam.map = load_map(path / "map.npz")
        slam._initializer.map = slam.map
        if slam.loop_closing is not None:
            slam.loop_closing.map = slam.map
        kf = slam.map.get_last_keyframe()
        if kf is not None and meta["state"] in ("OK", "MAPPING"):
            slam.state = State.OK
            slam._initializer.initialized = True
            slam._install_reference(kf, T_init=kf.T_w2c)
        traj = path / "trajectory.npz"
        if traj.exists():
            z = np.load(traj)
            for t, T in zip(z["ts"], z["T_w2c"]):
                slam.poses.append(((float(t),), jnp.asarray(T, jnp.float32), None, None))
        return slam

    # ----------------------------------------------------------- bootstrap
    def _bootstrap(self, imgs, timestamp, depth) -> dict:
        self.state = State.INITIALIZING
        if self._initializer.initialize(imgs, timestamp, depth):
            self.state = State.OK
            kf = self.map.get_last_keyframe()
            self._install_reference(kf, T_init=kf.T_w2c)
            self.poses.append(
                ((timestamp,), jnp.asarray(kf.T_w2c, jnp.float32), kf, kf.T_w2c.copy())
            )
        return {"state": self.state.name}

    def _relocalize(self, imgs, timestamp) -> dict:
        """LOST recovery: retry the compiled step against each recent
        keyframe's reference block (the step IS a PnP relocalization when
        given a candidate reference). On failure the pre-attempt reference is
        restored so tracking state never points at a failed candidate."""
        tcfg = self.config.tracking
        orig_ref = getattr(self, "_ref_kf", None)
        orig_state = self._track_state
        for kf in reversed(self.map.get_keyframes()[-5:]):
            self._install_reference(kf, T_init=kf.T_w2c)
            self._track_state, out = self._step(self._track_state, self._img_arg(imgs))
            n_inl = int(out.n_inliers)
            if n_inl >= tcfg.min_inliers:
                self.state = State.OK
                T = np.asarray(out.T_w2c, np.float64)
                self.poses.append(((timestamp,), out.T_w2c, kf, kf.T_w2c.copy()))
                self._pending = None
                # Extend the map immediately: the relocalized frame becomes a
                # keyframe so subsequent frames track fresh geometry instead
                # of the stale pre-loss blocks (same fix as the host path —
                # without it tracking re-dies as the camera moves on).
                self._promote_keyframe(out, timestamp, kf, self._lm_arena)
                self.logger.info("relocalized against KF %d (%d inliers)",
                                 kf.keyframe_id, n_inl)
                return {"state": self.state.name, "relocalized": True,
                        "n_inliers": n_inl, "T_w2c": T}
        if orig_ref is not None:
            self._track_state = orig_state
            self._ref_kf = orig_ref
        return {"state": self.state.name, "relocalized": False}

    def _install_reference(self, kf: KeyFrame, T_init: np.ndarray) -> None:
        import jax

        # A pending async solve targeted the carry this install is about to
        # rebuild from host data: land its writeback on the host map first
        # and drop the (now moot) device correction.
        self._finish_async_solve(correct_device=False)
        pos, mask = kf.point_arrays(0)
        # Upload the reference block ONCE: keyframes store host-materialized
        # features (see _promote_keyframe), and numpy leaves left in the
        # track-state pytree would re-upload on every dispatch.
        feats = jax.tree.map(jnp.asarray, kf.get_features(0))
        if self._track_state is None:
            self._track_state = init_track_state(
                feats, pos, mask, T_init, local_map_size=self._arena_size
            )
        else:
            self._track_state = swap_reference(self._track_state, feats, pos, mask)
            self._track_state = self._track_state._replace(
                T_w2c=jnp.asarray(T_init, jnp.float32)
            )
        self._ref_kf = kf
        # Device-chained promotion bookkeeping restarts at the installed
        # reference (async boundaries never re-seed these from the host).
        self._dev_fsr = jnp.int32(0)
        self._dev_T_ref = jnp.asarray(T_init, jnp.float32)
        if self._arena_size:
            self._refresh_arena()

    def _refresh_arena(self) -> None:
        """Fill the device landmark arena with the local map: landmarks
        observed by the most recent keyframes, best-observed first."""
        M = self._arena_size
        seen: dict[int, MapPoint] = {}
        for kf in reversed(self.map.get_keyframes()[-8:]):
            for mp in list(kf.map_points.values()):
                if not mp.is_bad and mp.id not in seen:
                    seen[mp.id] = mp
            if len(seen) >= M:
                break
        arena = sorted(seen.values(), key=lambda mp: -mp.num_observations())[:M]
        pos = np.zeros((M, 3), np.float32)
        desc = np.zeros((M, 8), np.uint32)
        valid = np.zeros((M,), bool)
        for r, mp in enumerate(arena):
            pos[r] = mp.position
            if mp.descriptor is not None:
                desc[r] = np.asarray(mp.descriptor).reshape(-1)[:8]
                valid[r] = True
        self._lm_arena = arena
        self._track_state = set_local_map(self._track_state, pos, desc, valid)

    # ------------------------------------------------------- steady state
    def _track_compiled(self, imgs, timestamp) -> dict:
        self._track_state, out = self._step(self._track_state, self._img_arg(imgs))
        self.poses.append(
            ((timestamp,), out.T_w2c, self._ref_kf, self._ref_kf.T_w2c.copy())
        )
        self._frames_since_kf += 1
        info = {"state": self.state.name}
        # Start the decision scalars' device->host copies NOW, so by the
        # time the next frame's call reads them they are already local (a
        # synchronous fetch costs a full round trip on remote devices).
        for arr in (out.n_inliers, out.n_matches, out.T_w2c):
            copy_async = getattr(arr, "copy_to_host_async", None)
            if copy_async is not None:
                copy_async()
        # Decide on the PREVIOUS frame (its scalars are already on host-
        # reachable memory; converting them does not stall the device).
        pending, self._pending = self._pending, (
            out, timestamp, self._ref_kf, self._lm_arena
        )
        if pending is not None:
            info.update(self._decide(*pending))
        return info

    def _img_buf(self, imgs):
        """Per-frame chunk-buffer entry: kept on HOST so the whole chunk
        uploads as ONE stacked transfer (C separate uploads pay C transfer
        submissions; one (C, H, W) transfer pays one)."""
        import jax

        if self._stereo:
            if len(imgs) < 2:
                raise ValueError(
                    "stereo-configured CompiledSLAM needs [left, right] images"
                )
            l, r = imgs[0], imgs[1]
            if isinstance(l, jax.Array) or isinstance(r, jax.Array):
                return jnp.stack([jnp.asarray(l), jnp.asarray(r)])
            return np.stack([self._upload_cast(l), self._upload_cast(r)])
        return self._upload_cast(imgs[0])

    def _upload_cast(self, im):
        """Float frames upload as f16 (half the transfer bytes; ~0.12-gray-level
        quantization preserves the anti-aliased edge texture u8 rounding
        destroys — config.tracking.upload_f16). Integer frames pass through
        (u8 is already the cheapest). The detector casts to f32 on device."""
        if (
            getattr(self.config.tracking, "upload_f16", False)
            and isinstance(im, np.ndarray)
            and im.dtype in (np.float32, np.float64)
        ):
            return im.astype(np.float16)
        return im

    def _stack_imgs(self, imgs):
        import jax

        if any(isinstance(im, jax.Array) for im in imgs):
            return jnp.stack([jnp.asarray(im) for im in imgs])
        return jnp.asarray(np.stack(imgs))

    def _track_chunked(self, imgs, timestamp: float) -> dict:
        """Buffer frames; every chunk_size-th frame runs the whole chunk in
        ONE device dispatch (lax.scan over the fused step)."""
        self._chunk_buf.append((self._img_buf(imgs), timestamp))
        if len(self._chunk_buf) < self._chunk_size:
            return {"state": self.state.name, "buffered": len(self._chunk_buf)}
        return self._run_chunk()

    def _run_chunk(self) -> dict:
        import jax

        buf, self._chunk_buf = self._chunk_buf, []
        n = len(buf)
        imgs = [im for im, _ in buf]
        while len(imgs) < self._chunk_size:  # flush pads; padded outs ignored
            imgs.append(imgs[-1])
        if self._dev_promo:
            if self._use_async_boundary():
                if not self._prev_chunk_async:
                    # sync -> async transition: the sync path host-seeds
                    # fsr/T_ref every chunk and DISCARDS the device chain;
                    # re-seed it from the host's (authoritative) values.
                    self._dev_fsr = jnp.int32(self._frames_since_kf)
                    self._dev_T_ref = jnp.asarray(
                        self._ref_kf.T_w2c, jnp.float32
                    )
                self._prev_chunk_async = True
                return self._run_chunk_devpromo_async(imgs, buf, n)
            self._prev_chunk_async = False
            # async -> sync fallback: land any in-flight solve (writeback +
            # device correction) BEFORE this chunk dispatches, so the sync
            # chunk runs in the post-solve world.
            if self._async_bnd is not None:
                self._finish_async_solve(correct_device=True)
            return self._run_chunk_devpromo(imgs, buf, n)
        ref_kf, arena = self._ref_kf, self._lm_arena
        T_ref_snap = ref_kf.T_w2c.copy()
        self._track_state, outs = self._chunk(
            self._track_state, self._stack_imgs(imgs)
        )
        ts_tuple = tuple(t for _, t in buf)
        T_block = outs.T_w2c if n == self._chunk_size else outs.T_w2c[:n]
        self.poses.append((ts_tuple, T_block, ref_kf, T_ref_snap))
        self._frames_since_kf += n

        # ONE sync per chunk: fetch the ENTIRE stacked output (a couple MB)
        # in one round trip rather than one per value, so the decision scalars,
        # the promotion frame's features/matches, and the brute-recovery
        # fallback all read from this single host copy.
        outs = jax.device_get(outs)
        n_inl_all = np.asarray(outs.n_inliers)[:n]
        T_all = np.asarray(outs.T_w2c)
        self.logger.debug(
            "chunk: inliers %s matches %s guided %s",
            n_inl_all.tolist(), np.asarray(outs.n_matches)[:n].tolist(),
            np.asarray(outs.guided_valid)[:n].sum(axis=-1).tolist(),
        )
        tcfg = self.config.tracking
        last = n - 1
        info = {
            "state": self.state.name,
            "n_inliers": int(n_inl_all[last]),
            "chunk_frames": n,
        }
        # Keyframe trigger, evaluated BEFORE the lost check: promotion picks
        # the LATEST healthy frame of the chunk, so a mid-chunk inlier cliff
        # (reference gone stale) is answered with a fresh reference instead
        # of LOST — the chunk-mode analogue of the per-frame path promoting
        # the still-healthy pending frame when the newest is about to die.
        healthy = n_inl_all >= tcfg.min_inliers
        T_last = np.asarray(T_all[last], np.float64)
        rot_deg = trans = 0.0
        if ref_kf is not None:
            R_rel = T_last[:3, :3] @ ref_kf.R_w2c.T
            c = np.clip((np.trace(R_rel) - 1.0) / 2.0, -1.0, 1.0)
            rot_deg = float(np.degrees(np.arccos(c)))
            C_last = -T_last[:3, :3].T @ T_last[:3, 3]
            trans = float(np.linalg.norm(C_last - ref_kf.camera_center))
        trigger = (
            self._frames_since_kf > tcfg.keyframe_interval
            or int(n_inl_all.min()) < tcfg.kf_min_matches
            or rot_deg > tcfg.kf_min_rotation_deg
            or trans > tcfg.kf_min_translation
        )
        if trigger and healthy.any():
            j_star = int(np.nonzero(healthy)[0][-1])
            out_j = jax.tree.map(lambda a: a[j_star], outs)
            heavy = (
                tcfg.heavy_boundary_every <= 1
                or self._promos_since_heavy + 1 >= tcfg.heavy_boundary_every
                or int(n_inl_all[last]) < tcfg.kf_min_matches
            )
            self._promote_keyframe(
                out_j, ts_tuple[j_star], ref_kf, arena, heavy=heavy
            )
            self._promos_since_heavy = 0 if heavy else self._promos_since_heavy + 1
            # Frames after j_star stay tracked against the old reference;
            # they count toward the next interval.
            self._frames_since_kf = last - j_star
            if j_star != last:
                # The promoted frame is NOT the newest: _install_reference
                # reset the track-state pose to the keyframe's, which would
                # rewind (last - j_star) frames of camera motion and throw
                # the next chunk's motion prediction off by meters (observed
                # on the bench: guided search missed, inliers collapsed to
                # 2, LOST). Keep the newest frame's pose, carried through
                # whatever correction BA/loop closing applied to the new
                # keyframe: T_state = T_last @ inv(T_kf_old) @ T_kf_new.
                kf_new = self.map.get_last_keyframe()
                T_kf_old = np.asarray(T_all[j_star], np.float64)
                T_state = (
                    np.asarray(T_all[last], np.float64)
                    @ np.linalg.inv(T_kf_old)
                    @ kf_new.T_w2c
                )
                self._track_state = self._track_state._replace(
                    T_w2c=jnp.asarray(T_state, jnp.float32)
                )
            info["new_keyframe"] = True
            self.logger.debug(
                "chunk promoted frame %d/%d, inliers %s",
                j_star, n, n_inl_all.tolist(),
            )
            return info
        if not healthy[last]:
            out_last = jax.tree.map(lambda a: a[last], outs)
            rec = self._brute_recover(out_last, ts_tuple[-1])
            if rec is not None:
                info.update(rec)
                return info
            self.state = State.LOST
            info["state"] = self.state.name
            self.logger.warning(
                "compiled tracking lost (chunk, %d inliers)", int(n_inl_all[last])
            )
        return info

    def _use_async_boundary(self) -> bool:
        """Async boundaries only on a MATURE map and outside the thin-
        tracking cooloff (config.tracking.async_boundary_min_kfs /
        async_boundary_cooloff — see config.py for the failure mode)."""
        if not self._async_mode:
            return False
        tcfg = self.config.tracking
        if self.map.num_keyframes() < getattr(tcfg, "async_boundary_min_kfs", 12):
            return False
        if self._async_cooloff > 0:
            self._async_cooloff -= 1
            return False
        return True

    def _run_chunk_devpromo(self, imgs, buf, n: int) -> dict:
        """Chunk boundary for the device-self-promoting chunk
        (pipeline.make_track_chunk_promote): the device already swapped its
        reference at every triggered frame; the host replays the emitted
        PromoteRecords into Map keyframes/landmarks (no extra dispatches),
        runs BA on the heavy cadence, and re-installs a corrected state
        only when BA actually moved the map — a light boundary costs pure
        host object work and zero device round trips beyond the chunk's
        single output fetch."""
        import jax

        ref_kf, arena = self._ref_kf, self._lm_arena
        T_ref_snap = ref_kf.T_w2c.copy()
        self._track_state, _fsr, _T_ref, outs, recs = self._chunk(
            self._track_state,
            np.int32(self._frames_since_kf),
            np.asarray(ref_kf.T_w2c, np.float32),
            self._stack_imgs(imgs),
            n_valid=n,
        )
        ts_tuple = tuple(t for _, t in buf)
        T_block = outs.T_w2c if n == self._chunk_size else outs.T_w2c[:n]
        self.poses.append((ts_tuple, T_block, ref_kf, T_ref_snap))

        # ONE sync per chunk. With compact fetch the sync moves only the
        # decision scalars + the promoted frames' blocks (device-gathered by
        # pipeline.make_compact_chunk); the full stacked output is fetched
        # only on slot overflow or brute recovery (both rare).
        comp = None
        outs_h = recs_h = None
        if self._compact_fn is not None:
            comp = jax.device_get(self._compact_fn(outs, recs))
            if int(comp.n_promoted) > self._compact_P:
                self.logger.debug(
                    "compact fetch overflow (%d promos > %d slots): full fetch",
                    int(comp.n_promoted), self._compact_P,
                )
                outs_h, recs_h = jax.device_get((outs, recs))
                comp = None
        else:
            outs_h, recs_h = jax.device_get((outs, recs))
        if comp is not None:
            n_inl_all = np.asarray(comp.n_inliers)[:n]
            promoted = np.asarray(comp.promoted)[:n]
            T_all_np = np.asarray(comp.T_w2c)
        else:
            n_inl_all = np.asarray(outs_h.n_inliers)[:n]
            promoted = np.asarray(recs_h.promoted)[:n]
            T_all_np = np.asarray(outs_h.T_w2c)
        tcfg = self.config.tracking
        last = n - 1
        info = {
            "state": self.state.name,
            "n_inliers": int(n_inl_all[last]),
            "chunk_frames": n,
        }
        self.logger.debug(
            "chunk(devpromo): inliers %s promoted %s",
            n_inl_all.tolist(), np.nonzero(promoted)[0].tolist(),
        )
        promo_idx = np.nonzero(promoted)[0]
        cur_ref = ref_kf
        new_kfs = []
        for s, f in enumerate(promo_idx):
            if comp is not None:
                # Slot s of the compact struct is the s-th promoted frame
                # (device-side sort by frame index matches promo_idx order).
                out_f = TrackOutput(
                    T_w2c=T_all_np[f],
                    n_inliers=n_inl_all[f],
                    n_matches=np.asarray(comp.n_matches)[f],
                    features=jax.tree.map(lambda a: a[s], comp.feats),
                    match_train_idx=np.asarray(comp.match_train_idx)[s],
                    match_valid=np.asarray(comp.match_valid)[s],
                    pnp_inliers=np.asarray(comp.pnp_inliers)[s],
                    guided_idx=np.asarray(comp.guided_idx)[s],
                    guided_valid=np.asarray(comp.guided_valid)[s],
                )
                rec_f = PromoteRecord(
                    promoted=True,
                    ref_pos=np.asarray(comp.ref_pos)[s],
                    ref_has=np.asarray(comp.ref_has)[s],
                    ref_tri=np.asarray(comp.ref_tri)[s],
                )
            else:
                out_f = jax.tree.map(lambda a: a[f], outs_h)
                rec_f = jax.tree.map(lambda a: a[f], recs_h)
            kf = self._adopt_device_keyframe(
                out_f, rec_f, ts_tuple[f], cur_ref, arena
            )
            if comp is not None and self.loop_closing is not None:
                # Signature came back in the same fused fetch: detection's
                # query lookup is now a host cache hit (no extra RT).
                self.loop_closing.note_signature(
                    kf.keyframe_id, np.asarray(comp.sig)[s]
                )
            new_kfs.append(kf)
            cur_ref = kf
        if new_kfs:
            kf_last = new_kfs[-1]
            self._frames_since_kf = last - int(promo_idx[-1])
            self._enforce_budget()
            heavy = (
                tcfg.heavy_boundary_every <= 1
                or self._promos_since_heavy + len(new_kfs)
                >= tcfg.heavy_boundary_every
            )
            if heavy:
                self._promos_since_heavy = 0
                self._boundary_heavy(kf_last)
                # BA/loop closing moved poses+landmarks: re-install the
                # corrected reference + fresh arena, carrying the newest
                # frame's pose through the keyframe's correction (an
                # uncorrected reset rewinds the motion model by the frames
                # tracked since promotion — observed death spiral).
                self._install_reference(kf_last, T_init=kf_last.T_w2c)
                T_kf_old = np.asarray(T_all_np[promo_idx[-1]], np.float64)
                T_state = (
                    np.asarray(T_all_np[last], np.float64)
                    @ np.linalg.inv(T_kf_old)
                    @ kf_last.T_w2c
                )
                self._track_state = self._track_state._replace(
                    T_w2c=jnp.asarray(T_state, jnp.float32)
                )
            else:
                # Light boundary: the device state is already correct (it
                # promoted itself); only host bookkeeping moves.
                self._promos_since_heavy += len(new_kfs)
                self._ref_kf = kf_last
            info["new_keyframe"] = True
        else:
            self._frames_since_kf += n
        if n_inl_all[last] < tcfg.min_inliers:
            if outs_h is None:
                # Compact path: recovery needs the last frame's full block —
                # fetch it now (failure path only; not worth widening the
                # steady-state sync for).
                out_last = jax.device_get(jax.tree.map(lambda a: a[last], outs))
            else:
                out_last = jax.tree.map(lambda a: a[last], outs_h)
            rec = self._brute_recover(out_last, ts_tuple[-1])
            if rec is not None:
                info.update(rec)
                return info
            self.state = State.LOST
            info["state"] = self.state.name
            self.logger.warning(
                "compiled tracking lost (devpromo chunk, %d inliers)",
                int(n_inl_all[last]),
            )
        return info

    def _run_chunk_devpromo_async(self, imgs, buf, n: int) -> dict:
        """Async-boundary devpromo chunk: the heavy solve dispatched at the
        PREVIOUS boundary finishes here (its results are already resident —
        the serial device ran it before this chunk), the device carry is
        re-anchored into the post-solve world by one correction dispatch
        (pipeline.apply_correction — no sync, the self-promoted reference
        features stay), and this boundary's own solve is dispatched to
        finish at the NEXT one. Critical path per boundary: chunk compute +
        one slim fetch + host bookkeeping; solve compute and its fetch ride
        the gaps."""
        import jax

        ref_kf, arena = self._ref_kf, self._lm_arena
        T_ref_snap = ref_kf.T_w2c.copy()
        # fsr/T_ref chain on DEVICE between chunks (corrected along with the
        # carry); the host never re-seeds them in steady state.
        self._track_state, self._dev_fsr, self._dev_T_ref, outs, recs = self._chunk(
            self._track_state, self._dev_fsr, self._dev_T_ref,
            self._stack_imgs(imgs), n_valid=n,
        )
        ts_tuple = tuple(t for _, t in buf)
        T_block = outs.T_w2c if n == self._chunk_size else outs.T_w2c[:n]
        self.poses.append((ts_tuple, T_block, ref_kf, T_ref_snap))

        comp = None
        outs_h = recs_h = None
        if self._compact_fn is not None:
            comp = jax.device_get(self._compact_fn(outs, recs))
            if int(comp.n_promoted) > self._compact_P:
                outs_h, recs_h = jax.device_get((outs, recs))
                comp = None
        else:
            outs_h, recs_h = jax.device_get((outs, recs))
        if comp is not None:
            n_inl_all = np.asarray(comp.n_inliers)[:n]
            promoted = np.asarray(comp.promoted)[:n]
            T_all_np = np.asarray(comp.T_w2c)
        else:
            n_inl_all = np.asarray(outs_h.n_inliers)[:n]
            promoted = np.asarray(recs_h.promoted)[:n]
            T_all_np = np.asarray(outs_h.T_w2c)
        tcfg = self.config.tracking
        last = n - 1
        info = {
            "state": self.state.name,
            "n_inliers": int(n_inl_all[last]),
            "chunk_frames": n,
        }
        if int(n_inl_all.min()) < 2 * tcfg.min_inliers:
            # Tracking thinned inside this chunk: the similarity-only
            # correction is too coarse near the edge — take the next
            # boundaries synchronously (exact post-BA reference install).
            self._async_cooloff = max(
                self._async_cooloff,
                getattr(tcfg, "async_boundary_cooloff", 2),
            )
        # Land the previous boundary's solve: host-map writeback + loop
        # closing, then the device-carry correction. This chunk's fetched
        # world-frame data is re-anchored with the same similarity before
        # replay so the adopted keyframes live in the post-solve world.
        U = self._finish_async_solve(correct_device=True)

        promo_idx = np.nonzero(promoted)[0]
        cur_ref = ref_kf
        new_kfs = []
        for s, f in enumerate(promo_idx):
            if comp is not None:
                out_f = TrackOutput(
                    T_w2c=T_all_np[f],
                    n_inliers=n_inl_all[f],
                    n_matches=np.asarray(comp.n_matches)[f],
                    features=jax.tree.map(lambda a: a[s], comp.feats),
                    match_train_idx=np.asarray(comp.match_train_idx)[s],
                    match_valid=np.asarray(comp.match_valid)[s],
                    pnp_inliers=np.asarray(comp.pnp_inliers)[s],
                    guided_idx=np.asarray(comp.guided_idx)[s],
                    guided_valid=np.asarray(comp.guided_valid)[s],
                )
                rec_f = PromoteRecord(
                    promoted=True,
                    ref_pos=np.asarray(comp.ref_pos)[s],
                    ref_has=np.asarray(comp.ref_has)[s],
                    ref_tri=np.asarray(comp.ref_tri)[s],
                )
            else:
                out_f = jax.tree.map(lambda a: a[f], outs_h)
                rec_f = jax.tree.map(lambda a: a[f], recs_h)
            if U is not None:
                R_u, t_u, sc = U
                T = np.asarray(out_f.T_w2c, np.float64).copy()
                R = T[:3, :3] @ R_u.T
                T[:3, :3] = R
                T[:3, 3] = sc * T[:3, 3] - R @ t_u
                out_f = out_f._replace(T_w2c=T)
                rec_f = rec_f._replace(
                    ref_pos=sc * np.asarray(rec_f.ref_pos, np.float64) @ R_u.T + t_u
                )
            kf = self._adopt_device_keyframe(
                out_f, rec_f, ts_tuple[f], cur_ref, arena
            )
            if comp is not None and self.loop_closing is not None:
                self.loop_closing.note_signature(
                    kf.keyframe_id, np.asarray(comp.sig)[s]
                )
            new_kfs.append(kf)
            cur_ref = kf
        if new_kfs:
            kf_last = new_kfs[-1]
            self._ref_kf = kf_last
            self._frames_since_kf = last - int(promo_idx[-1])
            self._enforce_budget()
            # Keep the device's guided-matching arena fresh with the newly
            # adopted landmarks (dispatch-only upload, no sync).
            if self._arena_size:
                self._refresh_arena()
            heavy = (
                tcfg.heavy_boundary_every <= 1
                or self._promos_since_heavy + len(new_kfs)
                >= tcfg.heavy_boundary_every
            )
            if heavy and self.map.num_keyframes() > 2:
                self._promos_since_heavy = 0
                kfs = self.map.get_keyframes()
                if len(kfs) <= 2 * self.config.optimization.window_size:
                    pending = self.optimizer.optimize_global_start(
                        kfs, self.map.get_map_points()
                    )
                else:
                    pending = self._start_local_ba(kfs)
                if pending is not None:
                    self._async_bnd = {
                        "pending": pending,
                        "anchor": kf_last,
                        "T_pre": kf_last.T_w2c.copy(),
                    }
            else:
                self._promos_since_heavy += len(new_kfs)
            info["new_keyframe"] = True
        else:
            self._frames_since_kf += n
        if n_inl_all[last] < tcfg.min_inliers:
            if outs_h is None:
                out_last = jax.device_get(jax.tree.map(lambda a: a[last], outs))
            else:
                out_last = jax.tree.map(lambda a: a[last], outs_h)
            rec = self._brute_recover(out_last, ts_tuple[-1])
            if rec is not None:
                info.update(rec)
                return info
            self.state = State.LOST
            info["state"] = self.state.name
            self.logger.warning(
                "compiled tracking lost (async devpromo chunk, %d inliers)",
                int(n_inl_all[last]),
            )
        return info

    def _finish_async_solve(self, correct_device: bool):
        """Write back the solve dispatched at the previous async boundary
        (results already resident), run loop closing on its anchor, and —
        when ``correct_device`` — re-anchor the device carry into the
        post-solve world with one similarity-correction dispatch. Returns
        (R_u, t_u, s) when a non-identity correction was applied."""
        if self._async_bnd is None:
            return None
        ab, self._async_bnd = self._async_bnd, None
        anchor = ab["anchor"]
        T_pre = np.asarray(ab["T_pre"], np.float64)
        res = self.optimizer.solve_finish(ab["pending"])
        g = res.get("gauge_transform")
        if g is not None:
            self.map.record_gauge_transform(*g)
        if self.loop_closing is not None:
            self.loop_closing.process_keyframe(anchor)
        if not correct_device:
            return None
        s = float(g[0]) if g is not None else 1.0
        T_new = np.asarray(anchor.T_w2c, np.float64)
        R_u, t_u = correction_similarity(T_pre, T_new, s)
        if (
            abs(s - 1.0) < 1e-12
            and np.allclose(R_u, np.eye(3), atol=1e-12)
            and np.allclose(t_u, 0.0, atol=1e-12)
        ):
            return None
        st, T_ref = apply_correction(
            self._track_state, self._dev_T_ref,
            jnp.asarray(R_u, jnp.float32), jnp.asarray(t_u, jnp.float32),
            np.float32(s),
        )
        self._track_state, self._dev_T_ref = st, T_ref
        return (R_u, t_u, s)

    def _adopt_device_keyframe(
        self, out, rec, timestamp: float, ref: KeyFrame, arena
    ) -> KeyFrame:
        """Replay one in-chunk device promotion into the host map: build the
        KeyFrame from the (already fetched) chunk outputs, link inherited
        landmarks through the same guided/reference associations the device
        used, and mint MapPoints for the device-triangulated slots
        (positions from the PromoteRecord — no triangulation dispatch)."""
        T = np.asarray(out.T_w2c, np.float64)
        feats = out.features
        frame = Frame(features=[feats], timestamp=timestamp)
        frame.update_pose(T)
        kf = KeyFrame.from_frame(frame)
        ti = np.asarray(out.match_train_idx)
        m_ok = np.asarray(out.match_valid)
        inl = np.asarray(out.pnp_inliers)
        g_idx = np.asarray(out.guided_idx)
        g_ok = np.asarray(out.guided_valid) & inl
        _, ref_mask = ref.point_arrays(0)
        inherited = np.zeros(len(m_ok), bool)
        if len(arena):
            for i in np.nonzero(g_ok)[0]:
                r = int(g_idx[i])
                if r < len(arena):
                    mp = arena[r]
                    if mp is not None and not mp.is_bad:
                        kf.add_map_point(0, int(i), mp)
                        inherited[i] = True
        for i in np.nonzero(m_ok & inl & ref_mask[ti] & ~inherited)[0]:
            mp = ref.get_map_point(0, int(ti[i]))
            if mp is not None and not mp.is_bad:
                kf.add_map_point(0, int(i), mp)
                inherited[i] = True
        # Fuse keypoints carrying both a guided-arena landmark and a
        # different reference-block landmark (same dedup as the host
        # boundary promotion).
        if len(arena):
            C_kf = kf.camera_center
            for i in np.nonzero(g_ok & m_ok & ref_mask[ti])[0]:
                r = int(g_idx[i])
                if r >= len(arena):
                    continue
                mp_a = arena[r]
                mp_b = ref.get_map_point(0, int(ti[i]))
                if (
                    mp_a is None or mp_b is None or mp_a is mp_b
                    or mp_a.is_bad or mp_b.is_bad
                ):
                    continue
                d = float(np.linalg.norm(mp_a.position - mp_b.position))
                depth = float(np.linalg.norm(mp_a.position - C_kf))
                if d <= 0.1 * max(depth, 1e-6):
                    keep, drop = (
                        (mp_a, mp_b)
                        if mp_a.num_observations() >= mp_b.num_observations()
                        else (mp_b, mp_a)
                    )
                    self.map.fuse_map_points(keep, drop)
        created = 0
        # Mint MapPoints ONLY for slots the device actually triangulated
        # (rec.ref_tri): an INHERITED slot (guided/reference association)
        # whose host-side link failed above — arena landmark fused or
        # culled between chunk dispatch and adoption, host/device ref-mask
        # drift after a BA cull — must be dropped, not re-created: for a
        # guided-only association ti[i] is a meaningless train index and
        # linking it would insert a wrong observation into the previous
        # keyframe plus a duplicate MapPoint shadowing the live original.
        new_mask = np.asarray(rec.ref_tri) & ~inherited
        dropped = int((np.asarray(rec.ref_has) & ~inherited & ~new_mask).sum())
        pos = np.asarray(rec.ref_pos, np.float64)
        desc = np.asarray(feats.desc)
        for i in np.nonzero(new_mask)[0]:
            mp = MapPoint(pos[i], descriptor=desc[i])
            kf.add_map_point(0, int(i), mp)
            # Back-link into the previous keyframe only through a VALID
            # match onto a FREE slot: stereo-minted slots may match a ref
            # keypoint that already carries a landmark (inherit declined it
            # for a failed inlier gate) — overwriting would orphan it.
            if m_ok[i] and ref.get_map_point(0, int(ti[i])) is None:
                ref.add_map_point(0, int(ti[i]), mp)
            self.map.add_map_point(mp)
            created += 1
        self.map.add_keyframe(kf)
        self.logger.debug(
            "adopt devpromo KF: %d inherited, %d device-triangulated, "
            "%d stale-inherit dropped, kf landmarks %d",
            int(inherited.sum()), created, dropped, kf.num_map_points(),
        )
        return kf

    def _enforce_budget(self) -> int:
        """Landmark-budget eviction for the compiled path (config.map.
        max_landmarks; Map.evict_landmarks LRU policy, recent keyframes'
        landmarks protected). Runs at every keyframe boundary BEFORE the BA
        pack so the map stays inside ONE point shape bucket for the whole
        run — mid-run bucket growth costs a multi-second recompile inside the
        frame loop and is exactly the sequence-scale collapse mode the
        reference documents (reference docs/article.md:673-683). Host-side
        LocalMapping enforces the same budget on the threaded path
        (local_mapping/local_mapping.py)."""
        budget = getattr(self.config.map, "max_landmarks", 0)
        if budget <= 0:
            return 0
        n = self.map.evict_landmarks(
            budget,
            protect_recent=getattr(self.config.map, "budget_protect_recent", 8),
        )
        if n:
            self.logger.debug(
                "landmark budget: evicted %d (map at %d / budget %d)",
                n, self.map.num_map_points(), budget,
            )
        return n

    def _boundary_heavy(self, kf: KeyFrame) -> None:
        """BA + loop closing for the device-promotion path. The device-
        triangulated landmarks are already in the map, so they JOIN this
        solve (unlike the host-promotion path, where the in-flight
        triangulation joins the next one)."""
        pending = None
        if self.map.num_keyframes() > 2:
            kfs = self.map.get_keyframes()
            if len(kfs) <= 2 * self.config.optimization.window_size:
                pending = self.optimizer.optimize_global_start(
                    kfs, self.map.get_map_points()
                )
            else:
                pending = self._start_local_ba(kfs)
        if pending is not None:
            res = self.optimizer.solve_finish(pending)
            g = res.get("gauge_transform")
            if g is not None:
                self.map.record_gauge_transform(*g)
        if self.loop_closing is not None:
            self.loop_closing.process_keyframe(kf)

    def _apply_pending_ba(self) -> None:
        self._finish_async_solve(correct_device=True)
        if self._ba_pending is None:
            return
        pending, self._ba_pending = self._ba_pending, None
        res = self.optimizer.solve_finish(pending)
        g = res.get("gauge_transform")
        if g is not None:
            self.map.record_gauge_transform(*g)

    def _start_local_ba(self, kfs):
        window = kfs[-self.config.optimization.window_size:]
        points = {}
        for kf in window:
            for mp in list(kf.map_points.values()):
                if not mp.is_bad:
                    points[mp.id] = mp
        window_ids = {kf.keyframe_id for kf in window}
        anchor_ids = set()
        for mp in points.values():
            for kf_id in mp.observations.get_keyframe_ids():
                if kf_id not in window_ids:
                    anchor_ids.add(kf_id)
        anchors = [kf for kf in kfs if kf.keyframe_id in anchor_ids]
        return self.optimizer.optimize_local_start(
            window, list(points.values()), fixed_keyframes=anchors
        )

    def _decide(self, out, timestamp, ref_kf, arena) -> dict:
        n_inl = int(out.n_inliers)
        info = {"n_inliers": n_inl, "n_matches": int(out.n_matches)}
        tcfg = self.config.tracking
        if n_inl < tcfg.min_inliers:
            # Before declaring LOST, retry with brute multi-keyframe
            # descriptor matching — the host path's fallback for frames
            # where the prediction-gated association collapses (observed
            # under fast yaw: matches stay >100 but inliers cliff). Costs
            # extra dispatches only on these rare frames.
            rec = self._brute_recover(out, timestamp)
            if rec is not None:
                info.update(rec)
                return info
            self.state = State.LOST
            self._pending = None
            info["state"] = self.state.name
            self.logger.warning("compiled tracking lost (%d inliers)", n_inl)
            return info
        # Motion gates (host path's kf_min_translation/rotation tests): under
        # rotation-dominant motion the reference descriptors go stale long
        # before the inlier count sags — a 6 deg/frame yaw killed tracking
        # at interval-based promotion alone. The pose rides the same async
        # device->host copy as the scalars.
        T_prev = np.asarray(out.T_w2c, np.float64)
        rot_deg = 0.0
        trans = 0.0
        if ref_kf is not None:
            R_rel = T_prev[:3, :3] @ ref_kf.R_w2c.T
            c = np.clip((np.trace(R_rel) - 1.0) / 2.0, -1.0, 1.0)
            rot_deg = float(np.degrees(np.arccos(c)))
            C_prev = -T_prev[:3, :3].T @ T_prev[:3, 3]
            trans = float(np.linalg.norm(C_prev - ref_kf.camera_center))
        if (
            self._frames_since_kf > tcfg.keyframe_interval
            or n_inl < tcfg.kf_min_matches
            or rot_deg > tcfg.kf_min_rotation_deg
            or trans > tcfg.kf_min_translation
        ):
            # The trigger reads the PREVIOUS frame's (already materialized)
            # scalars, but the keyframe itself is the NEWEST submitted frame:
            # a keyframe boundary syncs the host for BA anyway, and promoting
            # the older frame would make the reference one frame staler for
            # free (A/B: costs matches under fast motion).
            if self._pending is not None:
                p_out, p_ts, p_ref, p_arena = self._pending
                if int(p_out.n_inliers) >= tcfg.min_inliers:
                    self._pending = None
                    self._promote_keyframe(p_out, p_ts, p_ref, p_arena)
                else:  # newest frame is about to go LOST — keep the good one
                    self._promote_keyframe(out, timestamp, ref_kf, arena)
            else:  # flush path: the decided frame is the newest
                self._promote_keyframe(out, timestamp, ref_kf, arena)
            info["new_keyframe"] = True
        return info

    def _brute_recover(self, out, timestamp: float) -> Optional[dict]:
        """Host-side rescue of a near-lost frame: brute-match its feature
        block against the last keyframes (best landmark per keypoint across
        them, as tracking._track_local_map), re-solve PnP, and promote the
        frame so subsequent frames track fresh geometry."""
        import jax

        from ..ops.matching import match_descriptors
        from ..ops.pnp import ransac_pnp

        tcfg = self.config.tracking
        feats = jax.device_get(out.features)  # host-materialized once
        Kslots = feats.xy.shape[0]
        best_dist = np.full(Kslots, np.inf, np.float32)
        pts3d = np.zeros((Kslots, 3), np.float32)
        pair_valid = np.zeros(Kslots, bool)
        lm_of_slot: dict[int, MapPoint] = {}
        kfs = self.map.get_keyframes()[-3:]
        for kf in reversed(kfs):
            fr = kf.get_features(0)
            if fr is None:
                continue
            res = match_descriptors(
                feats.desc, fr.desc, feats.valid, fr.valid,
                feats.angle, fr.angle, ratio=0.8, cross_check=True,
            )
            ti = np.asarray(res["train_idx"])
            pos, mask = kf.point_arrays(0)
            ok = np.asarray(res["valid"]) & mask[ti]
            dist = np.asarray(res["distance"])
            take = ok & (dist < best_dist)
            best_dist[take] = dist[take]
            pts3d[take] = pos[ti[take]]
            pair_valid |= take
            for i in np.nonzero(take)[0]:
                mp = kf.get_map_point(0, int(ti[i]))
                if mp is not None:
                    lm_of_slot[int(i)] = mp
        if int(pair_valid.sum()) < 6:
            return None
        from ..ops.projection import normalize_points

        xyn = normalize_points(jnp.asarray(self.camera.Kinv, jnp.float32), feats.xy)
        res = ransac_pnp(
            jnp.asarray(pts3d), xyn, jnp.asarray(pair_valid),
            jax.random.PRNGKey(int(timestamp * 1000) & 0x7FFFFFFF),
            n_hyp=tcfg.pnp_hypotheses, thresh=tcfg.pnp_threshold_px / self.camera.fx,
        )
        n_inl = int(res["n_inliers"])
        if not bool(res["ok"]) or n_inl < tcfg.min_inliers:
            return None
        T = np.asarray(res["T"], np.float64)
        inl = np.asarray(res["inliers"])
        # Promote with the recovered associations (fresh reference for the
        # frames that follow); the pending frame was tracked against the bad
        # pose — drop its decision.
        frame = Frame(features=[feats], timestamp=timestamp)
        frame.update_pose(T)
        kf = KeyFrame.from_frame(frame)
        for i, mp in lm_of_slot.items():
            if inl[i] and not mp.is_bad:
                kf.add_map_point(0, i, mp)
        self.map.add_keyframe(kf)
        self._frames_since_kf = 0
        self._pending = None
        self._apply_pending_ba()
        if self.map.num_keyframes() > 2:
            kfs_all = self.map.get_keyframes()
            if len(kfs_all) <= 2 * self.config.optimization.window_size:
                self.map.optimize_global(self.optimizer)
            else:
                self.map.optimize_local(
                    self.optimizer, kfs_all[-self.config.optimization.window_size:]
                )
        self._install_reference(kf, T_init=kf.T_w2c)
        self.logger.info("brute-recovered near-lost frame (%d inliers)", n_inl)
        return {"recovered": True, "n_inliers": n_inl, "new_keyframe": True}

    def _promote_keyframe(
        self, out, timestamp: float, ref: KeyFrame, arena, heavy: bool = True
    ) -> None:
        """Keyframe boundary: all data comes from the track step's outputs —
        no re-detection, no extra matching. ``ref``/``arena`` are the blocks
        that were installed when this frame's step ran.

        ``heavy=False`` creates the keyframe, inherits landmarks and swaps
        the reference/arena but SKIPS triangulation + BA + loop closing —
        the sync-free light boundary of the chunked deployment
        (tracking.heavy_boundary_every); the next heavy boundary
        triangulates against this keyframe with accumulated baseline."""
        import jax

        # ONE batched device->host fetch for everything the boundary needs
        # (separate np.asarray calls each cost a full round trip on
        # remote-attached devices). The features block is materialized to
        # host here so every later consumer (BA packing, matching against
        # this keyframe, serialization) reads host memory for free.
        T, feats, ti, m_ok, inl, g_idx, g_ok = jax.device_get((
            out.T_w2c, out.features, out.match_train_idx, out.match_valid,
            out.pnp_inliers, out.guided_idx, out.guided_valid,
        ))
        T = np.asarray(T, np.float64)
        # Land the in-flight BA writeback BEFORE reading any keyframe pose,
        # and carry the tracked pose through its reference's correction so
        # triangulation sees one consistent gauge.
        T_ref_before = ref.T_w2c.copy() if ref is not None else None
        self._apply_pending_ba()
        if ref is not None and not np.array_equal(ref.T_w2c, T_ref_before):
            T = T @ np.linalg.inv(T_ref_before) @ ref.T_w2c
        frame = Frame(features=[feats], timestamp=timestamp)
        frame.update_pose(T)
        kf = KeyFrame.from_frame(frame)
        if g_ok is None:
            g_ok = np.zeros_like(m_ok)

        # Inherit landmarks. Guided association wins (it is what PnP used):
        # current kp i <- arena row g_idx[i]. Reference-block association
        # covers the rest: kp i matched ref slot ti[i] carrying a landmark.
        _, ref_mask = ref.point_arrays(0)
        inherited = np.zeros(len(m_ok), bool)
        if g_idx is not None and len(arena):
            for i in np.nonzero(g_ok & inl)[0]:
                r = int(g_idx[i])
                if r < len(arena):
                    mp = arena[r]
                    if mp is not None and not mp.is_bad:
                        kf.add_map_point(0, int(i), mp)
                        inherited[i] = True
        for i in np.nonzero(m_ok & inl & ref_mask[ti] & ~inherited)[0]:
            mp = ref.get_map_point(0, int(ti[i]))
            if mp is not None and not mp.is_bad:
                kf.add_map_point(0, int(i), mp)
                inherited[i] = True

        # A keypoint carrying BOTH a guided-arena landmark and a different
        # reference-block landmark is one physical point tracked twice —
        # fuse them (local-mapping's Fuse step for the compiled path).
        if g_idx is not None and len(arena):
            C_kf = kf.camera_center
            for i in np.nonzero(g_ok & inl & m_ok & ref_mask[ti])[0]:
                r = int(g_idx[i])
                if r >= len(arena):
                    continue
                mp_a = arena[r]
                mp_b = ref.get_map_point(0, int(ti[i]))
                if (
                    mp_a is None or mp_b is None or mp_a is mp_b
                    or mp_a.is_bad or mp_b.is_bad
                ):
                    continue
                d = float(np.linalg.norm(mp_a.position - mp_b.position))
                depth = float(np.linalg.norm(mp_a.position - C_kf))
                if d <= 0.1 * max(depth, 1e-6):
                    keep, drop = (
                        (mp_a, mp_b)
                        if mp_a.num_observations() >= mp_b.num_observations()
                        else (mp_b, mp_a)
                    )
                    self.map.fuse_map_points(keep, drop)

        created = 0
        tri_dev = tri_mask = None
        if heavy:
            # New landmarks come from matched-but-landmarkless pairs; the
            # triangulation DISPATCH happens after the BA dispatch below so
            # it can consume the solve's output poses.
            tri_mask = m_ok & ~ref_mask[ti] & ~inherited
        # Stereo: metric landmarks for every depth-measured keypoint still
        # without one (no parallax wait — disparity gives depth directly).
        if self._stereo and out.kp_z is not None and heavy:
            self._create_stereo_points(kf, out)

        self.map.add_keyframe(kf)
        self._frames_since_kf = 0
        self._enforce_budget()

        if heavy:
            # Windowed BA (bucketed shapes; full map while small): the
            # solve is DISPATCHED (pack excludes the still-in-flight new
            # triangulations; they join the next solve), triangulation is
            # dispatched CHAINED on the solve's device-side output poses for
            # ref/kf (so new landmarks are born in the post-solve frame),
            # then ONE device round trip fetches BA results + triangulation
            # together; the host-side gauge similarity from solve_finish is
            # applied to the fetched points before insertion. With async_ba
            # the writeback instead lands at the NEXT boundary and
            # triangulation uses the current (pre-solve) poses — consistent
            # with the map the next frames track against.
            pending = None
            if self.map.num_keyframes() > 2:
                kfs = self.map.get_keyframes()
                if len(kfs) <= 2 * self.config.optimization.window_size:
                    pending = self.optimizer.optimize_global_start(
                        kfs, self.map.get_map_points()
                    )
                else:
                    pending = self._start_local_ba(kfs)
            T_ref_dev = T_kf_dev = None
            if pending is not None and not self.config.optimization.async_ba:
                slot = pending["kf_slot"]
                j_ref = slot.get(ref.keyframe_id)
                j_kf = slot.get(kf.keyframe_id)
                if j_ref is not None and j_kf is not None:
                    T_ref_dev = pending["T"][j_ref]
                    T_kf_dev = pending["T"][j_kf]
            if tri_mask is not None and tri_mask.any():
                tri_dev = self._triangulate_dispatch(
                    kf, ref, ti, T_ref=T_ref_dev, T_kf=T_kf_dev
                )
            if self.config.optimization.async_ba:
                self._ba_pending = pending
                if tri_dev is not None:
                    pts_np, good_np = jax.device_get(tri_dev)
                    created = self._insert_triangulated(
                        kf, ref, ti, tri_mask, pts_np, good_np
                    )
            else:
                fetch = list(tri_dev) if tri_dev is not None else []
                if pending is not None:
                    fetch += [pending["T"], pending["X"], pending["info"]]
                fetched = jax.device_get(tuple(fetch)) if fetch else ()
                idx = 0
                gauge = None
                if tri_dev is not None:
                    pts_np, good_np = fetched[0], fetched[1]
                    idx = 2
                if pending is not None:
                    pending["T"], pending["X"], pending["info"] = fetched[idx:idx + 3]
                    res = self.optimizer.solve_finish(pending)
                    gauge = res.get("gauge_transform")
                    if gauge is not None:
                        self.map.record_gauge_transform(*gauge)
                if tri_dev is not None:
                    if gauge is not None:
                        # Points were triangulated from post-solve poses;
                        # carry them through the same similarity the gauge
                        # renorm applied to those poses on host.
                        s, b = gauge
                        pts_np = s * np.asarray(pts_np) + b
                    created = self._insert_triangulated(
                        kf, ref, ti, tri_mask, pts_np, good_np
                    )
            if self.loop_closing is not None:
                # A closure rewrites every keyframe pose + landmark; the
                # reference/arena swap below re-reads them, so the compiled
                # state picks the corrected map up automatically.
                self.loop_closing.process_keyframe(kf)
        T_new = kf.T_w2c if self.map.num_keyframes() > 2 else T
        self._install_reference(kf, T_init=T_new)
        self.logger.debug(
            "promote(%s): %d matches (%d to landmarks), %d inherited, "
            "%d triangulated, kf landmarks %d",
            "heavy" if heavy else "light", int(m_ok.sum()),
            int((m_ok & ref_mask[ti]).sum()), int(inherited.sum()), created,
            kf.num_map_points(),
        )

    def _create_stereo_points(self, kf: KeyFrame, out) -> int:
        import jax

        lcfg = self.config.local_mapping
        feats = kf.get_features(0)
        z, z_ok = jax.device_get((out.kp_z, out.kp_z_valid))  # one fetch
        z = np.asarray(z)
        ok = (
            np.asarray(z_ok)
            & np.asarray(feats.valid)
            & (z > lcfg.min_depth) & (z < lcfg.max_depth)
        )
        kf.kp_z, kf.kp_z_valid = z, ok
        xy = np.asarray(feats.xy)
        desc = np.asarray(feats.desc)
        from ..ops.stereo import backproject_np

        p_w = backproject_np(self.camera.Kinv, kf.R_c2w, kf.t_c2w, xy, z)
        created = 0
        for i in np.nonzero(ok)[0]:
            if kf.get_map_point(0, int(i)) is None:
                mp = MapPoint(p_w[i], descriptor=desc[i])
                kf.add_map_point(0, int(i), mp)
                self.map.add_map_point(mp)
                created += 1
        return created

    def _triangulate_dispatch(self, kf: KeyFrame, ref: KeyFrame, ti,
                              T_ref=None, T_kf=None):
        """Submit the fused boundary triangulation (ops.triangulation.
        triangulate_gated; eager op-by-op math here would pay one dispatch
        per op). Returns device (pts3d, good) —
        fetch rides the boundary's single round trip. ``T_ref``/``T_kf``
        override the camera poses with device arrays (e.g. the in-flight BA
        solve's output slots) so the dispatch chains on the solve with no
        host sync."""
        lcfg = self.config.local_mapping
        thresh_n = self.config.tracking.pnp_threshold_px / float(self.camera.fx)
        pts3d, good = tri_ops.triangulate_gated(
            jnp.asarray(self.camera.Kinv, jnp.float32),
            jnp.asarray(ref.T_w2c, jnp.float32) if T_ref is None else T_ref,
            jnp.asarray(kf.T_w2c, jnp.float32) if T_kf is None else T_kf,
            np.asarray(ref.get_features(0).xy)[np.asarray(ti)],
            np.asarray(kf.get_features(0).xy),
            np.float32(lcfg.min_depth),
            np.float32(lcfg.max_depth),
            np.float32(np.deg2rad(lcfg.min_parallax_deg)),
            np.float32(thresh_n),
        )
        return pts3d, good

    def _insert_triangulated(self, kf, ref, ti, tri_mask, pts_np, good_np) -> int:
        good_np = np.asarray(good_np) & tri_mask
        pts_np = np.asarray(pts_np)
        desc_np = np.asarray(kf.get_features(0).desc)
        created = 0
        for i in np.nonzero(good_np)[0]:
            mp = MapPoint(pts_np[i], descriptor=desc_np[i])
            kf.add_map_point(0, int(i), mp)
            ref.add_map_point(0, int(ti[i]), mp)
            self.map.add_map_point(mp)
            created += 1
        return created

    def _triangulate(self, kf: KeyFrame, ref: KeyFrame, ti, tri_mask, out) -> int:
        import jax

        pts3d, good = self._triangulate_dispatch(kf, ref, ti)
        good_np, pts_np = jax.device_get((good, pts3d))
        return self._insert_triangulated(kf, ref, ti, tri_mask, pts_np, good_np)
