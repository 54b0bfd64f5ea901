"""Concrete pipeline families. Thin, opinionated constructors over SLAM /
pipeline / parallel with the right defaults per mode."""
from __future__ import annotations

import numpy as np

from ..camera import PinholeCamera
from ..config import Config
from ..slam import SLAM


def _base_config(num_features: int) -> Config:
    cfg = Config()
    cfg.feature.num_features = num_features
    return cfg


class MonoVO(SLAM):
    """Monocular SLAM (the flagship family)."""

    def __init__(self, camera: PinholeCamera, num_features: int = 2000,
                 config: Config | None = None, **kwargs):
        cfg = config or _base_config(num_features)
        cfg.camera.sensor_type = "monocular"
        super().__init__(camera, cfg, **kwargs)


class StereoVO(SLAM):
    """Stereo SLAM: metric scale from the first frame."""

    def __init__(self, camera: PinholeCamera, num_features: int = 2000,
                 config: Config | None = None, **kwargs):
        if getattr(camera, "baseline", 0.0) <= 0:
            raise ValueError("StereoVO needs a camera with a positive baseline")
        cfg = config or _base_config(num_features)
        cfg.camera.sensor_type = "stereo"
        super().__init__(camera, cfg, **kwargs)


class RGBDVO(SLAM):
    """RGB-D SLAM: metric landmarks from depth maps."""

    def __init__(self, camera: PinholeCamera, num_features: int = 2000,
                 config: Config | None = None, **kwargs):
        cfg = config or _base_config(num_features)
        cfg.camera.sensor_type = "rgbd"
        super().__init__(camera, cfg, **kwargs)


class CompiledVO:
    """Fused device-resident frame-to-frame tracker (pipeline.py) with a
    minimal host API: feed frames, read poses. Keyframe/landmark management
    is host-driven via ``set_reference``."""

    def __init__(self, K: np.ndarray, num_features: int = 2000, **track_params):
        import jax.numpy as jnp

        from ..pipeline import make_track_step

        self.K = np.asarray(K, np.float32)
        self.step = make_track_step(
            jnp.asarray(self.K), num_features=num_features, **track_params
        )
        self.num_features = num_features
        self.state = None
        self.poses: list[np.ndarray] = []

    def set_reference(self, features, landmarks, has_landmark, T_w2c=None, seed: int = 0):
        from ..pipeline import init_track_state, swap_reference

        if self.state is None:
            self.state = init_track_state(
                features, landmarks, has_landmark,
                np.eye(4) if T_w2c is None else T_w2c, seed=seed,
            )
        else:
            self.state = swap_reference(self.state, features, landmarks, has_landmark)

    def track(self, img) -> dict:
        import jax.numpy as jnp

        if self.state is None:
            raise RuntimeError("call set_reference() first")
        self.state, out = self.step(self.state, jnp.asarray(img, jnp.float32))
        T = np.asarray(out.T_w2c)
        self.poses.append(T)
        return {"T_w2c": T, "n_inliers": int(out.n_inliers), "n_matches": int(out.n_matches)}


class BatchedVO:
    """Data-parallel multi-sequence VO over a device mesh (parallel/multiseq)."""

    def __init__(self, K: np.ndarray, mesh=None, num_features: int = 1000, **track_params):
        import jax.numpy as jnp

        from ..parallel import make_mesh
        from ..parallel.multiseq import make_batched_vo

        self.mesh = mesh if mesh is not None else make_mesh("seq")
        self.step = make_batched_vo(
            jnp.asarray(np.asarray(K, np.float32)), self.mesh,
            num_features=num_features, **track_params,
        )

    def track(self, states, imgs):
        import jax.numpy as jnp

        return self.step(states, jnp.asarray(imgs, jnp.float32))


class PipelinedVO:
    """Pipeline-parallel SLAM family: the 2-stage front-end/back-end device
    split (parallel/frontback.py — stage 0 detects+matches frame t while
    stage 1 solves frame t-1, payloads over one ppermute per frame) with
    HOST keyframe handling: chunk-boundary promotion, landmark inheritance,
    gated triangulation, windowed LM/Schur BA, reference swap.

    This is the deployable form of the front/back pipeline demo: the
    reference runs tracking and optimization as host THREADS
    (visual_slam/slam.py:50-54); here the same overlap runs on two chips of
    a ``pp`` mesh axis inside ONE compiled program per chunk.
    """

    def __init__(self, camera: PinholeCamera, mesh=None, config: Config | None = None,
                 num_features: int = 512, chunk: int = 8, **pp_params):
        import jax
        import jax.numpy as jnp

        from ..backend.optimizer import LMOptimizer
        from ..frontend.tracker import FeatureTracker
        from ..initializer import Initializer
        from ..map import Map
        from ..parallel.frontback import make_frontback_pipeline
        from ..state import State

        cfg = config or _base_config(num_features)
        cfg.feature.num_features = num_features
        self.camera = camera
        self.config = cfg
        self.chunk = int(chunk)
        self.map = Map(max_frames=cfg.map.max_frames)
        self.optimizer = LMOptimizer(cfg, camera)
        self.state = State.NO_IMAGES_YET
        if mesh is None:
            from jax.sharding import Mesh as JMesh

            devs = jax.devices()
            if len(devs) < 2:
                raise ValueError("PipelinedVO needs >= 2 devices for the pp axis")
            mesh = JMesh(np.array(devs[:2]), ("pp",))
        self.mesh = mesh
        fcfg = cfg.feature
        pp_kw = dict(
            num_features=num_features,
            fast_threshold=fcfg.fast_threshold,
            n_levels=fcfg.num_pyramid_levels,
            scale=fcfg.scale_factor,
            grid=fcfg.grid_cells,
            pnp_threshold_px=cfg.tracking.pnp_threshold_px,
        )
        pp_kw.update(pp_params)  # explicit overrides win over config-derived
        self._pp = make_frontback_pipeline(
            jnp.asarray(np.asarray(camera.K, np.float32)), mesh, **pp_kw
        )
        self._tracker = FeatureTracker(fcfg)
        self._initializer = Initializer(camera, cfg, self._tracker, self.map)
        self._initializer.optimizer = self.optimizer
        self._buf: list[tuple] = []  # (img (H,W) np, ts)
        self._ref_kf = None
        self._T_cur = np.eye(4)
        self.poses: list[tuple[float, np.ndarray]] = []
        self._frames_since_kf = 0

    # -- API ---------------------------------------------------------------
    def track(self, images, timestamp: float) -> dict:
        from ..state import State

        img = images[0] if isinstance(images, (list, tuple)) else images
        if self.state != State.OK:
            self.state = State.INITIALIZING
            if self._initializer.initialize([np.asarray(img)], timestamp, None):
                self.state = State.OK
                kf = self.map.get_last_keyframe()
                self._install_reference(kf)
                self._T_cur = np.asarray(kf.T_w2c)
                self.poses.append((timestamp, self._T_cur.copy()))
            return {"state": self.state.name}
        self._buf.append((np.asarray(img, np.float32), timestamp))
        if len(self._buf) < self.chunk:
            return {"state": self.state.name, "buffered": len(self._buf)}
        return self._run_chunk()

    def flush(self) -> dict:
        return self._run_chunk() if self._buf else {}

    def shutdown(self) -> None:
        self.flush()

    def trajectory(self):
        ts = np.asarray([t for t, _ in self.poses])
        Ts = np.stack([T for _, T in self.poses]) if self.poses else np.zeros((0, 4, 4))
        return ts, Ts

    # -- internals ---------------------------------------------------------
    def _install_reference(self, kf) -> None:
        import jax

        self._ref_kf = kf
        pos, mask = kf.point_arrays(0)
        self._ref_feats = jax.tree.map(np.asarray, kf.get_features(0))
        self._ref_lm = pos
        self._ref_has = mask

    def _run_chunk(self) -> dict:
        import jax

        from ..ops import orb as orb_ops
        from ..state import State

        buf, self._buf = self._buf, []
        n = len(buf)
        # One extra repeat of the last frame flushes the 1-frame pipeline
        # bubble so every buffered frame gets a solved pose this chunk.
        frames = np.stack([im for im, _ in buf] + [buf[-1][0]])
        Ts, n_inls = self._pp(
            frames, self._ref_feats, self._ref_lm, self._ref_has,
            self._T_cur, orb_ops.active_sampling(),
        )
        Ts, n_inls = jax.device_get((Ts, n_inls))
        Ts, n_inls = np.asarray(Ts, np.float64)[1 : n + 1], np.asarray(n_inls)[1 : n + 1]
        for (im, ts), T in zip(buf, Ts):
            self.poses.append((ts, T))
        self._T_cur = Ts[-1]
        self._frames_since_kf += n
        tcfg = self.config.tracking
        info = {"state": self.state.name, "n_inliers": int(n_inls[-1])}
        healthy = n_inls >= tcfg.min_inliers
        if not healthy.any():
            self.state = State.LOST
            info["state"] = self.state.name
            return info
        if self._frames_since_kf > tcfg.keyframe_interval or not healthy[-1]:
            j = int(np.nonzero(healthy)[0][-1])
            self._promote(buf[j][0], buf[j][1], Ts[j])
            self._frames_since_kf = n - 1 - j
            info["new_keyframe"] = True
        return info

    def _promote(self, img: np.ndarray, timestamp: float, T: np.ndarray) -> None:
        """Host keyframe boundary: detect on the promoted frame (the
        pipeline's payload carries only candidates, not features), inherit
        landmarks via reference-block matching, triangulate the rest
        (gated), windowed BA, reference swap."""
        import jax
        import jax.numpy as jnp

        from ..map import Frame, KeyFrame, MapPoint
        from ..ops import triangulation as tri_ops
        from ..ops.detector import detect_and_describe
        from ..ops.matching import match_descriptors

        feats = jax.device_get(detect_and_describe(
            jnp.asarray(img), num_features=self.config.feature.num_features,
            threshold=self.config.feature.fast_threshold,
            n_levels=self.config.feature.num_pyramid_levels,
            scale=self.config.feature.scale_factor,
            grid=self.config.feature.grid_cells,
        ))
        ref = self._ref_kf
        res = jax.device_get(match_descriptors(
            jnp.asarray(feats.desc), jnp.asarray(self._ref_feats.desc),
            jnp.asarray(feats.valid), jnp.asarray(self._ref_feats.valid),
            jnp.asarray(feats.angle), jnp.asarray(self._ref_feats.angle),
            ratio=self.config.tracking.match_ratio, cross_check=True,
        ))
        frame = Frame(features=[feats], timestamp=timestamp)
        frame.update_pose(np.asarray(T, np.float64))
        kf = KeyFrame.from_frame(frame)
        ti = np.asarray(res["train_idx"])
        ok = np.asarray(res["valid"])
        inherited = np.zeros(len(ok), bool)
        for i in np.nonzero(ok & self._ref_has[ti])[0]:
            mp = ref.get_map_point(0, int(ti[i]))
            if mp is not None and not mp.is_bad:
                kf.add_map_point(0, int(i), mp)
                inherited[i] = True
        lcfg = self.config.local_mapping
        pts3d, good = tri_ops.triangulate_gated(
            jnp.asarray(self.camera.Kinv, jnp.float32),
            jnp.asarray(ref.T_w2c, jnp.float32),
            jnp.asarray(kf.T_w2c, jnp.float32),
            np.asarray(self._ref_feats.xy)[ti],
            np.asarray(feats.xy),
            np.float32(lcfg.min_depth), np.float32(lcfg.max_depth),
            np.float32(np.deg2rad(lcfg.min_parallax_deg)),
            np.float32(self.config.tracking.pnp_threshold_px / float(self.camera.fx)),
        )
        good_np, pts_np = jax.device_get((good, pts3d))
        good_np = np.asarray(good_np) & ok & ~inherited & ~self._ref_has[ti]
        for i in np.nonzero(good_np)[0]:
            mp = MapPoint(np.asarray(pts_np)[i], descriptor=np.asarray(feats.desc)[i])
            kf.add_map_point(0, int(i), mp)
            ref.add_map_point(0, int(ti[i]), mp)
            self.map.add_map_point(mp)
        self.map.add_keyframe(kf)
        kfs = self.map.get_keyframes()
        if len(kfs) > 2:
            if len(kfs) <= 2 * self.config.optimization.window_size:
                self.map.optimize_global(self.optimizer)
            else:
                self.map.optimize_local(
                    self.optimizer, kfs[-self.config.optimization.window_size:]
                )
        self._install_reference(kf)
        self._T_cur = np.asarray(kf.T_w2c)
