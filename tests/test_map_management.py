"""Map growth management: keyframe culling + landmark budget."""
import numpy as np
import jax.numpy as jnp

from visual_slam_tpu.camera import PinholeCamera
from visual_slam_tpu.config import Config
from visual_slam_tpu.frontend.tracker import FeatureTracker
from visual_slam_tpu.local_mapping import LocalMapping
from visual_slam_tpu.map import KeyFrame, Map, MapPoint
from visual_slam_tpu.ops.detector import Features
from visual_slam_tpu.sensor_type import SensorType


def _feats(rng, K=16):
    return Features(
        xy=jnp.asarray(rng.uniform(0, 100, (K, 2)), jnp.float32),
        response=jnp.ones(K, jnp.float32),
        angle=jnp.zeros(K, jnp.float32),
        octave=jnp.zeros(K, jnp.int32),
        size=jnp.full((K,), 31.0, jnp.float32),
        desc=jnp.asarray(rng.integers(0, 2**32, (K, 8), dtype=np.uint32)),
        valid=jnp.ones(K, bool),
    )


def _setup(rng, cfg=None):
    cfg = cfg or Config()
    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    cam = PinholeCamera(320, 240, K)
    m = Map()
    lm = LocalMapping(cam, cfg, m, FeatureTracker(cfg.feature), SensorType.MONOCULAR)
    return cfg, cam, m, lm


def test_redundant_keyframe_culled(rng):
    cfg, cam, m, lm = _setup(rng)
    cfg.map.min_keyframes_before_cull = 4
    # 6 KFs all observing the same 10 landmarks -> middle ones are redundant.
    mps = [MapPoint(rng.uniform(-1, 1, 3)) for _ in range(10)]
    for mp in mps:
        m.add_map_point(mp)
    kfs = []
    for k in range(6):
        kf = KeyFrame(features=[_feats(rng)], timestamp=0.1 * k)
        for i, mp in enumerate(mps):
            kf.add_map_point(0, i, mp)
        m.add_keyframe(kf)
        kfs.append(kf)
    n_before = m.num_keyframes()
    culled = lm.cull_redundant_keyframes()
    assert culled > 0
    assert m.num_keyframes() == n_before - culled
    # survivors keep the landmarks alive
    assert all(mp.num_observations() >= 3 for mp in mps)
    # first and last two keyframes survive
    ids = {kf.keyframe_id for kf in m.get_keyframes()}
    assert kfs[0].keyframe_id in ids
    assert kfs[-1].keyframe_id in ids and kfs[-2].keyframe_id in ids


def test_unique_landmarks_not_culled(rng):
    cfg, cam, m, lm = _setup(rng)
    cfg.map.min_keyframes_before_cull = 4
    kfs = []
    for k in range(6):
        kf = KeyFrame(features=[_feats(rng)], timestamp=0.1 * k)
        # each KF observes its own unique landmarks
        for i in range(5):
            mp = MapPoint(rng.uniform(-1, 1, 3))
            m.add_map_point(mp)
            kf.add_map_point(0, i, mp)
        m.add_keyframe(kf)
        kfs.append(kf)
    assert lm.cull_redundant_keyframes() == 0
    assert m.num_keyframes() == 6


def test_landmark_budget(rng):
    cfg, cam, m, lm = _setup(rng)
    kf = KeyFrame(features=[_feats(rng, 64)], timestamp=0.0)
    m.add_keyframe(kf)
    for i in range(50):
        mp = MapPoint(rng.uniform(-1, 1, 3))
        m.add_map_point(mp)
        if i % 2 == 0:
            kf.add_map_point(0, i % 64, mp)  # half get an observation
    evicted = lm.enforce_landmark_budget(30)
    assert evicted == 20
    assert m.num_map_points() == 30
    # observed landmarks preferred over orphans
    obs_counts = [mp.num_observations() for mp in m.get_map_points()]
    assert sum(1 for c in obs_counts if c > 0) >= 10


def test_removal_uses_observation_index(rng):
    """remove_map_point must be O(observations), not O(KFs x points):
    evicting 1k landmarks from a 10k-landmark / 100-KF map in milliseconds."""
    import time

    cfg, cam, m, lm = _setup(rng)
    n_kf, per_kf = 100, 100
    mps = []
    for k in range(n_kf):
        kf = KeyFrame(features=[_feats(rng, K=128)], timestamp=0.1 * k)
        m.add_keyframe(kf)
        for i in range(per_kf):
            mp = MapPoint(rng.uniform(-1, 1, 3))
            m.add_map_point(mp)
            kf.add_map_point(0, i, mp)
            mps.append(mp)
    assert m.num_map_points() == n_kf * per_kf
    t0 = time.perf_counter()
    for mp in mps[:1000]:
        m.remove_map_point(mp)
    dt = time.perf_counter() - t0
    assert m.num_map_points() == n_kf * per_kf - 1000
    # linear scans over 100 KFs x 10k points would take seconds; the
    # observation index does it in well under half a second even on CI
    assert dt < 0.5, f"eviction of 1000 landmarks took {dt:.3f}s"
    # back-links are fully cleaned
    kf0 = m.get_keyframes()[0]
    assert all(not v.is_bad for v in kf0.map_points.values())


def test_keyframe_id_lookup(rng):
    cfg, cam, m, lm = _setup(rng)
    kf = KeyFrame(features=[_feats(rng)], timestamp=0.0)
    m.add_keyframe(kf)
    assert m.get_keyframe_by_id(kf.keyframe_id) is kf
    m.remove_keyframe(kf)
    assert m.get_keyframe_by_id(kf.keyframe_id) is None


def test_fuse_map_points(rng):
    """Fusion transfers observations, rebinds slots, retires the duplicate."""
    cfg, cam, m, lm = _setup(rng)
    kf1 = KeyFrame(features=[_feats(rng)], timestamp=0.0)
    kf2 = KeyFrame(features=[_feats(rng)], timestamp=0.1)
    kf3 = KeyFrame(features=[_feats(rng)], timestamp=0.2)
    for kf in (kf1, kf2, kf3):
        m.add_keyframe(kf)
    keep = MapPoint(np.array([0.0, 0.0, 5.0]))
    drop = MapPoint(np.array([0.0, 0.0, 5.01]))
    m.add_map_point(keep)
    m.add_map_point(drop)
    kf1.add_map_point(0, 1, keep)
    kf2.add_map_point(0, 2, keep)
    kf2.add_map_point(0, 3, drop)  # kf2 sees BOTH -> drop's slot is removed
    kf3.add_map_point(0, 4, drop)  # kf3 sees only drop -> slot rebinds
    moved = m.fuse_map_points(keep, drop)
    assert moved == 1
    assert drop.is_bad and m.num_map_points() == 1
    assert kf3.get_map_point(0, 4) is keep
    assert kf2.get_map_point(0, 3) is None
    assert keep.num_observations() == 3
