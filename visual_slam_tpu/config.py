"""Configuration dataclasses with JSON round-trip.

Mirrors the reference config system (visual_slam/config.py:8-112) with the
same component split and gating thresholds, plus device-shape knobs (feature
capacity, RANSAC hypothesis budgets, BA window buckets) that control the
static shapes everything compiles against.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict


@dataclass
class CameraConfig:
    """(reference config.py:8-14)"""

    sensor_type: str = "monocular"  # monocular | stereo | rgbd
    width: int = 0
    height: int = 0
    fps: float = 30.0


@dataclass
class FeatureConfig:
    """Detector/matcher selection and capacity (reference config.py:17-23).

    ``num_features`` is the static per-frame feature capacity: the detector
    always returns exactly this many slots (padded + masked), which is what
    lets every downstream stage compile once.
    """

    detector_name: str = "fast_orb"  # fast_orb | fast_orb_anms | shi_tomasi_orb
    matcher_name: str = "bf_hamming"
    num_features: int = 1000
    fast_threshold: float = 20.0
    num_pyramid_levels: int = 4
    scale_factor: float = 1.2
    grid_cells: int = 8  # spatial-balance grid (replaces ANMS/grid filters)
    # Bin-sorted grouped-matmul rBRIEF (ops/orb.descriptors_sorted): 1/30
    # the descriptor-sampling FLOPs, bit-identical descriptors, features
    # returned in orientation-bin order. Off until an A/B on the GPU lands.
    ragged_descriptors: bool = False
    detector_params: Dict[str, Any] = field(default_factory=dict)
    matcher_params: Dict[str, Any] = field(default_factory=dict)
    filter_params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class InitializationConfig:
    """(reference config.py:25-28; max depth hardcoded 50.0 at
    initializer.py:243-255 — here it is a config field)"""

    min_depth: float = 0.1
    max_depth: float = 50.0
    min_inliers: int = 100
    min_parallax_deg: float = 1.0
    min_dt: float = 0.0
    essential_hypotheses: int = 256
    essential_threshold: float = 3e-3
    buffer_frames: int = 5


@dataclass
class TrackingConfig:
    """(reference config.py:30-42)"""

    min_inliers: int = 10
    min_parallax_deg: float = 1.0
    keyframe_interval: int = 5
    min_inlier_ratio: float = 0.25
    max_reprojection_error: float = 1.0
    use_ransac: bool = True
    check_reprojection_error: bool = False
    # Keyframe decision thresholds (reference tracking.py:518-580)
    kf_min_translation: float = 2.0
    kf_min_rotation_deg: float = 10.0
    kf_min_matches: int = 30
    # PnP budget
    pnp_hypotheses: int = 128
    pnp_threshold_px: float = 3.0
    match_ratio: float = 0.75
    # Fuse detect+guided-match+PnP into one device program per frame
    # (trackingalgorithm.FusedMonoTracking)
    fused_pipeline: bool = False
    # Local-map landmark arena for the compiled step's projection-guided
    # association (CompiledSLAM); 0 disables the stage.
    local_map_size: int = 4096
    # Base search window; the compiled step widens it with the motion
    # model's rotation rate (see pipeline.make_track_step) — a static 25 px
    # lost tracking at 6 deg/frame yaw (prediction lag pushes true matches
    # out of the window), while a static 40 px admitted aliases that doubled
    # ATE on translation-heavy sequences.
    guided_radius_px: float = 25.0
    guided_ratio: float = 0.8
    # Multi-frame device-side tracking (CompiledSLAM): scan the fused step
    # over chunks of this many frames so a chunk costs ONE dispatch. Host
    # decisions run at chunk boundaries on the stacked scalars; the
    # reference block stales at most chunk_size-1 extra frames (the same
    # staleness the deferred per-frame decision tolerates). 1 = per-frame.
    chunk_size: int = 1
    # In-chunk DEVICE-side keyframe promotion (pipeline.
    # make_track_chunk_promote): the compiled chunk evaluates the keyframe
    # gates every frame and swaps its own reference block (inherit +
    # triangulate) without returning to the host, so chunk_size can exceed
    # the sequence's match-decay horizon; the host rebuilds the promoted
    # keyframes from the chunk's PromoteRecords at the boundary. Mono
    # triangulates against the old reference in-program; stereo (r4) mints
    # metric landmarks from the step's own disparity depths.
    device_promotion: bool = False
    # Asynchronous heavy boundaries (devpromo only): BA dispatches at one
    # chunk boundary and is written back at the NEXT (where its results are
    # already resident — zero wait), pulling solve compute + fetch off the
    # critical path. The device carry is re-anchored into the post-solve
    # world by a similarity correction (pipeline.apply_correction) computed
    # from the solved keyframe's pose change — the device's own (fresher)
    # self-promoted reference features are never overwritten. fsr/T_ref
    # chain device-side between chunks instead of host re-seeding.
    async_boundary: bool = False
    # Async boundaries only once the map is MATURE: while the keyframe
    # count is below this, boundaries run synchronously (exact post-BA
    # reference re-install). The young map moves far more than a gauge
    # similarity per solve — an earlier A/B collapsed (31 -> 3 inliers,
    # LOST) at the FIRST async correction on a ~10-KF map; a mature map's BA
    # deltas beyond the similarity are small.
    async_boundary_min_kfs: int = 12
    # After a thin-tracking chunk (min inliers < 2x min_inliers) in async
    # mode, run this many boundaries synchronously before going async
    # again (exact reference recovery instead of approximate correction).
    async_boundary_cooloff: int = 2
    # Chunked-mode boundary split: every promotion creates the keyframe,
    # inherits landmarks and refreshes the reference/arena (cheap, no device
    # sync), but triangulation + BA (each with its own device round trips)
    # run only every Nth promotion — or immediately when tracking thins.
    # 1 = every boundary is heavy (per-frame-mode behavior).
    heavy_boundary_every: int = 1
    # Upload float camera frames as float16: half the host->device bytes of
    # f32 at ~0.12-gray-level quantization.
    # Default OFF: the small synthetic test worlds carry their texture in
    # anti-aliased edge fractions and a marginal sequence measurably flips
    # with the rounding (same mechanism as the u8 finding, CLAUDE.md);
    # KITTI-scale deployments with richer texture can opt in (bench does,
    # ATE-checked). uint8 input passes through unchanged either way.
    upload_f16: bool = False
    # Chunked devpromo boundary fetch: gather the decision scalars + the
    # promoted frames' feature blocks into a fixed-capacity compact struct
    # ON DEVICE and fetch only that (~4x less payload than the full stacked
    # chunk output at chunk_size 8). Capacity = promotions per chunk the
    # compact block can carry; overflow or brute recovery falls back to a
    # second full fetch (rare). 0 disables (always fetch the full output).
    compact_fetch_promos: int = 4
    # Depth-aware tracking (stereo disparity / RGB-D depth residual in PnP —
    # the second modality constrains pose every frame, not only at keyframes)
    use_depth_residual: bool = True
    # Virtual baseline (m) for the RGB-D disparity residual (ORB-SLAM2-style
    # bf synthesis; stereo uses the real camera baseline).
    rgbd_virtual_baseline: float = 0.08
    stereo_row_tolerance: float = 2.0
    depth_scale: float = 1.0


@dataclass
class LocalMappingConfig:
    """(reference config.py:44-50)"""

    run_timeout: float = 0.1
    max_neighbors: int = 2
    min_depth: float = 0.1
    max_depth: float = 50.0
    min_parallax_deg: float = 0.5


@dataclass
class OptimizationConfig:
    """BA back-end (reference config.py:56-61). lr/batch_size kept for the
    gradient-descent fallback; the primary solver is LM+Schur."""

    solver: str = "lm_schur"  # lm_schur | adam
    n_iter: int = 20
    lr: float = 1e-3
    batch_size: int = 1000
    huber_delta: float = 5.0
    window_size: int = 8  # keyframes per local BA window (padded bucket)
    max_points: int = 4096  # landmark capacity per window (padded bucket)
    lm_lambda0: float = 1e-3
    # Shape-bucket floors. Every distinct (pose, landmark) bucket is a fresh
    # XLA compile; floors high enough that a typical run stays in ONE bucket
    # turn those compiles into a single warmup cost.
    pose_bucket_floor: int = 16
    point_bucket_floor: int = 1024
    # Sparse landmark-major BA: K observation slots per landmark instead of
    # the dense (M, W) grid — identical LM/Schur math (backend/ba.py
    # BASparse, parity-tested to 2e-4). Its pose-indexed reductions are
    # one-hot einsums (every [obs_pose] access is a contraction, no
    # scatters or gathers); the K-axis terms cost O(M K) vs the dense grid's
    # O(M W). Landmarks tracked longer than obs_cap keep an evenly-spread
    # subset of their observations for that solve (logged).
    # False | True | "auto" ("auto" = sparse once the pose bucket reaches
    # sparse_auto_min_window; the threshold is not measured on a GPU yet).
    sparse_obs: bool | str = False
    sparse_auto_min_window: int = 32
    obs_cap: int = 16
    # Landmark-MINOR dense layout (backend/ba.py bundle_adjust_lm): same
    # LM/Schur math with the landmark axis last instead of small (2, 6)
    # trailing dims. Opt-in; whether it pays on a GPU is not measured.
    lm_minor: bool = False
    ba_every_n_keyframes: int = 1  # throttle the BA handler trigger
    # CompiledSLAM: dispatch the keyframe-boundary BA WITHOUT waiting and
    # apply its writeback at the next boundary (overlaps the solve with the
    # following frames' tracking instead of waiting on it inside the
    # boundary). Deterministic (single
    # thread); the tracked pose is anchored through the reference keyframe
    # correction when the writeback lands. Off by default: the one-boundary
    # refinement lag measurably costs accuracy on sparse scenes (A/B on the
    # small render world: ATE 0.24 sync vs 0.45 async + a transient LOST).
    async_ba: bool = False
    log_reprojection_error: bool = True  # host-side metric around each BA
    # Run full-map BA while the map is at most this many keyframes (the
    # compiled LM/Schur solve is ~ms even at 64 KFs x 16k landmarks; windowed
    # BA with frozen anchors locks in drift and is only worth it at scale).
    global_ba_max_keyframes: int = 64


@dataclass
class LoopClosingConfig:
    """(reference config.py:52-53 — empty placeholder)"""

    enabled: bool = False
    # O(1) place recognition: shortlist candidates by compact global
    # signature (loop_closing/signature.py) before batched geometric
    # verification. use_signature=False restores brute-force scoring of
    # every old keyframe (the round-2 behavior; useful for recall A/Bs).
    use_signature: bool = True
    shortlist_size: int = 8


@dataclass
class MapConfig:
    """(reference config.py:63-65, plus growth management the reference
    lacks — its _points/_keyframes grow unboundedly, SURVEY.md §5)"""

    max_frames: int = 5
    cull_redundant_keyframes: bool = True
    kf_redundancy_threshold: float = 0.9  # fraction seen by >= 3 other KFs
    min_keyframes_before_cull: int = 8
    max_landmarks: int = 0  # 0 = unlimited; else evict least-recently-seen
    # Landmarks observed by any of the last N keyframes are never evicted
    # (they are the live tracking reference/arena); see Map.evict_landmarks.
    budget_protect_recent: int = 8


@dataclass
class AdditionalParamsConfig:
    """(reference config.py:67-70)"""

    ransac_threshold: float = 3e-3
    ransac_prob: float = 0.999


@dataclass
class Config:
    """Aggregate configuration (reference config.py:72-109)."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    initialization: InitializationConfig = field(default_factory=InitializationConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    local_mapping: LocalMappingConfig = field(default_factory=LocalMappingConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    loop_closing: LoopClosingConfig = field(default_factory=LoopClosingConfig)
    map: MapConfig = field(default_factory=MapConfig)
    additional_params: AdditionalParamsConfig = field(default_factory=AdditionalParamsConfig)
    debug: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "Config":
        data = json.loads(Path(path).read_text())
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in data:
                continue
            val = data[f.name]
            if dataclasses.is_dataclass(f.type) or f.name in _SUBCONFIGS:
                sub = _SUBCONFIGS[f.name]
                known = {x.name for x in dataclasses.fields(sub)}
                kwargs[f.name] = sub(**{k: v for k, v in val.items() if k in known})
            else:
                kwargs[f.name] = val
        return cls(**kwargs)


_SUBCONFIGS = {
    "camera": CameraConfig,
    "feature": FeatureConfig,
    "initialization": InitializationConfig,
    "tracking": TrackingConfig,
    "local_mapping": LocalMappingConfig,
    "optimization": OptimizationConfig,
    "loop_closing": LoopClosingConfig,
    "map": MapConfig,
    "additional_params": AdditionalParamsConfig,
}
