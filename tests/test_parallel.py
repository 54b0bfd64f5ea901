"""Multi-device tests on the 8 virtual CPU devices (conftest)."""
import numpy as np
import jax
import jax.numpy as jnp

from visual_slam_tpu.parallel import make_mesh, bundle_adjust_sharded
from visual_slam_tpu.backend.ba import bundle_adjust
from test_ba import make_ba_problem


def test_mesh_factorization():
    mesh = make_mesh(("seq", "lm"))
    assert mesh.shape["seq"] * mesh.shape["lm"] == 8
    mesh1 = make_mesh("lm")
    assert mesh1.shape["lm"] == 8


def test_sharded_ba_matches_single_device(rng):
    problem, T_gt, pts_gt, f = make_ba_problem(rng, W=4, M=128, noise_px=0.2, n_fixed=2)
    T1, X1, info1 = bundle_adjust(problem, n_iter=10, huber=5.0 / f)
    mesh = make_mesh("lm")
    T8, X8, info8 = bundle_adjust_sharded(problem, mesh, axis="lm", n_iter=10, huber=5.0 / f)
    np.testing.assert_allclose(np.asarray(T8), np.asarray(T1), atol=2e-4)
    # Landmarks sit at depth ~15: psum partial-sum order differs from the
    # single-device summation at f32, and 10 LM iterations amplify it to
    # ~rtol 2e-4 of the coordinate magnitude (measured maxdX 1.04e-3 after
    # the unrolled-contraction solve relower; costs agree to 7 digits).
    np.testing.assert_allclose(np.asarray(X8), np.asarray(X1), atol=5e-3)
    np.testing.assert_allclose(float(info8["cost"]), float(info1["cost"]), rtol=1e-3)


def test_batched_vo_step_shards(rng):
    """Tiny batched VO: 8 sequences of small random images over the mesh."""
    from visual_slam_tpu.parallel.multiseq import make_batched_vo, shard_batch
    from visual_slam_tpu.pipeline import init_track_state
    from visual_slam_tpu.ops.detector import detect_and_describe_with_sampling
    from visual_slam_tpu.ops.orb import sampling_matrix

    mesh = make_mesh("seq")
    B, H, W = 8, 64, 80
    f = 100.0
    K = jnp.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], jnp.float32)
    imgs = jnp.asarray(rng.uniform(0, 255, (B, H, W)), jnp.float32)

    feats = jax.vmap(
        lambda im, s: detect_and_describe_with_sampling(
            im, s, num_features=64, threshold=10.0, n_levels=1, grid=2
        ),
        in_axes=(0, None),
    )(imgs, sampling_matrix())
    Kslots = 64
    landmarks = jnp.asarray(rng.uniform(-1, 1, (B, Kslots, 3)), jnp.float32) + jnp.array([0, 0, 5.0])
    has = jnp.ones((B, Kslots), bool)
    states = jax.vmap(lambda ft, lm, h: init_track_state(ft, lm, h, jnp.eye(4)))(
        feats, landmarks, has
    )
    states = shard_batch(mesh, "seq", states)
    step = make_batched_vo(
        K, mesh, num_features=64, fast_threshold=10.0, n_levels=1, grid=2,
        pnp_hypotheses=32,
    )
    new_states, outs = step(states, imgs)
    assert outs.T_w2c.shape == (B, 4, 4)
    assert np.isfinite(np.asarray(outs.T_w2c)).all()


def test_frontback_pipeline_two_stage():
    """Pipeline-parallel front-end/back-end split (parallel/frontback.py):
    stage 0 detects+matches frame t while stage 1 solves frame t-1, one
    ppermute per frame, whole loop in ONE shard_map program."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from render import make_world, render, camera_path, render_with_depth
    from visual_slam_tpu.ops.detector import detect_and_describe
    from visual_slam_tpu.ops.orb import sampling_matrix
    from visual_slam_tpu.parallel import make_frontback_pipeline

    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    rng = np.random.default_rng(3)
    world = make_world(rng)
    Ts = camera_path(4, step=0.15)
    f, W, H = 260.0, 320, 240
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], np.float32)
    frames = np.stack([render(world, T, K, W, H) for T in Ts]).astype(np.float32)
    NF = 256
    feats0 = detect_and_describe(
        jnp.asarray(frames[0]), num_features=NF, threshold=12.0, n_levels=2, grid=4
    )
    _, zbuf = render_with_depth(world, Ts[0], K, W, H)
    Kinv = np.linalg.inv(K)
    xy = np.asarray(feats0.xy)
    valid = np.asarray(feats0.valid)
    lm = np.zeros((NF, 3), np.float32)
    has = np.zeros(NF, bool)
    for i in np.nonzero(valid)[0]:
        ui, vi = int(round(xy[i, 0])), int(round(xy[i, 1]))
        if 0 <= ui < W and 0 <= vi < H and zbuf[vi, ui] > 0.5:
            lm[i] = (Kinv @ np.array([xy[i, 0], xy[i, 1], 1.0])) * float(zbuf[vi, ui])
            has[i] = True
    pipe = make_frontback_pipeline(
        jnp.asarray(K), mesh, num_features=NF, fast_threshold=12.0, n_levels=2, grid=4
    )
    Tout, ninl = pipe(jnp.asarray(frames), feats0, lm, has, np.eye(4), sampling_matrix())
    Tout, ninl = np.asarray(Tout), np.asarray(ninl)
    assert ninl[0] == 0  # pipeline bubble
    # row t = back-end solve of frame t-1 against the frame-0 reference
    for t in range(1, len(frames)):
        assert ninl[t] >= 15, ninl
        terr = np.linalg.norm(Tout[t][:3, 3] - Ts[t - 1][:3, 3])
        assert terr < 0.1, (t, terr)


def test_pipelined_vo_family_tracks_rendered_sequence():
    """PipelinedVO: the deployable front/back pipeline
    family must bootstrap, track a rendered sequence in chunks through the
    2-stage pp mesh, promote keyframes with triangulation + BA, and land a
    usable trajectory."""
    import sys

    from jax.sharding import Mesh

    sys.path.insert(0, ".")
    from render import render_sequence
    from visual_slam_tpu.camera import PinholeCamera
    from visual_slam_tpu.config import Config
    from visual_slam_tpu.models import PipelinedVO
    from visual_slam_tpu.utils.metrics import ate_rmse

    rng = np.random.default_rng(42)
    frames, Ts_gt, K, world = render_sequence(rng, n_frames=13, step=0.3)
    cam = PinholeCamera(width=frames[0].shape[1], height=frames[0].shape[0], K=K)
    cfg = Config()
    cfg.feature.num_features = 384
    cfg.feature.num_pyramid_levels = 2
    cfg.feature.fast_threshold = 12.0
    cfg.feature.grid_cells = 4
    cfg.initialization.min_inliers = 40
    cfg.initialization.min_parallax_deg = 0.5
    cfg.tracking.keyframe_interval = 2
    cfg.optimization.n_iter = 12
    mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    vo = PipelinedVO(cam, mesh=mesh, config=cfg, num_features=384, chunk=3,
                     n_levels=2, grid=4, fast_threshold=12.0)
    for i, img in enumerate(frames):
        vo.track([img], timestamp=i * 0.1)
    vo.shutdown()
    assert vo.state.name == "OK"
    assert vo.map.num_keyframes() >= 4
    ts, Ts = vo.trajectory()
    assert len(ts) >= 10
    idx = [int(round(t / 0.1)) for t in ts]
    est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    gt = np.stack([-Ts_gt[i][:3, :3].T @ Ts_gt[i][:3, 3] for i in idx])
    res = ate_rmse(est, gt, align_scale=True)
    # The pp family trades per-frame robustness machinery (no guided arena,
    # no brute recovery) for the 2-stage overlap; gate accordingly.
    assert res["rmse"] < 0.7, res


def test_frontback_pipeline_batched_sequences():
    """seq x pp composition: two sequences ride the 2-stage pipeline
    data-parallel (batch_axis); each sequence's solves must match its own
    single-sequence pipeline run."""
    from jax.sharding import Mesh

    from visual_slam_tpu.ops.detector import detect_and_describe_with_sampling
    from visual_slam_tpu.ops.orb import sampling_matrix
    from visual_slam_tpu.parallel.frontback import make_frontback_pipeline

    rng = np.random.default_rng(5)
    H, W, f = 64, 80, 100.0
    K = jnp.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]], jnp.float32)
    nfeat = 64
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("seq", "pp"))
    samp = sampling_matrix()

    def seq_inputs(seed):
        r = np.random.default_rng(seed)
        imgs = jnp.asarray(r.uniform(0, 255, (3, H, W)), jnp.float32)
        feats = detect_and_describe_with_sampling(
            imgs[0], samp, num_features=nfeat, threshold=10.0, n_levels=1, grid=2
        )
        z = r.uniform(4, 10, nfeat).astype(np.float32)
        xy = np.asarray(feats.xy)
        rays = np.concatenate([xy, np.ones((nfeat, 1), np.float32)], 1) @ np.asarray(
            jnp.linalg.inv(K)
        ).T
        return imgs, feats, rays * z[:, None], np.asarray(feats.valid)

    seqs = [seq_inputs(7), seq_inputs(8)]
    batched = make_frontback_pipeline(
        K, mesh, num_features=nfeat, fast_threshold=10.0, n_levels=1, grid=2,
        batch_axis="seq",
    )
    frames_b = jnp.stack([s[0] for s in seqs])
    feats_b = jax.tree.map(lambda *xs: jnp.stack(xs), *[s[1] for s in seqs])
    lm_b = np.stack([s[2] for s in seqs])
    has_b = np.stack([s[3] for s in seqs])
    T0_b = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    Ts_b, inl_b = batched(frames_b, feats_b, lm_b, has_b, T0_b, samp)
    assert Ts_b.shape == (3, 2, 4, 4) and inl_b.shape == (3, 2)

    pp_mesh = Mesh(np.array(jax.devices()[:2]), ("pp",))
    single = make_frontback_pipeline(
        K, pp_mesh, num_features=nfeat, fast_threshold=10.0, n_levels=1, grid=2
    )
    for s_i, (imgs, feats, lm, has) in enumerate(seqs):
        Ts_s, inl_s = single(imgs, feats, lm, has, np.eye(4, dtype=np.float32), samp)
        np.testing.assert_allclose(
            np.asarray(Ts_b)[:, s_i], np.asarray(Ts_s)[: Ts_b.shape[0]], atol=2e-4
        )


def test_sharded_sparse_ba_matches_single_device(rng):
    """Sparse landmark-major layout sharded over the mesh: same psum
    structure as the dense grid (bundle_adjust_sparse_sharded)."""
    from visual_slam_tpu.parallel.ba_sharded import bundle_adjust_sparse_sharded
    from visual_slam_tpu.backend.ba import bundle_adjust_sparse
    from visual_slam_tpu.backend.ba import BASparse

    problem, T_gt, pts_gt, f = make_ba_problem(
        rng, W=4, M=128, noise_px=0.2, n_fixed=2
    )
    sparse = BASparse.from_dense(problem, 4)
    T1, X1, info1 = bundle_adjust_sparse(sparse, n_iter=10, huber=5.0 / f)
    mesh = make_mesh("lm")
    T8, X8, info8 = bundle_adjust_sparse_sharded(
        sparse, mesh, axis="lm", n_iter=10, huber=5.0 / f
    )
    np.testing.assert_allclose(np.asarray(T8), np.asarray(T1), atol=1e-4)
    np.testing.assert_allclose(np.asarray(X8), np.asarray(X1), atol=1e-3)
    np.testing.assert_allclose(float(info8["cost"]), float(info1["cost"]), rtol=1e-3)
