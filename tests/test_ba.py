import numpy as np
import jax.numpy as jnp

from visual_slam_tpu.backend.ba import (
    BAProblem,
    bundle_adjust,
    bundle_adjust_robust,
    mean_reprojection_error,
)
from synthetic import default_K, make_scene


def make_ba_problem(rng, W=4, M=120, noise_px=0.3, perturb=True, n_fixed=1,
                    pose_noise=0.02, point_noise=0.05):
    """W cameras looking at a cloud of M points; observations in normalized
    coords; optionally perturb initial poses/points away from GT."""
    from scipy.spatial.transform import Rotation

    f = 500.0
    pts = np.stack([
        rng.uniform(-4, 4, M),
        rng.uniform(-3, 3, M),
        rng.uniform(8, 16, M),
    ], axis=1)
    T_gt = np.zeros((W, 4, 4))
    for w in range(W):
        ang = rng.uniform(-0.03, 0.03, 3)
        R = Rotation.from_rotvec(ang).as_matrix()
        C = np.array([w * 0.8, 0.1 * w, 0.0])
        T_gt[w] = np.eye(4)
        T_gt[w, :3, :3] = R
        T_gt[w, :3, 3] = -R @ C
    uv = np.zeros((M, W, 2))
    valid = np.zeros((M, W), bool)
    for w in range(W):
        pc = pts @ T_gt[w, :3, :3].T + T_gt[w, :3, 3]
        xy = pc[:, :2] / pc[:, 2:3]
        uv[:, w] = xy + rng.normal(0, noise_px / f, (M, 2))
        valid[:, w] = pc[:, 2] > 0.5
    T0 = T_gt.copy()
    pts0 = pts.copy()
    if perturb:
        for w in range(n_fixed, W):
            dang = rng.normal(0, pose_noise, 3)
            dR = Rotation.from_rotvec(dang).as_matrix()
            T0[w, :3, :3] = dR @ T0[w, :3, :3]
            T0[w, :3, 3] += rng.normal(0, pose_noise * 2, 3)
        pts0 = pts + rng.normal(0, point_noise, pts.shape)
    fixed = np.zeros(W, bool)
    fixed[:n_fixed] = True
    problem = BAProblem(
        T_w2c=jnp.asarray(T0, jnp.float32),
        points=jnp.asarray(pts0, jnp.float32),
        uv=jnp.asarray(uv, jnp.float32),
        obs_valid=jnp.asarray(valid),
        pose_valid=jnp.ones(W, bool),
        pose_fixed=jnp.asarray(fixed),
    )
    return problem, T_gt, pts, f


def test_ba_reduces_cost(rng):
    problem, T_gt, pts_gt, f = make_ba_problem(rng)
    T, X, info = bundle_adjust(problem, n_iter=15, huber=5.0 / f)
    assert float(info["cost"]) < float(info["cost0"]) * 0.1
    err_px = float(mean_reprojection_error(T, X, problem.uv, problem.obs_valid, focal=f))
    assert err_px < 0.6  # ~ injected noise level


def test_ba_recovers_poses_two_fixed(rng):
    """With two gauge-fixed cameras (kills scale freedom) and tiny noise, LM
    should recover GT poses and points."""
    problem, T_gt, pts_gt, f = make_ba_problem(rng, noise_px=0.05, n_fixed=2)
    T, X, info = bundle_adjust(problem, n_iter=25, huber=5.0 / f)
    T = np.asarray(T)
    X = np.asarray(X)
    np.testing.assert_allclose(T[:, :3, :3], T_gt[:, :3, :3], atol=2e-3)
    np.testing.assert_allclose(T[:, :3, 3], T_gt[:, :3, 3], atol=1e-2)
    np.testing.assert_allclose(X, pts_gt, atol=5e-2)


def test_ba_fixed_pose_untouched(rng):
    problem, T_gt, pts_gt, f = make_ba_problem(rng)
    T, X, info = bundle_adjust(problem, n_iter=10, huber=5.0 / f)
    np.testing.assert_allclose(np.asarray(T[0]), T_gt[0], atol=1e-7)


def test_ba_robust_to_outlier_observations(rng):
    problem, T_gt, pts_gt, f = make_ba_problem(rng, noise_px=0.2, n_fixed=2)
    uv = np.asarray(problem.uv).copy()
    # corrupt 10% of observations badly
    n_bad = len(uv) // 10
    uv[:n_bad, :, :] += rng.uniform(-0.2, 0.2, (n_bad, uv.shape[1], 2))
    problem = problem._replace(uv=jnp.asarray(uv))
    T, X, info = bundle_adjust_robust(problem, n_iter=12, n_iter2=12, huber=3.0 / f)
    T = np.asarray(T)
    # poses should still be near GT: Huber + interim outlier trim
    assert int(info["n_trimmed"]) > 0
    np.testing.assert_allclose(T[:, :3, :3], T_gt[:, :3, :3], atol=5e-3)
    np.testing.assert_allclose(T[:, :3, 3], T_gt[:, :3, 3], atol=3e-2)


def test_ba_handles_empty_slots(rng):
    """Padded (invalid) poses/points must not break the solve."""
    problem, T_gt, pts_gt, f = make_ba_problem(rng, W=4)
    pose_valid = np.array([True, True, True, False])
    obs_valid = np.asarray(problem.obs_valid).copy()
    obs_valid[:, 3] = False
    obs_valid[-20:, :] = False  # some dead landmark slots
    problem = problem._replace(
        pose_valid=jnp.asarray(pose_valid), obs_valid=jnp.asarray(obs_valid)
    )
    T, X, info = bundle_adjust(problem, n_iter=10, huber=5.0 / f)
    assert np.isfinite(np.asarray(T)).all()
    assert np.isfinite(np.asarray(X)).all()
    assert float(info["cost"]) <= float(info["cost0"])


# ---------------------------------------------------------------------------
# Sparse landmark-major solver (backend/ba.py BASparse)
# ---------------------------------------------------------------------------

from visual_slam_tpu.backend.ba import (  # noqa: E402
    BASparse,
    bundle_adjust_sparse,
    bundle_adjust_robust_sparse,
)


def test_sparse_matches_dense(rng):
    """Identical LM trajectory: the sparse layout is the same math with a
    different summation order, so poses/points must agree tightly."""
    problem, T_gt, pts_gt, f = make_ba_problem(rng, W=5, M=150, n_fixed=2)
    sparse = BASparse.from_dense(problem, 5)
    Td, Xd, infod = bundle_adjust(problem, n_iter=15, huber=5.0 / f)
    Ts, Xs, infos = bundle_adjust_sparse(sparse, n_iter=15, huber=5.0 / f)
    np.testing.assert_allclose(np.asarray(Ts), np.asarray(Td), atol=2e-4)
    np.testing.assert_allclose(np.asarray(Xs), np.asarray(Xd), atol=2e-3)
    np.testing.assert_allclose(
        float(infos["cost"]), float(infod["cost"]), rtol=1e-3
    )


def test_sparse_robust_matches_dense(rng):
    problem, T_gt, pts_gt, f = make_ba_problem(rng, noise_px=0.2, n_fixed=2)
    uv = np.asarray(problem.uv).copy()
    n_bad = len(uv) // 10
    uv[:n_bad, :, :] += rng.uniform(-0.2, 0.2, (n_bad, uv.shape[1], 2))
    problem = problem._replace(uv=jnp.asarray(uv))
    sparse = BASparse.from_dense(problem, 4)
    Td, Xd, infod = bundle_adjust_robust(
        problem, n_iter=12, n_iter2=12, huber=3.0 / f
    )
    Ts, Xs, infos = bundle_adjust_robust_sparse(
        sparse, n_iter=12, n_iter2=12, huber=3.0 / f
    )
    assert int(infos["n_trimmed"]) > 0
    np.testing.assert_allclose(
        np.asarray(Ts)[:, :3, :3], T_gt[:, :3, :3], atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(Ts)[:, :3, 3], T_gt[:, :3, 3], atol=3e-2
    )
    # Same observations trimmed (track-length order vs window order).
    assert int(infos["n_trimmed"]) == int(infod["n_trimmed"])


def test_sparse_obs_cap_overflow_still_converges(rng):
    """K smaller than the longest track: the subset solve must still reduce
    cost and stay near GT (the pack keeps an evenly-spread subset)."""
    problem, T_gt, pts_gt, f = make_ba_problem(rng, W=6, M=150, n_fixed=2)
    sparse = BASparse.from_dense(problem, 3)  # tracks are up to 6 long
    Ts, Xs, infos = bundle_adjust_sparse(sparse, n_iter=15, huber=5.0 / f)
    assert float(infos["cost"]) < float(infos["cost0"])
    # Half the observations dropped -> looser optimum, but still near GT.
    np.testing.assert_allclose(
        np.asarray(Ts)[:, :3, 3], T_gt[:, :3, 3], atol=1e-1
    )


def test_sparse_handles_empty_slots(rng):
    problem, T_gt, pts_gt, f = make_ba_problem(rng, W=4)
    sparse = BASparse.from_dense(problem, 4)
    s_valid = np.asarray(sparse.obs_valid).copy()
    s_valid[-20:, :] = False
    pose_valid = np.array([True, True, True, False])
    sparse = sparse._replace(
        obs_valid=jnp.asarray(s_valid), pose_valid=jnp.asarray(pose_valid)
    )
    T, X, info = bundle_adjust_sparse(sparse, n_iter=10, huber=5.0 / f)
    assert np.isfinite(np.asarray(T)).all()
    assert np.isfinite(np.asarray(X)).all()
    assert float(info["cost"]) <= float(info["cost0"])


def test_sparse_obs_auto_selects_by_window(monkeypatch):
    """sparse_obs="auto": the optimizer packs the sparse landmark-major
    layout only once the pose bucket reaches sparse_auto_min_window (below
    it the dense grid's Schur cross term dominates either way and dense
    avoids the gather/one-hot overhead)."""
    import pytest

    from visual_slam_tpu.backend.optimizer import LMOptimizer
    from visual_slam_tpu.camera import PinholeCamera
    from visual_slam_tpu.config import Config

    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    cfg = Config()
    cfg.optimization.sparse_obs = "auto"
    cfg.optimization.sparse_auto_min_window = 32
    opt = LMOptimizer(cfg, PinholeCamera(320, 240, K))

    class _Stop(Exception):
        pass

    calls = []

    def fake_pack(*a, **k):
        calls.append("dense")
        raise _Stop

    def fake_pack_sparse(*a, **k):
        calls.append("sparse")
        raise _Stop

    monkeypatch.setattr(opt, "_pack", fake_pack)
    monkeypatch.setattr(opt, "_pack_sparse", fake_pack_sparse)
    for w_bucket in (16, 32):
        with pytest.raises(_Stop):
            opt.solve_start([], [], w_bucket)
    assert calls == ["dense", "sparse"]


# ---------------------------------------------------------------------------
# Landmark-MINOR dense solver (backend/ba.py bundle_adjust_lm): the same
# math with the landmark axis last.
# ---------------------------------------------------------------------------

from visual_slam_tpu.backend.ba import (  # noqa: E402
    bundle_adjust_lm,
    bundle_adjust_robust_lm,
)


def test_lm_minor_matches_reference_layout(rng):
    """Identical LM trajectory to the (M, W)-major solver up to f32
    summation-order noise."""
    problem, T_gt, pts_gt, f = make_ba_problem(rng, W=5, M=150, n_fixed=2)
    Td, Xd, infod = bundle_adjust(problem, n_iter=15, huber=5.0 / f)
    Tl, Xl, infol = bundle_adjust_lm(problem, n_iter=15, huber=5.0 / f)
    np.testing.assert_allclose(np.asarray(Tl), np.asarray(Td), atol=2e-4)
    np.testing.assert_allclose(np.asarray(Xl), np.asarray(Xd), atol=2e-3)
    np.testing.assert_allclose(
        float(infol["cost"]), float(infod["cost"]), rtol=1e-3
    )


def test_lm_minor_robust_matches_reference_layout(rng):
    problem, T_gt, pts_gt, f = make_ba_problem(rng, noise_px=0.2, n_fixed=2)
    uv = np.asarray(problem.uv).copy()
    n_bad = len(uv) // 10
    uv[:n_bad, :, :] += rng.uniform(-0.2, 0.2, (n_bad, uv.shape[1], 2))
    problem = problem._replace(uv=jnp.asarray(uv))
    Td, Xd, infod = bundle_adjust_robust(
        problem, n_iter=12, n_iter2=12, huber=3.0 / f
    )
    Tl, Xl, infol = bundle_adjust_robust_lm(
        problem, n_iter=12, n_iter2=12, huber=3.0 / f
    )
    assert int(infol["n_trimmed"]) == int(infod["n_trimmed"])
    np.testing.assert_allclose(
        np.asarray(Tl)[:, :3, 3], T_gt[:, :3, 3], atol=3e-2
    )


def test_lm_minor_fixed_pose_untouched(rng):
    problem, T_gt, pts_gt, f = make_ba_problem(rng, n_fixed=2)
    T0 = np.asarray(problem.T_w2c).copy()
    Tl, _, _ = bundle_adjust_lm(problem, n_iter=10, huber=5.0 / f)
    np.testing.assert_array_equal(np.asarray(Tl)[0], T0[0])
    np.testing.assert_array_equal(np.asarray(Tl)[1], T0[1])


def test_lm_minor_auto_backend_gate(monkeypatch):
    """lm_minor is a plain opt-in: off by default (dense reference layout on
    every backend), the landmark-minor solver only when set to True."""
    import pytest

    from visual_slam_tpu.backend import optimizer as opt_mod
    from visual_slam_tpu.camera import PinholeCamera
    from visual_slam_tpu.config import Config

    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    cfg = Config()
    assert cfg.optimization.lm_minor is False
    opt = opt_mod.LMOptimizer(cfg, PinholeCamera(320, 240, K))

    class _Stop(Exception):
        pass

    calls = []

    def fake(name):
        def solve(*a, **k):
            calls.append(name)
            raise _Stop
        return solve

    monkeypatch.setattr(opt, "_pack", lambda *a, **k: (None,) * 5)
    monkeypatch.setattr(opt_mod, "bundle_adjust_robust", fake("reference"))
    monkeypatch.setattr(opt_mod, "bundle_adjust_robust_lm", fake("lm_minor"))
    for mode in (False, True):
        cfg.optimization.lm_minor = mode
        with pytest.raises(_Stop):
            opt.solve_start([], [], 16)
    assert calls == ["reference", "lm_minor"]
