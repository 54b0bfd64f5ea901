"""chip_smoke.py and bench.py on the CPU: both refuse to run without a GPU,
the compile cache lands where the package says, and chip_smoke's phase-b
comparisons and trace reduction work at tiny shapes (two CPU devices stand
in for the GPU and the CPU reference)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _run(args, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script):
    r = _run([script])
    assert r.returncode != 0
    assert "'cpu'" in r.stderr, r.stderr[-2000:]
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


@pytest.mark.parametrize("set_env", [True, False])
def test_compile_cache_placement(tmp_path, set_env):
    code = ("import jax, visual_slam_tpu; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(visual_slam_tpu.CACHE_DIR)")
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")} if set_env else {}
    r = _run(["-c", code], env_extra=env, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr[-2000:]
    want = str(tmp_path / "cc") if set_env else str(REPO / ".jax_cache")
    assert r.stdout.split() == [want, want]


CHECKS = [
    ("check_match_descriptors", dict(n=96)),
    ("check_match_batched", dict(n_cand=2, k=64)),
    ("check_guided", dict(m=256, kp=96)),
    ("check_detect", dict(H=96, W=160, num_features=96, n_levels=2)),
    ("check_pnp", dict(n=200, n_hyp=16)),
    ("check_ba", dict(n_kf=3, m=64, n_iter=3)),
]


@pytest.mark.parametrize("name,sizes", CHECKS, ids=[c[0] for c in CHECKS])
def test_phase_b_check_tiny(name, sizes):
    dev_a, dev_b = jax.devices()[:2]
    getattr(chip_smoke, name)(dev_a, dev_b, **sizes)


def test_phase_b_check_raises_on_disagreement():
    with pytest.raises(AssertionError, match="above tolerance"):
        chip_smoke._report("fake", 2.0, 1.0, "reason", "precision")


def test_reduce_trace_attributes_named_scope(tmp_path):
    @jax.jit
    def f(x):
        with jax.named_scope("guided_match"):
            y = jnp.sin(x) @ x
        return jnp.cos(y).sum()

    x = jnp.ones((128, 128))
    f(x).block_until_ready()
    hlo = f.lower(x).compile().as_text()
    module = hlo.splitlines()[0].split()[1].rstrip(",")
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(2):
            f(x).block_until_ready()
    path = next(tmp_path.rglob("*.xplane.pb"))
    red = chip_smoke.reduce_trace(str(path), hlo, module, 2, plane_prefix="/host:CPU")
    assert red["step_ms"] > 0
    assert 0 < red["scope_ms"]["guided_match"] <= red["step_ms"]
    assert red["scope_ms"]["orb_patches"] == 0


def test_landmarks_from_depth_reproject():
    """Landmarks built from a depth map project back onto their keypoints."""
    from visual_slam_tpu.ops.detector import Features

    f, W, H = 100.0, 80, 60
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])
    T = np.eye(4)
    T[:3, 3] = [0.5, -0.2, 1.0]
    depth = np.full((H, W), np.inf, np.float32)
    depth[10:50, 10:70] = 7.0
    xy = np.array([[20.0, 15.0], [40.0, 30.0], [75.0, 5.0]], np.float32)
    feats = Features(xy=xy, response=None, angle=None, octave=None, size=None,
                     desc=None, valid=np.ones(3, bool))
    lm, has = chip_smoke.landmarks_from_depth(feats, depth, K, T)
    np.testing.assert_array_equal(has, [True, True, False])
    pc = lm[has] @ T[:3, :3].T + T[:3, 3]
    np.testing.assert_allclose(pc[:, 2], 7.0, rtol=1e-6)
    np.testing.assert_allclose((pc[:, :2] / pc[:, 2:]) * f + [W / 2, H / 2], xy[has],
                               atol=1e-4)


def test_last_line_contract(monkeypatch, capsys):
    """With every phase stubbed, main() prints the device JSON last."""
    for fn in ("phase_b", "phase_main_path", "phase_host_slam", "phase_stereo"):
        monkeypatch.setattr(chip_smoke, fn, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "require_gpu", lambda count=1: jax.devices())
    monkeypatch.setattr(chip_smoke, "phase_device", lambda devs: "card, 700.00 W")
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    dev = jax.devices()[0]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}}
