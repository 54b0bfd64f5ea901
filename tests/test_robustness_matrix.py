"""4-arm f32-robustness gate.

The repo's documented #1 fragility class is f32 near-tie luck: marginal
weak-parallax windows have near-null cost directions, so a pure
landmark-permutation of the BA pack (or a dense<->sparse solver swap) can
flip accept/reject decisions and cascade into meters of ATE (observed:
dense solver, reversed order: 0.07 -> 2.5 before the round-3 fixes).
scripts/robustness_matrix.py proved both marginal fixtures robust across
{dense, sparse} x {normal, reversed pack}; this test RUNS that matrix in
the default suite so the next numeric regression fails loudly instead of
landing silently.

The endurance scenario (36 frames, culling, windowed BA) runs all 4 arms;
the blackout/loop scenario (100 frames + loop closing) runs the 2 diagonal
arms (dense/normal is already covered per-frame by test_endurance_loop.py;
the diagonal adds the solver x order cross-perturbation at ~4 min/arm on
the 1-core CI host).
"""
import os
import sys

import pytest

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
)

from robustness_matrix import blackout_scenario, endurance_scenario, run_arm  # noqa: E402


@pytest.fixture(scope="module")
def endurance():
    return endurance_scenario()


@pytest.fixture(scope="module")
def blackout():
    return blackout_scenario()


@pytest.mark.parametrize(
    "sparse,reverse",
    [(False, False), (False, True), (True, False), (True, True)],
    ids=["dense-normal", "dense-reversed", "sparse-normal", "sparse-reversed"],
)
def test_endurance_arms(endurance, sparse, reverse):
    frames, Ts_gt, K, cfg, gate = endurance
    ate = run_arm(frames, Ts_gt, K, cfg, sparse, reverse)
    assert ate < gate, (
        f"endurance arm sparse={sparse} reversed={reverse}: "
        f"ATE {ate:.4f} >= gate {gate:.3f} — an f32-luck regression "
        "(solver or pack-order sensitivity), see module docstring"
    )


@pytest.mark.parametrize(
    "sparse,reverse",
    [(False, True), (True, False)],
    ids=["dense-reversed", "sparse-normal"],
)
def test_blackout_arms(blackout, sparse, reverse):
    frames, Ts_gt, K, cfg, gate = blackout
    ate = run_arm(frames, Ts_gt, K, cfg, sparse, reverse)
    assert ate < gate, (
        f"blackout arm sparse={sparse} reversed={reverse}: "
        f"ATE {ate:.4f} >= gate {gate:.3f}"
    )
