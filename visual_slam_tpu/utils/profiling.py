"""Tracing / profiling subsystem.

New capability — the reference has none (SURVEY.md §5 tracing: "none").
Provides per-stage wall-clock timers with summary statistics, a
jax.profiler trace context for device-level inspection, XLA's FLOP count of
a compiled call, and the GPU's name and power limit.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import numpy as np


class StageTimer:
    """Accumulates per-stage wall-clock samples.

    Usage::

        timer = StageTimer()
        with timer("detect"):
            ...
        print(timer.summary())
    """

    def __init__(self):
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[stage].append(time.perf_counter() - t0)

    def add(self, stage: str, seconds: float) -> None:
        self._samples[stage].append(seconds)

    def stats(self, stage: str) -> dict:
        xs = np.asarray(self._samples.get(stage, []))
        if xs.size == 0:
            return {}
        return {
            "n": int(xs.size),
            "mean_ms": float(xs.mean() * 1e3),
            "median_ms": float(np.median(xs) * 1e3),
            "p90_ms": float(np.quantile(xs, 0.9) * 1e3),
            "total_s": float(xs.sum()),
        }

    def summary(self) -> dict:
        return {k: self.stats(k) for k in sorted(self._samples)}

    def report(self) -> str:
        lines = [f"{'stage':<24}{'n':>6}{'mean ms':>10}{'p50 ms':>10}{'p90 ms':>10}{'total s':>10}"]
        for k, s in self.summary().items():
            lines.append(
                f"{k:<24}{s['n']:>6}{s['mean_ms']:>10.2f}{s['median_ms']:>10.2f}"
                f"{s['p90_ms']:>10.2f}{s['total_s']:>10.2f}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self._samples.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context: view with TensorBoard/XProf."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def flops_of(jitted, *args, **kwargs) -> float | None:
    """XLA-cost-model FLOPs of one call of a jitted function (AOT
    ``lower().compile().cost_analysis()``). Returns None when the backend
    doesn't report a cost model. Static keyword args pass through ``kwargs``.
    Wall-clock alone says nothing about distance from roofline; this is the
    operation count to divide by it."""
    try:
        ca = jitted.lower(*args, **kwargs).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        f = float(ca.get("flops", 0.0))
        return f if f > 0 else None
    except Exception:
        return None


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, e.g.
    ``"NVIDIA H100 80GB HBM3, 700.00 W"``. A card set below its maximum
    power runs slower under load, so every time taken on it is reported
    beside this line. One line per card, joined by ``"; "``."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return "; ".join(line.strip() for line in out.splitlines() if line.strip())


GLOBAL_TIMER = StageTimer()
