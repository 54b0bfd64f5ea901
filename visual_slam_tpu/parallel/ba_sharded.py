"""Landmark-sharded bundle adjustment over a device mesh.

The Schur-complement structure of BA is naturally model-parallel in the
landmark dimension: each device owns a shard of landmarks + their
observations, builds partial pose-blocks, and one psum of O((6W)^2) data per
LM iteration completes the normal equations — the reduced (6W, 6W) solve is
replicated (tiny), back-substitution is local. Collectives ride the device
interconnect via shard_map; this is the scale-out path when windows outgrow one chip
(SURVEY.md §2c TP row).
"""
from __future__ import annotations

from functools import partial

import jax
from jax.sharding import Mesh, PartitionSpec as P

from ..backend.ba import BAProblem, BASparse, bundle_adjust, bundle_adjust_sparse


def bundle_adjust_sparse_sharded(
    problem: BASparse,
    mesh: Mesh,
    axis: str = "lm",
    n_iter: int = 20,
    huber: float = 5e-3,
    lam0: float = 1e-3,
):
    """Landmark-sharded solve on the sparse (K obs slots per landmark)
    layout — same collective structure as :func:`bundle_adjust_sharded`
    (partial pose blocks + one psum per iteration; back-substitution
    local). Preferable to the dense grid when the window is wide enough
    that each shard's (M/n, W) grid would dominate memory."""
    n_shards = mesh.shape[axis]
    M = problem.points.shape[0]
    if M % n_shards != 0:
        raise ValueError(
            f"landmark capacity {M} not divisible by mesh axis {axis}={n_shards}"
        )

    in_specs = BASparse(
        T_w2c=P(),
        points=P(axis),
        uv=P(axis),
        obs_pose=P(axis),
        obs_valid=P(axis),
        pose_valid=P(),
        pose_fixed=P(),
    )
    out_specs = (P(), P(axis), {"cost0": P(), "cost": P(), "costs": P(), "lambda": P()})

    fn = jax.jit(
        jax.shard_map(
            partial(
                bundle_adjust_sparse,
                n_iter=n_iter, huber=huber, lam0=lam0, axis_name=axis,
            ),
            mesh=mesh,
            in_specs=(in_specs,),
            out_specs=out_specs,
        )
    )
    return fn(problem)


def bundle_adjust_sharded(
    problem: BAProblem,
    mesh: Mesh,
    axis: str = "lm",
    n_iter: int = 20,
    huber: float = 5e-3,
    lam0: float = 1e-3,
):
    """Run the LM/Schur solver with the landmark axis sharded over ``axis``.

    The landmark capacity M must divide by the axis size (pad the problem to
    a bucket first — callers already bucket M to powers of two).
    Returns (T (replicated), X (sharded), info).
    """
    n_shards = mesh.shape[axis]
    M = problem.points.shape[0]
    if M % n_shards != 0:
        raise ValueError(f"landmark capacity {M} not divisible by mesh axis {axis}={n_shards}")

    in_specs = BAProblem(
        T_w2c=P(),
        points=P(axis),
        uv=P(axis),
        obs_valid=P(axis),
        pose_valid=P(),
        pose_fixed=P(),
    )
    out_specs = (P(), P(axis), {"cost0": P(), "cost": P(), "costs": P(), "lambda": P()})

    fn = jax.jit(
        jax.shard_map(
            partial(bundle_adjust, n_iter=n_iter, huber=huber, lam0=lam0, axis_name=axis),
            mesh=mesh,
            in_specs=(in_specs,),
            out_specs=out_specs,
        )
    )
    return fn(problem)
