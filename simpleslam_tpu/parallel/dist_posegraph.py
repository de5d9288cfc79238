"""Distributed pose-graph BA: edges sharded over the mesh, XLA collectives.

The scaling component demanded by BASELINE.json (no reference counterpart —
the reference is single-process GTSAM). Design: the O(E) work (per-edge
linearization, 6x6 block einsums, edge-wise H·v matvecs) is partitioned over
the ``kf`` mesh axis; the O(K) state (pose estimates, CG vectors,
block-Jacobi preconditioner — a few hundred KB even at 2048 keyframes) is
kept replicated, so the solve needs only small collectives (see
``ops.posegraph.solve_impl`` for the three modes and how many each issues).
This is the Schur-free formulation of distributed BA: for pose-graph
problems (every factor binary in poses) the normal equations ARE the reduced
camera system, so block elimination degenerates to the edge-parallel matvec
implemented here.

Partitioning edges (not keyframes) keeps the gather ``v[edge_i]`` local —
keyframe-sharded layouts need a halo exchange per matvec; edge-sharded
layouts need none, at the cost of replicating the (small) state. At SLAM
scales (K <= 10^4) the replicated state is a few MB and every collective is
latency-, not bandwidth-bound.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import posegraph as pgo


def sharded_solve(mesh: Mesh, axis: str = "kf", max_iters: int = 10,
                  cg_iters: int = 64, shard_cg: bool = False,
                  shard_lin: bool = False):
    """Build a jitted edge-sharded solver: PoseGraph -> SolveResult.

    Edge arrays must be shardable by ``mesh.shape[axis]`` along dim 0
    (pad ``e_cap`` to a multiple of the mesh size). Poses/prior replicate.
    ``shard_cg`` selects the fine-grained mode where the CG matvec and
    preconditioner shard too (one (K, 6) psum per CG iteration);
    ``shard_lin`` the session-scale mode where the whole linearization
    (including segment reductions) shards behind ONE fused all_gather per
    LM iteration and CG runs replicated — see ``ops.posegraph.solve_impl``
    for the latency-vs-replication trade.
    """

    def body(g: pgo.PoseGraph):
        return pgo.solve_impl(g, max_iters=max_iters, cg_iters=cg_iters,
                              axis=axis, shard_cg=shard_cg,
                              shard_lin=shard_lin)

    sharded = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(pgo.PoseGraph(
            poses=P(), kf_mask=P(),
            edge_i=P(axis), edge_j=P(axis), edge_T=P(axis),
            edge_info=P(axis), edge_mask=P(axis),
            prior_pose=P(), prior_info=P(),
        ),),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(sharded)


def _ring_graph(k: int, k_cap: int, e_cap: int, drift: float = 0.05,
                seed: int = 0, n_lc: int = 0, return_gt: bool = False):
    """Synthetic loop graph (circle + closures) for dry runs and scaling tests.

    ``n_lc`` extra loop-closure edges connect diametrically-opposed nodes so
    large graphs carry the long-range constraints a real LC-corrected SLAM
    graph has (denser reductions, harder conditioning).
    """
    from ..ops import geometry as geo

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, k, endpoint=False)
    gt = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    gt[:, 0, 3] = 10.0 * np.cos(th)
    gt[:, 1, 3] = 10.0 * np.sin(th)
    c, s = np.cos(th + np.pi / 2), np.sin(th + np.pi / 2)
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1] = c, -s, s, c
    gt_inv = np.linalg.inv(gt)

    n_e = k + n_lc
    assert n_e <= e_cap, (n_e, e_cap)
    ei = np.zeros(e_cap, np.int32)
    ej = np.zeros(e_cap, np.int32)
    eT = np.tile(np.eye(4, dtype=np.float32), (e_cap, 1, 1))
    einfo = np.zeros((e_cap, 6), np.float32)
    nxt = (np.arange(k) + 1) % k
    ei[:k] = np.arange(k)
    ej[:k] = nxt
    eT[:k] = np.einsum("kij,kjl->kil", gt_inv, gt[nxt]).astype(np.float32)
    einfo[:k] = [10.0, 10.0, 10.0, 1e4, 1e4, 1e4]
    if n_lc:
        a = rng.integers(0, k, n_lc)
        b = (a + k // 2) % k
        ei[k:n_e] = a
        ej[k:n_e] = b
        eT[k:n_e] = np.einsum("kij,kjl->kil", gt_inv[a], gt[b]).astype(np.float32)
        einfo[k:n_e] = [10.0, 10.0, 10.0, 1e4, 1e4, 1e4]
    emask = np.arange(e_cap) < n_e

    # drift the initial chain: one vmapped se3_exp for all steps, then a
    # host-side cumulative compose (keeps graph construction O(k) dispatches
    # -> O(1))
    tw = (rng.normal(0, drift, (k - 1, 6)) * [1, 1, 1, .2, .2, .2]
          ).astype(np.float32)
    noises = np.asarray(jax.vmap(geo.se3_exp)(jnp.asarray(tw)))
    init = np.tile(np.eye(4, dtype=np.float32), (k_cap, 1, 1))
    init[0] = gt[0]
    for a in range(k - 1):
        init[a + 1] = init[a] @ eT[a] @ noises[a]
    kmask = np.arange(k_cap) < k

    g = pgo.PoseGraph(
        poses=jnp.asarray(init), kf_mask=jnp.asarray(kmask),
        edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
        edge_T=jnp.asarray(eT), edge_info=jnp.asarray(einfo),
        edge_mask=jnp.asarray(emask),
        prior_pose=jnp.asarray(gt[0]),
        prior_info=jnp.asarray(np.full(6, 1e4, np.float32)),
    )
    return (g, gt) if return_gt else g


def dryrun(mesh: Mesh, axis: str | None = None) -> None:
    """Compile + execute the sharded BA step on the given mesh (driver hook).

    Covers all THREE distribution modes: replicated-CG, fully-sharded CG
    (K-sharded vectors, two collectives per CG iteration), and sharded
    linearization (local off-diagonal carries + per-LM gather)."""
    if axis is None:
        axis = next(iter(mesh.shape))
    n = int(np.prod(list(mesh.shape.values())))
    # k_cap divisible by the mesh so the K-sharded PCG slices evenly
    k_cap = ((32 + n - 1) // n) * n
    g = _ring_graph(k=24, k_cap=k_cap, e_cap=((64 + n - 1) // n) * n)
    for kw in ({}, {"shard_cg": True}, {"shard_lin": True}):
        fn = sharded_solve(mesh, axis=axis, max_iters=4, cg_iters=16, **kw)
        res = fn(g)
        res.poses.block_until_ready()
        assert np.isfinite(np.asarray(res.cost)), (
            f"sharded BA produced non-finite cost ({kw})")
        assert float(res.cost) <= float(res.cost0), (
            f"sharded BA did not reduce cost ({kw})")
