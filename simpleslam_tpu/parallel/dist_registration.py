"""Point-parallel (data-parallel) scan-to-map registration over a mesh.

The scan's points are sharded across the ``dp`` mesh axis; every device
computes the normal-equation contribution of its point shard against a
replicated map, and the 6x6 / 6-vector reductions ride one ``psum`` — the
canonical "big batched residual + tiny reduced state" SPMD pattern
(SURVEY.md §2.3 north star: batched registration data-parallel over points).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import loam
from ..ops.pointcloud import PointCloud
from ..ops.voxel import VoxelMap


def sharded_scan2map(mesh: Mesh, axis: str = "dp", max_iters: int = loam.MAX_ITERS):
    """Build a jitted sharded scan2map: (src, vm, init_pose) -> LoamResult.

    ``src`` leaves must be shardable by ``mesh.shape[axis]`` along dim 0;
    the voxel map and pose are replicated. The GN loop is the shared
    ``loam.gn_loop`` (incl. its cached-gather refresh policy, which stays
    replicated because pose and anchor are replicated); the per-iteration
    normal equations ride ONE fused psum of 43 floats — JtJ (36) + JtE (6) +
    n_valid — because a small collective's cost is per-launch latency,
    not payload.
    """

    def fused_psum(JtJ, JtE, n_valid):
        flat = jnp.concatenate(
            [JtJ.reshape(36), JtE, n_valid.astype(jnp.float32)[None]])
        flat = jax.lax.psum(flat, axis)
        return (flat[:36].reshape(6, 6), flat[36:42],
                flat[42].astype(jnp.int32))

    def shard_body(src: PointCloud, vm: VoxelMap, init_pose: jax.Array):
        return loam.gn_loop(src, vm, init_pose, max_iters,
                            reduce_fn=fused_psum,
                            rmax_reduce_fn=lambda r: jax.lax.pmax(r, axis))

    sharded = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(axis), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(sharded)
