"""Worker functions for the multi-process (simulated multi-host) harness.

Each worker runs inside one host process AFTER ``jax.distributed`` is
initialized (``multihost.run_hosts``), with ``jax.devices()`` spanning every
host. Signature: ``fn(payload: dict, num_processes: int, process_id: int)
-> JSON-serializable`` — results cross process boundaries as JSON, so they
are small summaries (timings, costs, checksums), never tensors.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np


def posegraph_worker(payload: Dict[str, Any], num_processes: int,
                     process_id: int) -> Dict[str, Any]:
    """Distributed pose-graph solve: build, warm, time ``reps`` solves.

    The synthetic loop graph is built identically on every host (numpy,
    seeded); only each host's edge shard is uploaded to its devices
    (``make_global_array``). Returns per-rep wall times, final cost, and the
    optimized poses of the first ``return_poses`` keyframes (parity checks).
    """
    import jax
    from jax.sharding import PartitionSpec as P

    from ..ops import posegraph as pgo
    from . import multihost as mh
    from .dist_posegraph import _ring_graph, sharded_solve

    k = int(payload.get("k", 256))
    k_cap = int(payload.get("k_cap", max(256, k)))
    e_cap = int(payload.get("e_cap", 2 * k_cap))
    n_dev = len(jax.devices())
    e_cap = ((e_cap + n_dev - 1) // n_dev) * n_dev
    max_iters = int(payload.get("max_iters", 6))
    cg_iters = int(payload.get("cg_iters", 32))
    reps = int(payload.get("reps", 3))
    n_lc = int(payload.get("n_lc", max(1, k // 64)))

    g_local = _ring_graph(k=k, k_cap=k_cap, e_cap=e_cap,
                          drift=float(payload.get("drift", 0.05)),
                          seed=int(payload.get("seed", 0)), n_lc=n_lc)
    g_np = jax.tree.map(np.asarray, g_local)

    mesh = mh.global_mesh(("kf",))
    specs = pgo.PoseGraph(
        poses=P(), kf_mask=P(),
        edge_i=P("kf"), edge_j=P("kf"), edge_T=P("kf"),
        edge_info=P("kf"), edge_mask=P("kf"),
        prior_pose=P(), prior_info=P(),
    )
    g = mh.tree_make_global(g_np, mesh, specs)

    fn = sharded_solve(mesh, axis="kf", max_iters=max_iters,
                       cg_iters=cg_iters,
                       shard_cg=bool(payload.get("shard_cg", False)),
                       shard_lin=bool(payload.get("shard_lin", False)))
    res = fn(g)
    res.poses.block_until_ready()  # warmup/compile

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn(g)
        res.poses.block_until_ready()
        times.append(time.perf_counter() - t0)

    n_ret = int(payload.get("return_poses", 0))
    # fully-replicated outputs: locally addressable on every process
    poses = np.asarray(
        res.poses.addressable_shards[0].data)[:n_ret] if n_ret else None
    return {
        "times_s": times,
        "cost0": float(np.asarray(res.cost0.addressable_shards[0].data)),
        "cost": float(np.asarray(res.cost.addressable_shards[0].data)),
        "n_devices": n_dev,
        "num_processes": num_processes,
        "poses": poses.tolist() if poses is not None else None,
    }


def registration_worker(payload: Dict[str, Any], num_processes: int,
                        process_id: int) -> Dict[str, Any]:
    """Point-parallel sharded scan2map: build a big fixture, warm, time.

    The dp-registration collective budget is ONE fused 43-float psum per GN
    iteration (<= 8 per solve) against O(n_src) per-point gather/plane-fit
    work per shard — the communication-light end of the framework's SPMD
    patterns, so wall-clock scaling is measurable even on the gRPC harness.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops import pointcloud as pcops
    from ..ops import voxel as vox
    from ..ops.pointcloud import PointCloud
    from . import multihost as mh
    from .dist_registration import sharded_scan2map

    n_src = int(payload.get("n_src", 65536))
    n_map = int(payload.get("n_map", 16384))
    reps = int(payload.get("reps", 3))
    rng = np.random.default_rng(int(payload.get("seed", 0)))

    # plane world (ground + two walls), same construction as __graft_entry__
    g = rng.uniform(-8, 8, size=(n_map, 2)).astype(np.float32)
    ground = np.stack([g[:, 0], g[:, 1], np.zeros(n_map, np.float32)], 1)
    w1 = np.stack([g[:, 0], np.full(n_map, 8.0, np.float32),
                   g[:, 1] * 0.3 + 2], 1)
    w2 = np.stack([np.full(n_map, -8.0, np.float32), g[:, 0],
                   g[:, 1] * 0.3 + 2], 1)
    map_xyz = (np.concatenate([ground, w1, w2])
               + rng.normal(size=(3 * n_map, 3)).astype(np.float32) * 0.01)

    mesh = mh.global_mesh(("dp",))
    n_dev = len(jax.devices())
    n_src = ((n_src + n_dev - 1) // n_dev) * n_dev
    src_idx = rng.choice(len(map_xyz), size=n_src, replace=True)
    src_np = map_xyz[src_idx]

    # the voxel map replicates; build from numpy identically on every host
    pad = np.full((4 * n_map, 3), pcops.PAD_COORD, np.float32)
    pad[: len(map_xyz)] = map_xyz
    mask = np.zeros(4 * n_map, bool)
    mask[: len(map_xyz)] = True
    map_pc = PointCloud(
        mh.make_global_array(pad, mesh, P()),
        mh.make_global_array(np.zeros(4 * n_map, np.float32), mesh, P()),
        mh.make_global_array(mask, mesh, P()))
    # the FAST single-chip map: dense grid + corner gather (grid 2.0 >= 2 *
    # search radius, ops/voxel.py gather_neighbors_corner). The dense slab
    # replicates per device (16*16*8 rows x 48 f32 ~ 0.4 MB here).
    vm = vox.build_dense_voxel_map(map_pc, 2.0, jnp.zeros(3, jnp.float32),
                                   dims=(16, 16, 8), slab_size=16)

    src = PointCloud(
        mh.make_global_array(src_np, mesh, P("dp")),
        mh.make_global_array(np.zeros(n_src, np.float32), mesh, P("dp")),
        mh.make_global_array(np.ones(n_src, bool), mesh, P("dp")))
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.05, -0.05, 0.02]
    init_pose = mh.make_global_array(init, mesh, P())

    fn = sharded_scan2map(mesh)
    res = fn(src, vm, init_pose)
    res.pose.block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn(src, vm, init_pose)
        res.pose.block_until_ready()
        times.append(time.perf_counter() - t0)
    pose = np.asarray(res.pose.addressable_shards[0].data)
    return {
        "times_s": times,
        "n_devices": n_dev,
        "converged": bool(np.asarray(res.converged.addressable_shards[0].data)),
        "pose_err": float(np.abs(pose - np.eye(4)).max()),
    }


def devices_worker(payload: Dict[str, Any], num_processes: int,
                   process_id: int) -> Dict[str, Any]:
    """Smoke worker: report the global/local device split + one psum."""
    import jax
    import jax.numpy as jnp

    n_global = len(jax.devices())
    n_local = len(jax.local_devices())
    # one cross-host collective: sum of process ids over the mesh
    from jax.sharding import PartitionSpec as P

    from . import multihost as mh

    mesh = mh.global_mesh(("x",))
    local = np.full((n_global,), float(process_id), np.float32)
    arr = mh.make_global_array(local, mesh, P("x"))
    total = jax.jit(jnp.sum)(arr)
    return {
        "n_global": n_global,
        "n_local": n_local,
        "process_id": process_id,
        "psum": float(np.asarray(total.addressable_shards[0].data)),
    }
