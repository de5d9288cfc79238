"""Worker: measure cross-host psum latency/bandwidth on the harness.

Used by benchmarks/bench_scaling.py to decompose solve time into per-shard
compute vs collective cost (a gRPC collective between CPU processes is far
slower than one over a device interconnect, so measured wall-clock
efficiency on the CPU harness must be corrected by this probe to say
anything about accelerator hosts).
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np


def psum_probe(payload: Dict[str, Any], num_processes: int,
               process_id: int) -> Dict[str, Any]:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from . import multihost as mh

    rows = int(payload.get("rows", 2048))
    iters = int(payload.get("iters", 50))
    mesh = mh.global_mesh(("x",))
    n_dev = len(jax.devices())

    def body(x):
        # chain of dependent psums: timing / iters = per-collective latency
        def step(c, _):
            return jax.lax.psum(c * (1.0 / n_dev), "x"), ()
        out, _ = jax.lax.scan(step, x, None, length=iters)
        return out

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("x"),
                               out_specs=P("x"), check_vma=False))
    local = np.ones((rows * n_dev, 6), np.float32)
    x = mh.make_global_array(local, mesh, P("x"))
    fn(x).block_until_ready()
    t0 = time.perf_counter()
    fn(x).block_until_ready()
    dt = time.perf_counter() - t0
    return {"per_psum_s": dt / iters, "rows": rows, "iters": iters,
            "n_devices": n_dev}
