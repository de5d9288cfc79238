"""simpleslam_tpu — a LiDAR SLAM framework written in JAX.

A from-scratch JAX/XLA re-architecture of the capabilities of the reference
C++ system (Rick0514/SimpleSLAM): EKF wheel+IMU fusion, LOAM / NDT / VGICP
scan-to-map registration, keyframe map management, ScanContext loop closure,
and an SE(3) pose-graph backend — built for an accelerator:

- point clouds are fixed-capacity padded arrays (static shapes for XLA),
- neighbor search uses dense voxel-slab maps with batched fixed-radius
  gathers instead of kd-trees,
- per-point loops become vmapped residual/Jacobian evaluation with masked
  einsum normal-equation reductions,
- the pose graph is solved by our own batched Gauss-Newton/LM solver
  (a dense factorization for small graphs; PCG and sharded multi-device
  paths for scale),
- multi-device scaling rides ``jax.sharding.Mesh`` + ``shard_map`` with
  XLA collectives.

Layer map (mirrors reference layers, see SURVEY.md §1):
  utils/     -> common/ + config/ (types, concurrency, logging, IO, config)
  ops/       -> PCR/ + filter/ + vendored registration libs as device kernels
  models/    -> frontend/ + backend/ + dataproxy state machines
  parallel/  -> (new) multi-device sharding; no reference counterpart
  pipeline/  -> app/ (offline replay harness, simulation, evaluation)
"""

__version__ = "0.1.0"

import os as _os

import jax as _jax

# Registration/solver math is geometric f32: plane normals from ~5-point
# scatters, SE(3) Jacobian products, 6x6 normal equations, pose-graph
# factorizations. Reduced-precision matmul inputs (bf16, or TF32's ~3
# decimal digits on a GPU's tensor cores) are coarser than the GN
# convergence thresholds (5e-3 over meter-scale coordinates), so every f32
# matmul runs at full FP32.
_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the pipeline jit-compiles a handful of large
# programs (registration while_loop, pose-graph LM, streamed executor chain)
# that take seconds to tens of seconds each to compile; caching them on disk
# lets every later process start in seconds. JAX_COMPILATION_CACHE_DIR wins
# when set; otherwise the cache lives at a fixed path inside the checkout
# (the path is part of the cache key, so it must not move between runs).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
