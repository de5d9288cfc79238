"""Point-cloud registration backends behind one scan2Map-shaped API.

Reference: ``PCR/include/PCR/PointCloudRegister.hpp:12-38`` — an abstract
``scan2Map(src, dst, pose&) -> bool`` plus ``getFitnessScore()``, with
LOAM / NDT / VGICP implementations selected by config
(``frontend/src/LidarOdometry.cpp:44-54``).

Here each backend also owns its *map representation builder*: the frontend
hands the downsampled submap cloud to ``build_target`` and passes the result
back to ``scan2map`` — so LOAM gets a point-slab voxel map while NDT/VGICP
get Gaussian voxel maps, all built on device.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import geometry as geo
from ..ops import loam as loam_ops
from ..ops import ndt as ndt_ops
from ..ops import pointcloud as pcops
from ..ops import vgicp as vgicp_ops
from ..ops.pointcloud import PointCloud
from ..ops import voxel as vox
from ..utils.config import Params


# ---------------------------------------------------------------------------
# fused per-scan device steps — ONE jitted call per scan / per submap rebuild.
# Splitting these into eager op-by-op dispatch costs a dispatch per op,
# which would dominate the frame time.
# ---------------------------------------------------------------------------

def register_kind(ds: PointCloud, target: Any, init_pose: jax.Array,
                  kind: str, degen=0.0, reduce_fn=None,
                  rmax_reduce_fn=None, axis_reduce=None):
    """Trace-time dispatch to the configured backend:
    (pose, conv, fitness, iters, gathers).

    ``kind`` must be static under jit (it selects the program, exactly like
    the reference's config-driven PCR choice, LidarOdometry.cpp:44-54).
    ``gathers`` counts HBM neighborhood sweeps (== iters for backends without
    a gather cache) — the utilization accounting consumes it. ``degen`` > 0
    enables LOAM's degeneracy guard (frontend.degeneracy_guard config).
    Multi-device point sharding: ``reduce_fn``/``rmax_reduce_fn`` serve the
    LOAM path (fused psum of the normal equations + pmax of the range
    bound); ``axis_reduce`` (a flat-f32-vector psum) serves NDT and VGICP
    — the executor shards scan points over the ``dp`` axis and passes the
    mesh collectives here.
    """
    fit = jnp.float32(0.0)
    if kind == "loam":
        res = loam_ops.gn_loop(ds, target, init_pose, reduce_fn=reduce_fn,
                               degen_per_row=degen,
                               rmax_reduce_fn=rmax_reduce_fn)
        pose, conv, gathers = res.pose, res.converged, res.n_gathers
    elif kind == "ndt":
        res = ndt_ops.align(ds, target, init_pose, axis_reduce=axis_reduce)
        pose, conv, gathers = res.pose, res.converged, res.iters
    else:
        res = vgicp_ops.align(ds, target, init_pose,
                              axis_reduce=axis_reduce)
        pose, conv, fit = res.pose, res.converged, res.fitness
        gathers = res.iters
    support = getattr(res, "n_valid", jnp.int32(0))
    return pose, conv, fit, res.iters, gathers, support


@partial(jax.jit, static_argnames=("ds_capacity", "kind", "clamp", "degen"))
def _fused_odometry_step(raw: PointCloud, target: Any, init_pose: jax.Array,
                         grid: jax.Array, ds_capacity: int, kind: str,
                         clamp: bool = True, degen: float = 0.0):
    """downsample -> compact -> scan2map -> planar clamp, fused.

    Returns (clamped pose, converged, fitness, ds_scan). The planar clamp is
    the per-frame SixDof2Mobile of LidarOdometry.cpp:211, gated by the
    ``frontend.planar_clamp`` config (off for sloped/rough terrain).
    """
    ds = pcops.compact(vox.voxel_downsample(raw, grid), ds_capacity)
    pose, conv, fit, _, _, _ = register_kind(ds, target, init_pose, kind,
                                             degen)
    if clamp:
        pose = geo.six_dof_to_mobile(pose)
    return pose, conv, fit, ds


@partial(jax.jit, static_argnames=("builder",))
def _fused_window_target(kf_buf: jax.Array, idx: jax.Array, poses: jax.Array,
                         kf_mask: jax.Array, center: jax.Array,
                         grid: jax.Array, builder):
    """Submap target rebuild entirely on device from resident keyframes.

    The streamed executor keeps every keyframe's downsampled cloud on device
    (uploaded once, ~96 KB each); a rebuild then moves only a handful of
    indices/poses to the device instead of the merged ~1.5 MB submap (see
    pipeline/streamed.py). Semantics match MapManager::updateMap
    (MapManager.cpp:151-201): gather keyframes in the window, transform to
    map frame, concat, voxel-downsample at the map grid, build the
    register's target.

    kf_buf: (MAXKF, C, 3) resident clouds (PAD_COORD padded, sensor frame)
    idx/poses/kf_mask: (W,) int32, (W, 4, 4) f32, (W,) bool window selection
    builder: bound ``register.build_target`` (static; stable per register)
    """
    pts = kf_buf[idx]                                     # (W, C, 3)
    valid = (pts[..., 0] < 0.5 * pcops.PAD_COORD) & kf_mask[:, None]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    ptsw = jnp.einsum("wij,wcj->wci", R, pts) + t[:, None, :]
    xyz = jnp.where(valid[..., None], ptsw, pcops.PAD_COORD).reshape(-1, 3)
    mask = valid.reshape(-1)
    merged = PointCloud(xyz, jnp.zeros(xyz.shape[:1], jnp.float32), mask)
    ds = vox.voxel_downsample(merged, grid, center)
    return builder(ds, center)


@jax.jit
def _planar_clamp(pose: jax.Array) -> jax.Array:
    return geo.six_dof_to_mobile(pose)


@partial(jax.jit, static_argnames=("cap",))
def _fused_downsample(pc: PointCloud, grid: jax.Array, origin: jax.Array,
                      cap: int) -> PointCloud:
    return pcops.compact(vox.voxel_downsample(pc, grid, origin), cap)


# One fetch per scan2map: pose (16) + converged + fitness packed on device.
# Fetching them separately costs one blocking device-to-host sync EACH
# (three per LC verification, pure latency).
_pack_align = jax.jit(lambda pose, conv, fit: jnp.concatenate([
    pose.reshape(16), conv.astype(jnp.float32)[None],
    jnp.asarray(fit, jnp.float32)[None]]))


def _fetch_align(pose, conv, fit):
    packed = np.asarray(_pack_align(pose, conv, fit))
    return (packed[:16].reshape(4, 4).astype(np.float64),
            bool(packed[16] > 0.5), float(packed[17]))


class PointCloudRegister:
    """Abstract register (PointCloudRegister.hpp:12-38)."""

    def __init__(self) -> None:
        cfg = Params.get_instance()
        self.tpu_cfg = cfg["tpu"]
        self.planar_clamp = bool(cfg["frontend"].get("planar_clamp", True))
        self.degen_per_row = (
            loam_ops.DEGEN_EIGEN_PER_ROW
            if cfg["frontend"].get("degeneracy_guard", False) else 0.0)
        self._fitness: float = float("inf")
        self.is_converge: bool = False

    KIND = ""

    def build_target(self, submap: PointCloud, origin: jax.Array) -> Any:
        raise NotImplementedError

    def scan2map(self, src: PointCloud, target: Any, pose: np.ndarray) -> Tuple[np.ndarray, bool]:
        """Refine ``pose`` (4, 4 numpy) registering ``src`` to ``target``.

        Returns (refined pose, converged)."""
        raise NotImplementedError

    def odometry_step(self, raw: PointCloud, target: Any, pose: np.ndarray,
                      grid: float, ds_capacity: int):
        """Fused per-scan path: (clamped pose f64, converged, ds_scan)."""
        p, conv, fit, ds = _fused_odometry_step(
            raw, target, jnp.asarray(pose, jnp.float32),
            jnp.float32(grid), ds_capacity, self.KIND, self.planar_clamp,
            float(self.degen_per_row))
        pose_np, self.is_converge, fitness = _fetch_align(p, conv, fit)
        if self.KIND == "vgicp":
            self._fitness = fitness
        return pose_np, self.is_converge, ds

    def build_target_from_window(self, kf_buf: jax.Array, idx: np.ndarray,
                                 poses: np.ndarray, kf_mask: np.ndarray,
                                 center: np.ndarray, grid: float):
        """Device-side submap rebuild from resident keyframe clouds.

        One jitted call (compiled once per register); only indices/poses
        cross the host link. See ``_fused_window_target``.
        """
        return _fused_window_target(
            kf_buf, jnp.asarray(idx, jnp.int32),
            jnp.asarray(poses, jnp.float32), jnp.asarray(kf_mask),
            jnp.asarray(center, jnp.float32), jnp.float32(grid),
            self.build_target)

    def build_target_from_raw(self, pc: PointCloud, grid: float,
                              origin: jax.Array, cap: int):
        """Fused submap rebuild: downsample+compact+target build, one call.

        Returns (ds_submap, target)."""
        ds = _fused_downsample(pc, jnp.float32(grid), origin, cap)
        return ds, self.build_target(ds, origin)

    def get_fitness_score(self) -> float:
        return self._fitness


class LoamRegister(PointCloudRegister):
    """LOAM point-to-plane GN on SE(3) (PCR/src/LoamRegister.cpp:99-223)."""

    KIND = "loam"

    # neighbor-search voxel size: 2 * the 1.0 m kNN gate radius, so the
    # corner-selected 2x2x2 gather (ops/voxel.py gather_neighbors_corner)
    # covers the search ball with 8 rows per query instead of 27 (fewer
    # random device-memory reads per query)
    TARGET_GRID = 2.0

    def build_target(self, submap: PointCloud, origin: jax.Array) -> vox.MergedDenseVoxelMap:
        # dense window around the submap anchor: lookup is index arithmetic,
        # not a key search (a binary search is log2(V) dependent gathers;
        # see ops/voxel.py). Window extent matches the config's 1 m-grid
        # dims, so halve the voxel counts at grid 2.0. The 2x2x2
        # neighborhoods are pre-MERGED at build time so each registration
        # query reads ONE row (voxel.MergedDenseVoxelMap rationale).
        dims = tuple(max(int(d) // 2, 1)
                     for d in self.tpu_cfg["dense_grid_dims"])
        return vox.build_merged_dense_voxel_map(
            submap,
            self.TARGET_GRID,
            origin,
            dims=dims,
            slab_size=int(self.tpu_cfg.get("loam_slab_size", 24)),
        )

    def scan2map(self, src: PointCloud, target, pose: np.ndarray):
        res = loam_ops.scan2map(src, target, jnp.asarray(pose, jnp.float32))
        p, self.is_converge, _ = _fetch_align(res.pose, res.converged,
                                              jnp.float32(0.0))
        return p, self.is_converge


class NdtRegister(PointCloudRegister):
    """OpenMP-NDT equivalent: Gaussian-voxel Newton with DIRECT7 lookups
    (adapter parity: PCR/src/NdtRegister.cpp:6-35, resolution 1.0)."""

    KIND = "ndt"

    RESOLUTION = 1.0

    def build_target(self, submap: PointCloud, origin: jax.Array) -> ndt_ops.NdtTarget:
        return ndt_ops.build_target(
            submap,
            self.RESOLUTION,
            origin,
            dims=tuple(int(d) for d in self.tpu_cfg["dense_grid_dims"]),
        )

    def scan2map(self, src: PointCloud, target: ndt_ops.NdtTarget, pose: np.ndarray):
        res = ndt_ops.align(src, target, jnp.asarray(pose, jnp.float32))
        p, self.is_converge, _ = _fetch_align(res.pose, res.converged,
                                              jnp.float32(0.0))
        return p, self.is_converge


class VgicpRegister(PointCloudRegister):
    """FastVGICP equivalent: voxelized distribution-to-distribution GICP
    (adapter parity: PCR/src/VgicpRegister.cpp:6-48, resolution 1.0)."""

    KIND = "vgicp"

    RESOLUTION = 1.0

    def __init__(self) -> None:
        super().__init__()
        self._lc_mode = False

    def init_for_lc(self) -> None:
        """Loosen for loop-closure verification (VgicpRegister.cpp:26-33)."""
        self._lc_mode = True

    def build_target(self, submap: PointCloud, origin: jax.Array) -> vgicp_ops.VgicpTarget:
        return vgicp_ops.build_target(
            submap,
            self.RESOLUTION,
            origin,
            dims=tuple(int(d) for d in self.tpu_cfg["dense_grid_dims"]),
        )

    def scan2map(self, src: PointCloud, target: vgicp_ops.VgicpTarget, pose: np.ndarray):
        res = vgicp_ops.align(
            src, target, jnp.asarray(pose, jnp.float32), lc_mode=self._lc_mode
        )
        p, self.is_converge, self._fitness = _fetch_align(
            res.pose, res.converged, res.fitness)
        return p, self.is_converge


def make_register(pcr_type: Optional[str] = None) -> PointCloudRegister:
    """Config-driven factory (LidarOdometry.cpp:44-54 semantics incl. the
    unknown-type error)."""
    if pcr_type is None:
        pcr_type = Params.get_instance()["frontend"]["pcr"]
    if pcr_type == "loam":
        return LoamRegister()
    if pcr_type == "ndt":
        return NdtRegister()
    if pcr_type == "vgicp":
        return VgicpRegister()
    raise ValueError(
        f"such pcr type({pcr_type}) is not exist, please implemented your self!"
    )
