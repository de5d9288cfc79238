"""Voxel-grid machinery: downsampling and the voxel-slab neighbor map.

This is the keystone that replaces every pointer-chasing spatial index in the
reference with one static-shape design (SURVEY.md §7): points are bucketed
into a sorted voxel table built with one sort + segment reductions, and all
neighbor queries become batched gathers over a static 3x3x3 (or 7-cell)
voxel neighborhood.

Covers the roles of:
- ``pcp::voxelDownSample`` / ``VoxelDownSampleV2`` (common/pcp/pcp.hpp:14-263)
  — centroid-per-voxel downsampling with a max-points-per-voxel cap,
- nanoflann kd-trees (``third_parties/nanoflann``; adaptors
  ``pcl_adaptor.hpp``/``kfs_adaptor.hpp``) — kNN / fixed-radius gather,
- ``pclomp::VoxelGridCovariance`` + ``GaussianVoxelMap`` (ndt_omp /
  fast_vgicp_voxel.hpp) — per-voxel Gaussian moments for NDT/VGICP.

Coordinate convention: voxel coords are ``floor((p - origin) / grid)``
packed 10 bits/axis (+-512 voxels around ``origin``); out-of-range or
padding points get an INVALID key that sorts to the tail. All shapes are
static; everything is jit/vmap-safe.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pointcloud import PAD_COORD, PointCloud

_BITS = 10
_HALF = 1 << (_BITS - 1)  # 512
_RANGE = 1 << _BITS  # 1024
# Sorts after any packed key (max 2^30 - 1). MUST stay a host scalar
# (np.int32, not jnp.int32): a module-level jnp constant is a device-resident
# buffer captured by every program that closes over it.
INVALID_KEY = np.int32(1 << 30)


def voxel_coords(xyz: jax.Array, origin: jax.Array, grid: jax.Array) -> jax.Array:
    """(..., 3) points -> (..., 3) int32 voxel coords, offset to [0, 1024)."""
    return jnp.floor((xyz - origin) / grid).astype(jnp.int32) + _HALF


def pack_coords(c: jax.Array, valid: jax.Array) -> jax.Array:
    """(..., 3) int32 coords + validity -> packed int32 key (INVALID if out of range)."""
    in_range = jnp.all((c >= 0) & (c < _RANGE), axis=-1)
    key = (c[..., 0] << (2 * _BITS)) | (c[..., 1] << _BITS) | c[..., 2]
    return jnp.where(valid & in_range, key, INVALID_KEY)


def voxel_keys(xyz: jax.Array, mask: jax.Array, origin: jax.Array, grid) -> jax.Array:
    grid = jnp.asarray(grid, xyz.dtype)
    return pack_coords(voxel_coords(xyz, origin, grid), mask)


def _sorted_segments(keys: jax.Array, xyz: jax.Array, intensity: jax.Array):
    """Sort points by voxel key and derive segment structure.

    Returns (keys_s, xyz_s, inten_s, seg_id, rank, num_segments) where
    ``seg_id`` is the dense index of each point's voxel in key order (== N
    for invalid points, so downstream scatters drop them) and ``rank`` is the
    point's position within its voxel.
    """
    n = keys.shape[0]
    order = jnp.argsort(keys)
    keys_s = keys[order]
    xyz_s = xyz[order]
    inten_s = intensity[order]
    prev = jnp.concatenate([jnp.full((1,), -1, keys_s.dtype), keys_s[:-1]])
    is_new = keys_s != prev
    seg_id = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    start = jax.lax.cummax(jnp.where(is_new, jnp.arange(n, dtype=jnp.int32), 0))
    rank = jnp.arange(n, dtype=jnp.int32) - start
    invalid = keys_s == INVALID_KEY
    seg_id = jnp.where(invalid, n, seg_id)
    num_segments = jnp.max(jnp.where(invalid, 0, seg_id + 1))
    return keys_s, xyz_s, inten_s, seg_id, rank, num_segments


@partial(jax.jit, static_argnames=("max_pts_per_voxel", "min_pts_per_voxel"))
def voxel_downsample(pc: PointCloud, grid, origin: Optional[jax.Array] = None,
                     max_pts_per_voxel: int = 20,
                     min_pts_per_voxel: int = 0) -> PointCloud:
    """Centroid-per-voxel downsample (VoxelDownSampleV2 semantics).

    Parity with ``pcp.hpp:78-154``: each voxel contributes the centroid of at
    most ``max_pts_per_voxel`` of its points (insertion order = input order;
    we match by taking the first ``max`` in sorted-stable order), the output
    point inherits the intensity of the voxel's first point, and voxels with
    ``<= min_pts_per_voxel`` points are dropped. Output occupies the same
    capacity, compacted to the front.
    """
    if origin is None:
        origin = jnp.zeros((3,), pc.xyz.dtype)
    grid = jnp.asarray(grid, pc.xyz.dtype)
    n = pc.capacity
    keys = voxel_keys(pc.xyz, pc.mask, origin, grid)
    keys_s, xyz_s, inten_s, seg_id, rank, num_segments = _sorted_segments(
        keys, pc.xyz, pc.intensity
    )
    contrib = rank < max_pts_per_voxel
    seg_for_sum = jnp.where(contrib, seg_id, n)
    sums = jax.ops.segment_sum(
        jnp.where(contrib[:, None], xyz_s, 0.0), seg_for_sum, num_segments=n
    )
    counts = jax.ops.segment_sum(
        contrib.astype(jnp.int32), seg_for_sum, num_segments=n
    )
    full_counts = jax.ops.segment_sum(
        jnp.ones_like(seg_id), jnp.where(seg_id < n, seg_id, n),
        num_segments=n, indices_are_sorted=True
    )
    centroids = sums / jnp.maximum(counts, 1)[:, None].astype(sums.dtype)
    # first point's intensity per voxel
    first_inten = jnp.zeros((n,), inten_s.dtype).at[
        jnp.where((rank == 0) & (seg_id < n), seg_id, n)
    ].add(inten_s, mode="drop")
    seg_ids_out = jnp.arange(n, dtype=jnp.int32)
    out_mask = (seg_ids_out < num_segments) & (full_counts > min_pts_per_voxel)
    out_xyz = jnp.where(out_mask[:, None], centroids, PAD_COORD)
    return PointCloud(out_xyz, first_inten, out_mask)


# ---------------------------------------------------------------------------
# Point-slab voxel map (nearest-neighbor engine)
# ---------------------------------------------------------------------------

class VoxelMap(NamedTuple):
    """Sorted voxel table with per-voxel point slabs.

    keys:   (V,) int32  ascending valid prefix, INVALID tail
    slab:   (V, M, 3) f32 points (PAD_COORD padding)
    counts: (V,) int32  valid points per voxel (<= M)
    origin: (3,) f32
    grid:   () f32
    """

    keys: jax.Array
    slab: jax.Array
    counts: jax.Array
    origin: jax.Array
    grid: jax.Array

    @property
    def num_voxels(self) -> int:
        return self.keys.shape[0]

    @property
    def slab_size(self) -> int:
        return self.slab.shape[1]


@partial(jax.jit, static_argnames=("num_voxels", "slab_size"))
def build_voxel_map(pc: PointCloud, grid, origin: jax.Array,
                    num_voxels: int, slab_size: int) -> VoxelMap:
    """Build the sorted voxel-slab table from a padded cloud.

    One sort + segment scatter; voxels beyond ``num_voxels`` or points beyond
    ``slab_size`` per voxel are dropped (log if that matters at call sites).
    """
    grid = jnp.asarray(grid, pc.xyz.dtype)
    keys = voxel_keys(pc.xyz, pc.mask, origin, grid)
    keys_s, xyz_s, _, seg_id, rank, _ = _sorted_segments(keys, pc.xyz, pc.intensity)

    valid = (seg_id < num_voxels) & (rank < slab_size)
    flat_idx = jnp.where(valid, seg_id * slab_size + rank, num_voxels * slab_size)
    slab = jnp.full((num_voxels * slab_size, 3), PAD_COORD, jnp.float32).at[
        flat_idx
    ].set(xyz_s, mode="drop").reshape(num_voxels, slab_size, 3)

    table_keys = jnp.full((num_voxels,), INVALID_KEY, jnp.int32).at[
        jnp.where(seg_id < num_voxels, seg_id, num_voxels)
    ].set(keys_s, mode="drop")
    counts = jax.ops.segment_sum(
        valid.astype(jnp.int32),
        jnp.where(valid, seg_id, num_voxels),
        num_segments=num_voxels,
    )
    return VoxelMap(table_keys, slab, counts, origin, grid)


def _neighbor_offsets(radius: int) -> np.ndarray:
    r = range(-radius, radius + 1)
    return np.array([(x, y, z) for x in r for y in r for z in r], dtype=np.int32)


DIRECT7_OFFSETS = np.array(
    [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
    dtype=np.int32,
)


def lookup_voxels(keys_table: jax.Array, nkeys: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Find packed keys in the sorted table: -> (index, found_mask)."""
    idx = jnp.searchsorted(keys_table, nkeys)
    idx = jnp.clip(idx, 0, keys_table.shape[0] - 1)
    found = (keys_table[idx] == nkeys) & (nkeys != INVALID_KEY)
    return idx, found


@partial(jax.jit, static_argnames=("radius",))
def gather_neighbors(vm: VoxelMap, queries: jax.Array, q_mask: jax.Array,
                     radius: int = 1) -> Tuple[jax.Array, jax.Array]:
    """Batched fixed-radius candidate gather.

    queries (Q, 3) -> candidates (Q, K*M, 3) and validity (Q, K*M) where K is
    the (2*radius+1)^3 neighborhood. This one gather serves LOAM kNN, NDT
    voxel lookups, VGICP correspondences, and fitness scoring.
    """
    offs = jnp.asarray(_neighbor_offsets(radius))  # (K, 3)
    c = voxel_coords(queries, vm.origin, vm.grid)  # (Q, 3)
    nc = c[:, None, :] + offs[None, :, :]  # (Q, K, 3)
    nkeys = pack_coords(nc, q_mask[:, None])
    idx, found = lookup_voxels(vm.keys, nkeys)  # (Q, K)
    pts = vm.slab[idx]  # (Q, K, M, 3)
    m = vm.slab_size
    lane = jnp.arange(m, dtype=jnp.int32)
    valid = found[:, :, None] & (lane[None, None, :] < vm.counts[idx][:, :, None])
    q_, k_ = pts.shape[0], pts.shape[1]
    return pts.reshape(q_, k_ * m, 3), valid.reshape(q_, k_ * m)


@partial(jax.jit, static_argnames=("k", "radius"))
def knn(vm: VoxelMap, queries: jax.Array, q_mask: jax.Array, k: int,
        radius: int = 1) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """k nearest neighbors from the voxel neighborhood.

    Returns (sq_dists (Q, k), neighbors (Q, k, 3), valid (Q, k)). Neighbors
    beyond the voxel neighborhood are not seen — callers choose ``radius`` *
    ``grid`` >= their search radius (LoamRegister uses sq-dist gate 1.0,
    LoamRegister.hpp:31, so radius=1 with grid >= 1.0 suffices).
    """
    cand, valid = gather_neighbors(vm, queries, q_mask, radius)
    d2 = jnp.sum((cand - queries[:, None, :]) ** 2, axis=-1)
    d2 = jnp.where(valid, d2, jnp.inf)
    neg_top, top_idx = jax.lax.top_k(-d2, k)
    sq = -neg_top
    nbrs = jnp.take_along_axis(cand, top_idx[:, :, None], axis=1)
    return sq, nbrs, jnp.isfinite(sq)


# ---------------------------------------------------------------------------
# Dense local voxel grid (the fast registration target)
# ---------------------------------------------------------------------------
#
# The sorted-table lookup path is bound by ``searchsorted`` (binary search =
# log2(V) sequential dependent gathers per query) while the slab gather
# itself is one read per voxel. Registration targets are spatially windowed
# submaps (8 m keyframe radius, MapManager.cpp:176-192), so the answer is a
# DENSE grid
# over a fixed window around the submap origin: voxel lookup becomes pure
# index arithmetic + one row gather. Row G of the slab is a permanent padding
# row; every out-of-window or empty lookup lands there with found=False.


class DenseVoxelMap(NamedTuple):
    """Dense voxel grid with per-voxel point slabs in flat rows.

    slab:   (Gx*Gy*Gz + 1, M*3) f32 — row v holds voxel v's points as
            [x0 y0 z0 x1 y1 z1 ...] with PAD_COORD filling unused slots
            (validity is recoverable from the coordinates alone — no
            separate counts gather); last row is the padding sentinel
    counts: (Gx*Gy*Gz + 1,) int32 (bookkeeping; the gather path derives
            validity from PAD_COORD instead of touching this table)
    corner: (3,) f32 window minimum corner (world frame)
    grid:   () f32
    dims / slab_pts: static metadata (ride in the treedef)
    """

    slab: jax.Array
    counts: jax.Array
    corner: jax.Array
    grid: jax.Array
    dims: Tuple[int, int, int]
    slab_pts: int

    @property
    def slab_size(self) -> int:
        return self.slab_pts


jax.tree_util.register_pytree_node(
    DenseVoxelMap,
    lambda m: ((m.slab, m.counts, m.corner, m.grid), (m.dims, m.slab_pts)),
    lambda aux, leaves: DenseVoxelMap(*leaves, aux[0], aux[1]),
)


def _dense_flat(c: jax.Array, dims: Tuple[int, int, int], valid: jax.Array) -> jax.Array:
    """(..., 3) int voxel coords -> flat index, sentinel G for invalid."""
    gx, gy, gz = dims
    in_range = (
        (c[..., 0] >= 0) & (c[..., 0] < gx)
        & (c[..., 1] >= 0) & (c[..., 1] < gy)
        & (c[..., 2] >= 0) & (c[..., 2] < gz)
    )
    flat = (c[..., 0] * gy + c[..., 1]) * gz + c[..., 2]
    return jnp.where(valid & in_range, flat, gx * gy * gz)


@partial(jax.jit, static_argnames=("dims", "slab_size"))
def build_dense_voxel_map(pc: PointCloud, grid, center: jax.Array,
                          dims: Tuple[int, int, int],
                          slab_size: int) -> DenseVoxelMap:
    """Sort a padded cloud into a dense grid window centered at ``center``.

    Points outside the window are dropped (callers size the window to cover
    the submap: LOAM validity needs neighbors within 1 m anyway, so clipped
    far points would never produce valid rows).

    GATHER-based construction: points are sorted by voxel id, each voxel's
    run start is found with a sorted ``segment_min``, and every slab row
    gathers its points from the sorted array. The obvious alternative — one
    scatter of every (row, slot) element — is a per-index scatter with
    colliding writes, while this formulation is one argsort + two sorted
    segment reductions + one big vectorized gather.
    """
    grid = jnp.asarray(grid, pc.xyz.dtype)
    gx, gy, gz = dims
    g_total = gx * gy * gz
    corner = center - jnp.asarray([gx, gy, gz], pc.xyz.dtype) * grid / 2.0
    c = jnp.floor((pc.xyz - corner) / grid).astype(jnp.int32)
    flat = _dense_flat(c, dims, pc.mask)

    order = jnp.argsort(flat)
    flat_s = flat[order]
    xyz_s = pc.xyz[order]
    n = flat_s.shape[0]
    start = jax.ops.segment_min(
        jnp.arange(n, dtype=jnp.int32), flat_s, num_segments=g_total + 1,
        indices_are_sorted=True)
    counts = jax.ops.segment_sum(
        jnp.ones((n,), jnp.int32), flat_s, num_segments=g_total + 1,
        indices_are_sorted=True)
    m = slab_size
    lanes = jnp.arange(m, dtype=jnp.int32)
    # empty voxels have start == int32 max (segment_min identity): clamp the
    # start BEFORE adding lane offsets (the sum would overflow int32) and
    # mask by count
    src = jnp.minimum(jnp.minimum(start, n - 1)[:, None] + lanes[None, :],
                      n - 1)
    valid = lanes[None, :] < jnp.minimum(counts, m)[:, None]
    pts = jnp.where(valid[..., None], xyz_s[src], PAD_COORD)  # (G+1, M, 3)
    # rows are exactly M*3 values: padding rows to a wider multiple only
    # multiplies the bytes every gather moves (measured slower on the GPU)
    slab = pts.reshape(g_total + 1, m * 3)
    slab = slab.at[g_total].set(PAD_COORD)  # sentinel row: pure padding
    counts = jnp.minimum(counts, m).at[g_total].set(0)
    return DenseVoxelMap(slab, counts, corner, grid, dims, slab_size)


def _rows_to_points(rows: jax.Array, slab_pts: int):
    """(..., W) flat rows -> ((..., M, 3) points, (..., M) validity).

    Validity is derived from the PAD_COORD sentinel — no counts gather.
    """
    pts = rows[..., : slab_pts * 3].reshape(*rows.shape[:-1], slab_pts, 3)
    valid = pts[..., 0] < 0.5 * PAD_COORD
    return pts, valid


@partial(jax.jit, static_argnames=("radius",))
def gather_neighbors_dense(dm: DenseVoxelMap, queries: jax.Array,
                           q_mask: jax.Array, radius: int = 1
                           ) -> Tuple[jax.Array, jax.Array]:
    """Fixed-radius candidate gather from the dense grid (no key search).

    queries (Q, 3) -> (candidates (Q, K*M, 3), validity (Q, K*M)).
    """
    offs = jnp.asarray(_neighbor_offsets(radius))  # (K, 3)
    c = jnp.floor((queries - dm.corner) / dm.grid).astype(jnp.int32)
    nc = c[:, None, :] + offs[None, :, :]  # (Q, K, 3)
    flat = _dense_flat(nc, dm.dims, q_mask[:, None])  # (Q, K)
    pts, valid = _rows_to_points(dm.slab[flat], dm.slab_pts)
    q_, k_, m = pts.shape[0], pts.shape[1], dm.slab_pts
    return pts.reshape(q_, k_ * m, 3), valid.reshape(q_, k_ * m)


@jax.jit
def gather_neighbors_corner(dm: DenseVoxelMap, queries: jax.Array,
                            q_mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Corner-selected 2x2x2 neighborhood gather — 8 rows/query, not 27.

    For a search radius r and grid g >= 2r, the 2-voxel-per-axis block whose
    minimum corner is ``floor((q - r') / g)`` with r' = g/2 covers the full
    [q - g/2, q + g/2] cube: g*base <= q - g/2 guarantees the lower face and
    g*base + 2g > q + g/2 the upper. Callers must build the map with
    ``grid >= 2 * search_radius`` (LOAM: grid 2.0 for the 1 m kNN gate).

    Why: 8 random row reads per query instead of 27, at identical
    recall.
    """
    offs = jnp.asarray(
        np.array([(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 dtype=np.int32))
    base = jnp.floor((queries - dm.corner) / dm.grid - 0.5).astype(jnp.int32)
    nc = base[:, None, :] + offs[None, :, :]  # (Q, 8, 3)
    flat = _dense_flat(nc, dm.dims, q_mask[:, None])
    pts, valid = _rows_to_points(dm.slab[flat], dm.slab_pts)  # (Q, 8, M, *)
    q_, k_, m = pts.shape[0], pts.shape[1], dm.slab_pts
    return pts.reshape(q_, k_ * m, 3), valid.reshape(q_, k_ * m)


# ---------------------------------------------------------------------------
# Merged-neighborhood dense map (ONE row per query)
# ---------------------------------------------------------------------------
#
# The corner-selected 2x2x2 gather still issues 8 random row reads per
# query. The registration target pre-merges each voxel's 2x2x2 block into a
# single row at map-build time: row v holds the points of voxels v + {0,1}^3
# concatenated, so a query reads one contiguous row (and spatially sorted
# queries read neighboring rows). The merge is built from 8 contiguous
# shifted slices of the dense slab — pure bandwidth, no random access,
# amortized over a whole submap window's lifetime. Whether the merge still
# pays on the GPU is an open measurement (ROADMAP S3).


# int16 quantization of merged rows, corner-relative: positions are stored
# as round((p - corner) / scale) - 2^14 with scale = extent / 32767 —
# ~5.9 mm resolution over a 192 m window, rms error ~1.7 mm (below sensor
# noise; the 5-point plane fits the rows feed are centimeters-tolerant).
# Why: halves the map footprint (340 -> 170 MB at (96,96,16)x24) AND the
# gather bytes. 32767 is the padding sentinel.
MERGED_PAD_Q = 32767
_MERGED_Q_OFF = 1 << 14


class MergedDenseVoxelMap(NamedTuple):
    """Dense grid whose row b holds the 2x2x2 block at base = b - 1, pre-merged.

    rows:  ((Gx+1)*(Gy+1)*(Gz+1) + 1, 8*M*3) int16 corner-relative quantized
           coords (MERGED_PAD_Q padding; last row is the all-padding
           sentinel). The merged index space is one voxel LARGER per axis
           than the underlying grid: corner-selected bases range over
           [-1, G-1] (a query in the low half-voxel shell has base = -1 but
           still owns 4 in-bounds voxels of its 2x2x2 block), so row b
           serves base = b - 1.
    scale: () f32 meters per quantization count
    corner/grid/dims/slab_pts: as DenseVoxelMap (slab_pts = per-VOXEL M;
           dims are the UNDERLYING grid dims, not the merged index dims)
    """

    rows: jax.Array
    scale: jax.Array
    corner: jax.Array
    grid: jax.Array
    dims: Tuple[int, int, int]
    slab_pts: int

    @property
    def slab_size(self) -> int:
        return self.slab_pts


jax.tree_util.register_pytree_node(
    MergedDenseVoxelMap,
    lambda m: ((m.rows, m.scale, m.corner, m.grid), (m.dims, m.slab_pts)),
    lambda aux, leaves: MergedDenseVoxelMap(*leaves, aux[0], aux[1]),
)


@partial(jax.jit, static_argnames=("dims", "slab_size"))
def build_merged_dense_voxel_map(pc: PointCloud, grid, center: jax.Array,
                                 dims: Tuple[int, int, int],
                                 slab_size: int) -> MergedDenseVoxelMap:
    """Dense slab build + 2x2x2 neighborhood merge (one fused program)."""
    dm = build_dense_voxel_map(pc, grid, center, dims, slab_size)
    gx, gy, gz = dims
    m = slab_size
    scale = jnp.asarray(max(dims), jnp.float32) * dm.grid / 32767.0
    flat = dm.slab[:-1, : m * 3].reshape(-1, 3)
    valid = flat[:, 0] < 0.5 * PAD_COORD
    q = jnp.clip(jnp.round((flat - dm.corner) / scale), 0, 32766
                 ).astype(jnp.int16) - jnp.int16(_MERGED_Q_OFF)
    q = jnp.where(valid[:, None], q, jnp.int16(MERGED_PAD_Q))
    pts = q.reshape(gx, gy, gz, m * 3)
    # pad one voxel on BOTH sides: low-side padding makes row 0 serve
    # base = -1 (the low half-voxel shell keeps its 4 in-bounds voxels —
    # without it those queries gathered the all-padding sentinel and
    # registration silently lost support in a g/2 band at the low window
    # edges), high-side padding closes the block at base = G-1
    padded = jnp.pad(pts, ((1, 1), (1, 1), (1, 1), (0, 0)),
                     constant_values=MERGED_PAD_Q)
    parts = [padded[dx:dx + gx + 1, dy:dy + gy + 1, dz:dz + gz + 1]
             for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    rows = jnp.concatenate(parts, axis=-1).reshape(
        (gx + 1) * (gy + 1) * (gz + 1), 8 * m * 3)
    rows = jnp.concatenate(
        [rows, jnp.full((1, 8 * m * 3), MERGED_PAD_Q, jnp.int16)])
    return MergedDenseVoxelMap(rows, scale, dm.corner, dm.grid, dims,
                               slab_size)


@jax.jit
def gather_neighbors_merged(mm: MergedDenseVoxelMap, queries: jax.Array,
                            q_mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Corner-selected 2x2x2 gather, ONE row per query.

    Identical candidate set and coverage guarantee as
    ``gather_neighbors_corner`` (map grid >= 2 * search radius); only the
    number of row reads differs (Q rows instead of 8Q), and candidates
    come back dequantized to f32 meters (see MERGED_PAD_Q rationale).
    Rows are indexed at base + 1 in the (G+1)-per-axis merged index space
    so base = -1 (low half-voxel shell) resolves to a real row.
    """
    base = jnp.floor((queries - mm.corner) / mm.grid - 0.5).astype(jnp.int32)
    gx, gy, gz = mm.dims
    flat = _dense_flat(base + 1, (gx + 1, gy + 1, gz + 1), q_mask)  # (Q,)
    q = mm.rows[flat]                          # (Q, 8*M*3) int16
    m8 = 8 * mm.slab_pts
    qp = q.reshape(*q.shape[:-1], m8, 3)
    valid = qp[..., 0] != MERGED_PAD_Q
    pts = (qp.astype(jnp.float32) + float(_MERGED_Q_OFF)) * mm.scale \
        + mm.corner
    pts = jnp.where(valid[..., None], pts, PAD_COORD)
    return pts, valid


@partial(jax.jit, static_argnames=("k", "radius"))
def knn_dense(dm: DenseVoxelMap, queries: jax.Array, q_mask: jax.Array,
              k: int, radius: int = 1) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """k nearest neighbors from the dense grid neighborhood (see ``knn``)."""
    cand, valid = gather_neighbors_dense(dm, queries, q_mask, radius)
    d2 = jnp.sum((cand - queries[:, None, :]) ** 2, axis=-1)
    d2 = jnp.where(valid, d2, jnp.inf)
    neg_top, top_idx = jax.lax.top_k(-d2, k)
    sq = -neg_top
    nbrs = jnp.take_along_axis(cand, top_idx[:, :, None], axis=1)
    return sq, nbrs, jnp.isfinite(sq)


# ---------------------------------------------------------------------------
# Dense Gaussian voxel map (fast NDT / VGICP target)
# ---------------------------------------------------------------------------


class DenseGaussianVoxelMap(NamedTuple):
    """Dense grid of Gaussian moments; row G is the zeroed padding sentinel."""

    means: jax.Array   # (G+1, 3)
    covs: jax.Array    # (G+1, 3, 3)
    counts: jax.Array  # (G+1,)
    corner: jax.Array  # (3,)
    grid: jax.Array    # ()
    dims: Tuple[int, int, int]


jax.tree_util.register_pytree_node(
    DenseGaussianVoxelMap,
    lambda m: ((m.means, m.covs, m.counts, m.corner, m.grid), m.dims),
    lambda dims, leaves: DenseGaussianVoxelMap(*leaves, dims),
)


@partial(jax.jit, static_argnames=("dims",))
def build_dense_gaussian_voxel_map(pc: PointCloud, grid, center: jax.Array,
                                   dims: Tuple[int, int, int]
                                   ) -> DenseGaussianVoxelMap:
    """Per-voxel Gaussian moments accumulated into a dense window.

    Points are sorted by voxel id first so every segment reduction runs the
    sorted fast path — unsorted segment_sum lowers to per-index
    scatter-adds (atomics on a GPU, contended where many points share a
    voxel).
    """
    grid = jnp.asarray(grid, pc.xyz.dtype)
    gx, gy, gz = dims
    g_total = gx * gy * gz
    corner = center - jnp.asarray([gx, gy, gz], pc.xyz.dtype) * grid / 2.0
    c = jnp.floor((pc.xyz - corner) / grid).astype(jnp.int32)
    flat = _dense_flat(c, dims, pc.mask)

    order = jnp.argsort(flat)
    flat_s = flat[order]
    mask_s = pc.mask[order]
    xyz = jnp.where(mask_s[:, None], pc.xyz[order], 0.0)
    counts = jax.ops.segment_sum(
        mask_s.astype(jnp.int32), flat_s, num_segments=g_total + 1,
        indices_are_sorted=True)
    sums = jax.ops.segment_sum(xyz, flat_s, num_segments=g_total + 1,
                               indices_are_sorted=True)
    outer = (xyz[:, :, None] * xyz[:, None, :]).reshape(-1, 9)
    sums2 = jax.ops.segment_sum(outer, flat_s, num_segments=g_total + 1,
                                indices_are_sorted=True)
    cnt = jnp.maximum(counts, 1).astype(sums.dtype)
    means = sums / cnt[:, None]
    e2 = sums2.reshape(g_total + 1, 3, 3) / cnt[:, None, None]
    covs = e2 - means[:, :, None] * means[:, None, :]
    counts = counts.at[g_total].set(0)
    means = means.at[g_total].set(0.0)
    covs = covs.at[g_total].set(0.0)
    return DenseGaussianVoxelMap(means, covs, counts, corner, grid, dims)


def gather_gaussians_dense(dgm: DenseGaussianVoxelMap, queries: jax.Array,
                           q_mask: jax.Array, offsets: jax.Array,
                           min_points: int = 6):
    """Dense-index Gaussian lookup: -> (means, covs, valid, flat_idx).

    ``flat_idx`` (Q, K) lets callers gather side tables (e.g. precomputed
    precision matrices) along the same indices without a second lookup.
    """
    c = jnp.floor((queries - dgm.corner) / dgm.grid).astype(jnp.int32)
    nc = c[:, None, :] + offsets[None, :, :]
    flat = _dense_flat(nc, dgm.dims, q_mask[:, None])
    valid = dgm.counts[flat] >= min_points
    return dgm.means[flat], dgm.covs[flat], valid, flat


# ---------------------------------------------------------------------------
# Gaussian voxel map (NDT / VGICP backend, sorted-table variant)
# ---------------------------------------------------------------------------

class GaussianVoxelMap(NamedTuple):
    """Sorted voxel table of Gaussian moments (mean, covariance, count)."""

    keys: jax.Array    # (V,) int32
    means: jax.Array   # (V, 3)
    covs: jax.Array    # (V, 3, 3)
    counts: jax.Array  # (V,)
    origin: jax.Array  # (3,)
    grid: jax.Array    # ()


@partial(jax.jit, static_argnames=("num_voxels", "min_points"))
def build_gaussian_voxel_map(pc: PointCloud, grid, origin: jax.Array,
                             num_voxels: int, min_points: int = 6) -> GaussianVoxelMap:
    """Accumulate per-voxel Gaussian moments (VoxelGridCovariance role).

    Voxels with fewer than ``min_points`` points keep count but are flagged by
    ``counts < min_points`` — consumers skip them like pclomp's
    ``min_points_per_voxel`` (voxel_grid_covariance_omp.h default 6).
    Covariances here are raw (unregularized); NDT/VGICP apply their own
    eigenvalue conditioning.
    """
    grid = jnp.asarray(grid, pc.xyz.dtype)
    keys = voxel_keys(pc.xyz, pc.mask, origin, grid)
    keys_s, xyz_s, _, seg_id, _, _ = _sorted_segments(keys, pc.xyz, pc.intensity)
    seg = jnp.where(seg_id < num_voxels, seg_id, num_voxels)

    counts = jax.ops.segment_sum(
        (seg_id < num_voxels).astype(jnp.int32), seg,
        num_segments=num_voxels, indices_are_sorted=True
    )
    sums = jax.ops.segment_sum(xyz_s, seg, num_segments=num_voxels,
                               indices_are_sorted=True)
    outer = xyz_s[:, :, None] * xyz_s[:, None, :]
    sums2 = jax.ops.segment_sum(outer.reshape(-1, 9), seg,
                                num_segments=num_voxels,
                                indices_are_sorted=True)
    cnt = jnp.maximum(counts, 1).astype(sums.dtype)
    means = sums / cnt[:, None]
    e2 = sums2.reshape(num_voxels, 3, 3) / cnt[:, None, None]
    covs = e2 - means[:, :, None] * means[:, None, :]

    table_keys = jnp.full((num_voxels,), INVALID_KEY, jnp.int32).at[seg].set(
        keys_s, mode="drop"
    )
    # zero the stats of padding rows so sentinels can't alias as voxels
    is_valid_row = table_keys != INVALID_KEY
    means = jnp.where(is_valid_row[:, None], means, 0.0)
    covs = jnp.where(is_valid_row[:, None, None], covs, 0.0)
    counts = jnp.where(is_valid_row, counts, 0)
    return GaussianVoxelMap(table_keys, means, covs, counts, origin, grid)


def gather_gaussians(gvm: GaussianVoxelMap, queries: jax.Array, q_mask: jax.Array,
                     offsets: jax.Array, min_points: int = 6):
    """Lookup Gaussian voxels at ``queries`` + ``offsets`` neighborhoods.

    offsets: (K, 3) int32 (e.g. DIRECT7_OFFSETS). Returns
    (means (Q, K, 3), covs (Q, K, 3, 3), valid (Q, K)).
    """
    c = voxel_coords(queries, gvm.origin, gvm.grid)
    nc = c[:, None, :] + offsets[None, :, :]
    nkeys = pack_coords(nc, q_mask[:, None])
    idx, found = lookup_voxels(gvm.keys, nkeys)
    valid = found & (gvm.counts[idx] >= min_points)
    return gvm.means[idx], gvm.covs[idx], valid
