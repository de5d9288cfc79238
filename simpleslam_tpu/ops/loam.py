"""LOAM-style point-to-plane Gauss-Newton registration on SE(3).

Device re-architecture of the reference's first-party registration core
(``PCR/src/LoamRegister.cpp:99-223``): the per-point OpenMP loop with
``omp critical`` row accumulation becomes one vmapped residual/Jacobian
evaluation with masked einsum normal equations; the kd-tree 5-NN becomes a
batched voxel-slab kNN; the ragged "valid point" early-exits become masks.

Behavioral parity (thresholds from ``PCR/include/PCR/LoamRegister.hpp:30-40``):
- 5-NN gated by 5th-neighbor sq-dist < 1.0 (mKdtreeMaxSearchDist),
- plane fit Ax = -1, validity |x . a_i + 1| <= 0.2 |x| (mPlaneValidThresh),
- residual d = (x . p + 1)/|x|, weight s = 1 - 0.9 |d| / sqrt(|p_src|),
  accepted when s > 0.1 (mPointValidThresh),
- J row = s * (x/|x|)^T [I | -skew(p_map)], solve J^T J dx = -J^T e,
- pose <- exp(dx) * pose (left multiplicative, Lie-group update),
- converged when |dx_t| <= 5e-3 and |dx_r| <= 5e-3 BEFORE applying the step
  (the reference breaks without applying, LoamRegister.cpp:203-207),
- at most 8 iterations; needs >= 6 valid rows; rotation re-orthonormalized
  after the loop (trans::T2SE3).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import geometry as geo
from .linalg3 import symeig3x3_smallest
from .pointcloud import PointCloud
from .voxel import DenseVoxelMap, VoxelMap

PLANE_PTS = 5
MAX_SEARCH_SQ = 1.0
PLANE_VALID_THRESH = 0.2
POINT_VALID_THRESH = 0.1
POS_CONVERGE = 5e-3
ROT_CONVERGE = 5e-3
MAX_ITERS = 8
MIN_VALID_ROWS = 6


class LoamResult(NamedTuple):
    pose: jax.Array       # (4, 4) refined pose
    converged: jax.Array  # () bool
    iters: jax.Array      # () int32 iterations executed
    n_valid: jax.Array    # () int32 valid rows in the last normal equations
    n_gathers: jax.Array  # () int32 HBM neighborhood gathers (incl. initial)


# Eigenvalue gates (no reference counterpart, quality upgrades over the raw
# residual check of LoamRegister.cpp:38-41). Eigenvalues are of the centered
# 5-point scatter (sum, not mean):
# - collinearity: lambda_1 must exceed MIN_PLANAR_EV, else the neighbor set is
#   a line (sparse LiDAR ring) whose fitted "plane" has an arbitrary normal;
# - flatness: lambda_0 must stay below MAX_THICKNESS_EV, else the set mixes
#   two surfaces (wall base + ground corner contamination) and its tilted
#   normal biases the solve.
# 0.01 m^2 over 5 points ~= 4.5 cm spread in the offending direction.
MIN_PLANAR_EV = 1e-2
MAX_THICKNESS_EV = 2e-2


def gather_candidates(src: PointCloud, vm: VoxelMap, pose: jax.Array):
    """Neighborhood candidate gather at ``pose`` — the HBM-heavy half.

    merged dense grid = pre-merged 2x2x2 rows, ONE HBM row per query (the
    production target — see voxel.MergedDenseVoxelMap); dense grid =
    corner-selected 2x2x2 gather (8 rows/query; both require the map built
    with grid >= 2 * sqrt(MAX_SEARCH_SQ) — LoamRegister uses grid 2.0);
    sorted table = 27-cell key search (kept for the sharded/dp path which
    shards the compact table).
    """
    from .voxel import MergedDenseVoxelMap

    p_map = geo.transform_points(pose, src.xyz)
    if isinstance(vm, MergedDenseVoxelMap):
        from .voxel import gather_neighbors_merged
        return gather_neighbors_merged(vm, p_map, src.mask)
    if isinstance(vm, DenseVoxelMap):
        from .voxel import gather_neighbors_corner
        return gather_neighbors_corner(vm, p_map, src.mask)
    from .voxel import gather_neighbors
    return gather_neighbors(vm, p_map, src.mask, 1)


class Planes(NamedTuple):
    """Per-query frozen plane set (see ``fit_planes``)."""

    centroid: jax.Array  # (Q, 3)
    normal: jax.Array    # (Q, 3) unit
    ok: jax.Array        # (Q,) bool — 5-NN gate & eigen gates & residual gate


def fit_planes(src: PointCloud, cand: jax.Array, cand_ok: jax.Array,
               pose: jax.Array) -> Planes:
    """5-NN selection + plane fit — the pose-INDEPENDENT half of the GN
    linearization, evaluated once per candidate gather.

    Key observation behind the hot-loop design: the fitted plane
    depends only on the 5 selected TARGET points, and the selection is made
    against the pose the candidates were gathered at — so between gather
    refreshes (REGATHER_DIST) the plane set is constant and each GN
    iteration only needs the (Q, 6) residual/Jacobian work
    (``plane_normal_equations``). The reference re-runs its kd-tree 5-NN and
    QR plane fit every iteration (LoamRegister.cpp:122-164) because both are
    cheap per-point on CPU; on a device the (Q, C) selection passes are
    dense work over every candidate of every query, while the frozen-plane
    iteration is (Q, 6) work. Accuracy is unchanged
    within the cached-gather contract: the pose moves millimeters between
    iterations, and any move beyond REGATHER_DIST refreshes gather AND fit.

    Selection/fit semantics are identical to
    ``normal_equations_from_candidates`` (same argmin rounds, same gates).
    """
    p_map = geo.transform_points(pose, src.xyz)
    d2 = jnp.sum((cand - p_map[:, None, :]) ** 2, axis=-1)
    d2 = jnp.where(cand_ok, d2, jnp.inf)

    w5 = jnp.zeros_like(d2)
    d_k = jnp.zeros((d2.shape[0],), d2.dtype)
    dd = d2
    n_c = d2.shape[1]
    iota_c = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
    for _ in range(PLANE_PTS):
        d_k = jnp.min(dd, axis=1)
        hit = (dd == d_k[:, None]) & jnp.isfinite(d_k)[:, None]
        first = jnp.min(jnp.where(hit, iota_c, n_c), axis=1)
        hit = hit & (iota_c == first[:, None])
        w5 = w5 + hit.astype(w5.dtype)
        dd = jnp.where(hit, jnp.inf, dd)
    gate = src.mask & (d_k < MAX_SEARCH_SQ) & (
        jnp.sum(w5, axis=1) >= PLANE_PTS)

    centroid = jnp.einsum("nc,nci->ni", w5, cand) / PLANE_PTS
    Bc = cand - centroid[:, None, :]
    Bw = Bc * w5[..., None]
    M = jnp.einsum("nci,ncj->nij", Bw, Bc)
    lam, n_hat = symeig3x3_smallest(M)
    fit_ok = (lam[:, 1] > MIN_PLANAR_EV) & (lam[:, 0] < MAX_THICKNESS_EV)

    resid = jnp.einsum("nci,ni->nc", Bw, n_hat)
    plane_ok = jnp.max(jnp.abs(resid), axis=1) <= PLANE_VALID_THRESH
    return Planes(centroid, n_hat, gate & fit_ok & plane_ok)


def plane_normal_equations(src: PointCloud, planes: Planes, pose: jax.Array):
    """The pose-DEPENDENT half of the linearization: point-to-plane
    residuals, distance weights, J^T J / J^T e against a frozen plane set.
    Pure (Q, 6) work — no candidate-axis tensors. Weight/validity semantics
    match the reference exactly (recomputed every iteration,
    LoamRegister.cpp:166-176)."""
    p_map = geo.transform_points(pose, src.xyz)
    d = jnp.einsum("ni,ni->n", p_map - planes.centroid, planes.normal)
    src_range = jnp.linalg.norm(src.xyz, axis=-1)
    s = 1.0 - 0.9 * jnp.abs(d) / jnp.sqrt(jnp.maximum(src_range, 1e-6))
    valid = planes.ok & (s > POINT_VALID_THRESH)

    J_pt = geo.j_se3(p_map)  # (N, 3, 6)
    J_row = s[:, None] * jnp.einsum("ni,nij->nj", planes.normal, J_pt)
    e = s * d
    w = valid.astype(J_row.dtype)
    Jw = J_row * w[:, None]
    JtJ = jnp.einsum("ni,nj->ij", Jw, J_row, preferred_element_type=jnp.float32)
    JtE = jnp.einsum("ni,n->i", Jw, e, preferred_element_type=jnp.float32)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    return JtJ, JtE, n_valid


def normal_equations_from_candidates(src: PointCloud, cand: jax.Array,
                                     cand_ok: jax.Array, pose: jax.Array):
    """GN linearization against an already-gathered candidate set.

    The plane fit differs from the reference's unconstrained QR solve of
    A x = -1 (LoamRegister.cpp:29-44): we fit through the centered scatter's
    smallest eigenvector, which is numerically stable in f32 (the uncentered
    A^T A is catastrophically conditioned at 20 m+ ranges) and yields the
    same plane for well-posed neighbor sets. The residual-validity gate is
    the scale-free equivalent: max_i |n . (a_i - mean)| <= 0.2 matches
    |x . a_i + 1| <= 0.2 |x| exactly for the fitted plane.
    """
    p_map = geo.transform_points(pose, src.xyz)
    d2 = jnp.sum((cand - p_map[:, None, :]) ** 2, axis=-1)
    d2 = jnp.where(cand_ok, d2, jnp.inf)

    # 5-NN selection WITHOUT top_k/take_along (no data-dependent gathers):
    # k rounds of argmin+mask produce a 0/1 membership vector over the
    # candidate axis, and every downstream quantity (centroid, scatter,
    # residual gate) becomes a masked reduction over candidates.
    w5 = jnp.zeros_like(d2)
    d_k = jnp.zeros((d2.shape[0],), d2.dtype)
    dd = d2
    n_c = d2.shape[1]
    iota_c = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
    for _ in range(PLANE_PTS):
        d_k = jnp.min(dd, axis=1)
        hit = (dd == d_k[:, None]) & jnp.isfinite(d_k)[:, None]
        # break ties to a single candidate: first occurrence along c,
        # as min-index-of-hit (a second min reduction fuses with the
        # elementwise chain; the previous cumsum lowered to a prefix-scan
        # pass over the (N, C) tile set every round)
        first = jnp.min(jnp.where(hit, iota_c, n_c), axis=1)
        hit = hit & (iota_c == first[:, None])
        w5 = w5 + hit.astype(w5.dtype)
        dd = jnp.where(hit, jnp.inf, dd)
    gate = src.mask & (d_k < MAX_SEARCH_SQ) & (
        jnp.sum(w5, axis=1) >= PLANE_PTS)

    centroid = jnp.einsum("nc,nci->ni", w5, cand) / PLANE_PTS
    Bc = cand - centroid[:, None, :]                  # (N, C, 3)
    Bw = Bc * w5[..., None]
    M = jnp.einsum("nci,ncj->nij", Bw, Bc)
    lam, n_hat = symeig3x3_smallest(M)
    fit_ok = (lam[:, 1] > MIN_PLANAR_EV) & (lam[:, 0] < MAX_THICKNESS_EV)

    resid = jnp.einsum("nci,ni->nc", Bw, n_hat)
    plane_ok = jnp.max(jnp.abs(resid), axis=1) <= PLANE_VALID_THRESH

    d = jnp.einsum("ni,ni->n", p_map - centroid, n_hat)
    src_range = jnp.linalg.norm(src.xyz, axis=-1)
    s = 1.0 - 0.9 * jnp.abs(d) / jnp.sqrt(jnp.maximum(src_range, 1e-6))
    valid = gate & fit_ok & plane_ok & (s > POINT_VALID_THRESH)

    J_pt = geo.j_se3(p_map)  # (N, 3, 6)
    J_row = s[:, None] * jnp.einsum("ni,nij->nj", n_hat, J_pt)  # (N, 6)
    e = s * d

    w = valid.astype(J_row.dtype)
    Jw = J_row * w[:, None]
    JtJ = jnp.einsum("ni,nj->ij", Jw, J_row, preferred_element_type=jnp.float32)
    JtE = jnp.einsum("ni,n->i", Jw, e, preferred_element_type=jnp.float32)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    return JtJ, JtE, n_valid


def build_normal_equations(src: PointCloud, vm: VoxelMap, pose: jax.Array):
    """One GN linearization: masked J^T J (6,6), J^T e (6,), n_valid."""
    cand, cand_ok = gather_candidates(src, vm, pose)
    return normal_equations_from_candidates(src, cand, cand_ok, pose)


# How far the pose may drift from the pose the candidates were gathered at
# before the gather is refreshed. The corner-selected 2x2x2 gather guarantees
# candidate coverage of radius grid/2 = 1.0 m around each ORIGINAL query
# point; after the query moves by m, guaranteed coverage is 1.0 - m, so 0.2 m
# keeps >= 0.8 m of the reference's 1.0 m 5-NN search radius — only 5th
# neighbors in the 0.8-1.0 m rim (already marginal planes) can be missed.
# Per-point motion is bounded by |dt| + r_max * dtheta, measured against the
# masked max source range. Why cache at all: the gather plus plane fit is
# a sweep over every candidate of every query, while a velocity-seeded GN
# moves the pose millimeters per iteration — the reference re-runs its
# kd-tree 5-NN every iteration (LoamRegister.cpp:122-164) because
# pointer-chasing lookups are cheap on CPU; on a device the sweep is the
# cost, so the loop refreshes the neighborhood only when the pose has
# actually moved.
REGATHER_DIST = 0.2

# Degeneracy guard (the reference's ``_removeDegeneratePart`` intent —
# PCR/src/LoamRegister.cpp:209-218, absolute eigenvalue threshold 100,
# shipped disabled there): solve the normal equations in the eigenbasis of
# J^T J and zero the update along directions whose eigenvalue is under
# ``degen_per_row * n_valid``. In a degenerate scene (long corridor: every
# plane normal ⊥ the corridor axis) the unobservable direction then stays at
# its prediction instead of wandering on structured noise (measured: up to
# 0.5 m of invented motion per registration without the guard,
# tests/test_adversarial.py).
#
# Why this is a config knob (frontend.degeneracy_guard) DEFAULTING OFF, like
# the reference's own disabled scaffold: eigenvalue magnitude measures row
# support, not signal-to-noise. Measured per-row spectra: a flat world's
# weakest REAL direction (z from eigen-gated sparse ground rings) sits at
# ~0.001-0.06 per row and carries usable signal, while a corridor's truly
# unobservable axis shows ~0.012 per row of pure structured noise — the
# ranges OVERLAP, so no threshold family can serve both. Operators enable
# the guard (and this calibrated floor) in degenerate environments; in
# feature-rich worlds the unguarded solve extracts the weak-but-real
# directions.
DEGEN_EIGEN_PER_ROW = 0.02


def gn_loop(src: PointCloud, vm: VoxelMap, init_pose: jax.Array,
            max_iters: int = MAX_ITERS, reduce_fn=None,
            degen_per_row=0.0, rmax_reduce_fn=None) -> LoamResult:
    """The full GN loop (trace-time body, shared by the single-device and
    sharded paths). ``reduce_fn``, when given, reduces (JtJ, JtE, n_valid)
    across shards (e.g. one fused psum); ``rmax_reduce_fn`` must then
    pmax the max source range so every shard sees the SAME regather
    schedule — the frozen plane set is refit at the gather pose, so a
    shard-local refresh decision would make shards linearize against
    differently-timed fits. ``degen_per_row`` > 0 enables the degeneracy
    guard (see DEGEN_EIGEN_PER_ROW above).

    Structure: each candidate gather is immediately reduced to a frozen
    per-query plane set (``fit_planes``) — the (Q, C) candidate tensor
    never enters the loop carry, and each GN iteration is only the (Q, 6)
    ``plane_normal_equations`` work. Re-running selection+fit every
    iteration would repeat the (Q, C) passes per iteration instead of per
    gather; freezing the fit takes them off the iteration path, which is
    why no fused linearization kernel is needed here.
    """

    def _fit(pose):
        cand, ok = gather_candidates(src, vm, pose)
        return fit_planes(src, cand, ok, pose)

    pose0 = init_pose.astype(jnp.float32)
    planes0 = _fit(pose0)
    r_max = jnp.max(jnp.where(src.mask,
                              jnp.linalg.norm(src.xyz, axis=-1), 0.0))
    if rmax_reduce_fn is not None:
        r_max = rmax_reduce_fn(r_max)

    def cond(carry):
        pose, anchor, planes, it, converged, failed, _, _ = carry
        return (it < max_iters) & (~converged) & (~failed)

    def body(carry):
        pose, anchor, planes, it, converged, failed, _, gathers = carry
        # refresh the cached gather when accumulated motion erodes coverage
        dt = jnp.linalg.norm(pose[:3, 3] - anchor[:3, 3])
        cos_a = (jnp.trace(anchor[:3, :3].T @ pose[:3, :3]) - 1.0) * 0.5
        dth = jnp.arccos(jnp.clip(cos_a, -1.0, 1.0))
        moved = dt + r_max * dth

        def refresh(_):
            return _fit(pose), pose, gathers + 1

        def keep(_):
            return planes, anchor, gathers

        planes, anchor, gathers = jax.lax.cond(
            moved > REGATHER_DIST, refresh, keep, None)
        JtJ, JtE, n_valid = plane_normal_equations(src, planes, pose)
        if reduce_fn is not None:
            JtJ, JtE, n_valid = reduce_fn(JtJ, JtE, n_valid)
        enough = n_valid >= MIN_VALID_ROWS
        # damp the padding-only case so the solve stays finite under masks
        JtJ_safe = JtJ + jnp.eye(6, dtype=JtJ.dtype) * jnp.where(enough, 0.0, 1.0)
        if degen_per_row > 0:
            # eigenbasis solve with the degeneracy floor (see
            # DEGEN_EIGEN_PER_ROW). Trace-time branch: a 6x6 eigh per GN
            # iteration is an iterative small-matrix solve, so the default
            # (guard off) path keeps the direct solve.
            w_eig, V = jnp.linalg.eigh(JtJ_safe)
            y = V.T @ (-JtE)
            floor = jnp.asarray(degen_per_row, JtJ.dtype) * \
                n_valid.astype(JtJ.dtype)
            strong = w_eig > jnp.where(enough, floor, 0.0)
            dx = V @ jnp.where(strong, y / jnp.maximum(w_eig, 1e-12), 0.0)
        else:
            dx = jnp.linalg.solve(JtJ_safe, -JtE)
        conv = (jnp.linalg.norm(dx[:3]) <= POS_CONVERGE) & (
            jnp.linalg.norm(dx[3:]) <= ROT_CONVERGE
        )
        # reference breaks pre-update on convergence and on starvation
        new_pose = jnp.where(
            conv | ~enough, pose, geo.pose_compose(geo.se3_exp(dx), pose)
        )
        return (new_pose, anchor, planes, it + 1, conv & enough, ~enough,
                n_valid, gathers)

    init = (
        pose0,
        pose0,
        planes0,
        jnp.int32(0),
        jnp.array(False),
        jnp.array(False),
        jnp.int32(0),
        jnp.int32(1),
    )
    pose, _, _, iters, converged, _, n_valid, gathers = jax.lax.while_loop(
        cond, body, init)
    pose = geo.reorthonormalize(pose)
    return LoamResult(pose, converged, iters, n_valid, gathers)


@partial(jax.jit, static_argnames=("max_iters", "degen_per_row"))
def scan2map(src: PointCloud, vm: VoxelMap, init_pose: jax.Array,
             max_iters: int = MAX_ITERS,
             degen_per_row: float = 0.0) -> LoamResult:
    """Full GN loop under ``lax.while_loop`` (compiled once per shape).

    ``vm`` must be built with grid >= sqrt(MAX_SEARCH_SQ) so the radius-1
    neighborhood covers the search distance (voxel.knn docstring).
    """
    return gn_loop(src, vm, init_pose, max_iters,
                   degen_per_row=degen_per_row)
