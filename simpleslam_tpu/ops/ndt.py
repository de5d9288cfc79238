"""NDT scan-to-map registration on Gaussian voxels (pclomp role).

Device equivalent of the vendored OpenMP NDT
(``third_parties/pclomp/src/pclomp/ndt_omp_impl.hpp``, used via
``PCR/src/NdtRegister.cpp`` with resolution 1.0; neighborhood widened to the
full 27-cell cube — see NEIGHBORHOOD_OFFSETS below):
the target is voxelized into Gaussian cells, and Magnusson's negative
log-likelihood score is minimized over SE(3).

Redesign notes (not a translation):
- per-point Euler-angle derivatives + More-Thuente line search become a
  batched left-perturbation Newton/LM loop under ``lax.while_loop`` — the
  line search is replaced by adaptive LM damping, which vectorizes;
- voxel lookups ride the DENSE Gaussian voxel grid (ops/voxel.py
  DenseGaussianVoxelMap) with a batched 27-cell neighborhood — lookup is
  pure index arithmetic (a sorted-table searchsorted is log2(V)
  dependent gathers per query);
- covariance conditioning follows pclomp's VoxelGridCovariance: eigenvalues
  below 0.01 * lambda_max are inflated to that floor.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import geometry as geo
from .linalg3 import solve3x3, symeig3x3
from .pointcloud import PointCloud
from .voxel import (DenseGaussianVoxelMap, _neighbor_offsets,
                    gather_gaussians_dense)

# Neighborhood: the full 3^3 cube (pclomp's DIRECT26 + center). The reference
# adapter picks DIRECT7 as a CPU-cost compromise (NdtRegister.cpp:13); on a
# device the gather is batched and the 4x wider support both smooths the objective
# and roughly doubles the convergence basin (validated on the lo-mode
# pipeline: DIRECT7 stalls at ~0.2 m init error and diverges, DIRECT27
# tracks at 0.15 m/scan prediction error indefinitely).
NEIGHBORHOOD_OFFSETS = _neighbor_offsets(1)

# Magnusson score coefficients (pclomp defaults: outlier_ratio 0.55, res 1.0)
OUTLIER_RATIO = 0.55
MAX_ITERS = 30
CONVERGE_EPS = 1e-3
# pclomp's min_points_per_voxel default is 6 — against the RAW cloud. Our
# target arrives pre-downsampled at 0.5 m (LidarOdometry feeds the same
# submap to every backend), so a planar 1 m voxel holds ~4 points; with
# eigenvalue flooring a 4-point Gaussian is perfectly usable. 6 would prune
# nearly the whole map.
MIN_VOXEL_POINTS = 4
EV_FLOOR_RATIO = 0.01


class NdtResult(NamedTuple):
    pose: jax.Array
    converged: jax.Array
    iters: jax.Array
    score: jax.Array  # mean exp-score over matched points (trans_probability)


class NdtTarget(NamedTuple):
    """Dense Gaussian grid + precomputed precision matrices.

    Precisions (conditioned-covariance inverses over the whole table) are
    built ONCE per submap rebuild here, not per align call — the reference's
    VoxelGridCovariance likewise inverts at target-set time
    (voxel_grid_covariance_omp_impl.hpp applyFilter)."""

    gauss: DenseGaussianVoxelMap
    precisions: jax.Array  # (G+1, 3, 3)


@partial(jax.jit, static_argnames=("dims",))
def build_target(submap: PointCloud, resolution, center: jax.Array,
                 dims) -> NdtTarget:
    from .voxel import build_dense_gaussian_voxel_map

    gvm = build_dense_gaussian_voxel_map(submap, resolution, center, dims)
    return NdtTarget(gvm, _precision_matrices(gvm))


def _gauss_coeffs(resolution: float):
    """PCL's gauss_d1_/gauss_d2_ with d1 sign folded: we MINIMIZE
    F = sum_i -d1 * exp(-0.5 d2 q_i) with d1 > 0 (PCL keeps d1 negative and
    maximizes the mirrored score; same optimum)."""
    c1 = 10.0 * (1.0 - OUTLIER_RATIO)
    c2 = OUTLIER_RATIO / (resolution ** 3)
    d3 = -np.log(c2)
    d1_pcl = -np.log(c1 + c2) - d3
    d2 = -2.0 * np.log((-np.log(c1 * np.exp(-0.5) + c2) - d3) / d1_pcl)
    return float(abs(d1_pcl)), float(d2)


def condition_covariances(covs: jax.Array) -> jax.Array:
    """Inflate small eigenvalues to EV_FLOOR_RATIO * lambda_max
    (VoxelGridCovariance semantics)."""
    lam, V = symeig3x3(covs)
    floor = EV_FLOOR_RATIO * lam[..., 2:3]
    lam_c = jnp.maximum(lam, jnp.maximum(floor, 1e-9))
    return jnp.einsum("...ik,...k,...jk->...ij", V, lam_c, V)


def _precision_matrices(gvm: DenseGaussianVoxelMap) -> jax.Array:
    cond = condition_covariances(gvm.covs)
    eye = jnp.eye(3, dtype=cond.dtype)
    inv, ok = solve3x3_batch(cond + 1e-9 * eye)
    return jnp.where(ok[:, None, None], inv, 0.0)


def solve3x3_batch(A: jax.Array):
    """Batched 3x3 inverse via Cramer on well-conditioned (floored) matrices."""
    eye = jnp.broadcast_to(jnp.eye(3, dtype=A.dtype), A.shape)
    cols = []
    oks = []
    for k in range(3):
        x, ok = solve3x3(A, eye[..., k])
        cols.append(x)
        oks.append(ok)
    inv = jnp.stack(cols, axis=-1)
    ok = oks[0] & oks[1] & oks[2]
    return inv, ok


def score_terms(src: PointCloud, gvm: DenseGaussianVoxelMap,
                precisions: jax.Array, pose: jax.Array, d1: float, d2: float):
    """Batched score/gradient/Hessian accumulation over neighborhood voxels.

    Returns (H (6,6), g (6,), score_sum, n_matched).
    """
    p_map = geo.transform_points(pose, src.xyz)
    offs = jnp.asarray(NEIGHBORHOOD_OFFSETS)
    means, _, valid, idx = gather_gaussians_dense(
        gvm, p_map, src.mask, offs, min_points=MIN_VOXEL_POINTS
    )
    B = precisions[idx]  # (N, 27, 3, 3) along the same dense indices

    x = p_map[:, None, :] - means  # (N, 7, 3)
    Bx = jnp.einsum("nkij,nkj->nki", B, x)
    q = jnp.einsum("nki,nki->nk", x, Bx)
    # guard overflow for far mismatches
    e = jnp.exp(-0.5 * d2 * jnp.minimum(q, 50.0))
    w = valid.astype(x.dtype)

    score = -d1 * e * w  # negative is good
    J = geo.j_se3(p_map)  # (N, 3, 6); dx/ddelta for every voxel of the point
    gx = (d1 * d2) * e[..., None] * Bx  # dF/dx (N, 7, 3)
    g = jnp.einsum("nki,nij->j", gx * w[..., None], J)
    # PSD Gauss-Newton curvature: keep only the exp-weighted J^T B J term.
    # The full Newton Hessian's -d2 (Bx)(Bx)^T part is indefinite away from
    # the optimum and flips the search direction into side valleys (verified
    # against autodiff and on synthetic scans); pclomp compensates with
    # More-Thuente — we instead pair the PSD matrix with a wide batched line
    # search in align().
    JB = jnp.einsum("nkij,njl->nkil", B, J)  # (N, 7, 3, 6)
    H = (d1 * d2) * jnp.einsum(
        "nk,nim,nkil->ml", e * w, J, JB, preferred_element_type=jnp.float32
    )
    return H, g, jnp.sum(score), jnp.sum(valid.any(axis=1).astype(jnp.int32))


def score_only(src: PointCloud, gvm: DenseGaussianVoxelMap,
               precisions: jax.Array, pose: jax.Array, d1: float,
               d2: float) -> jax.Array:
    """Objective value only (cheap line-search evaluation)."""
    p_map = geo.transform_points(pose, src.xyz)
    offs = jnp.asarray(NEIGHBORHOOD_OFFSETS)
    means, _, valid, idx = gather_gaussians_dense(
        gvm, p_map, src.mask, offs, min_points=MIN_VOXEL_POINTS
    )
    B = precisions[idx]
    x = p_map[:, None, :] - means
    q = jnp.einsum("nki,nkij,nkj->nk", x, B, x)
    e = jnp.exp(-0.5 * d2 * jnp.minimum(q, 50.0))
    return jnp.sum(-d1 * e * valid.astype(x.dtype))


# Line-search step fractions, evaluated as ONE batched (vmapped) score call
# per iteration — the batched replacement for pclomp's sequential More-Thuente
# search (ndt_omp_impl.hpp computeStepLengthMT). Over-relaxed entries (>1)
# compensate for the conservative PSD GN step length.
LINE_SEARCH_ALPHAS = (4.0, 2.0, 1.0, 0.5, 0.25, 0.1)


@partial(jax.jit, static_argnames=("max_iters", "axis_reduce"))
def align(src: PointCloud, target: NdtTarget, init_pose: jax.Array,
          max_iters: int = MAX_ITERS, axis_reduce=None) -> NdtResult:
    """Damped Newton + batched backtracking line search on the NDT score.

    ``axis_reduce`` (multi-device point sharding): a function psumming a flat
    f32 vector over the mesh axis. Per Newton iteration the sharded path
    costs TWO collectives — one 44-float psum of (H, g, score, n) and one
    6-float psum of the line-search candidate scores (sequential because
    the candidates depend on the reduced step).
    """
    d1, d2 = _gauss_coeffs(float(1.0))  # NdtRegister.cpp:13 always uses 1.0
    gvm, precisions = target.gauss, target.precisions
    alphas = jnp.asarray(LINE_SEARCH_ALPHAS, jnp.float32)

    def _terms(pose):
        H, g, score, n = score_terms(src, gvm, precisions, pose, d1, d2)
        if axis_reduce is not None:
            flat = axis_reduce(jnp.concatenate(
                [H.reshape(36), g, score[None],
                 n.astype(jnp.float32)[None]]))
            H = flat[:36].reshape(6, 6)
            g = flat[36:42]
            score = flat[42]
            n = flat[43].astype(jnp.int32)
        return H, g, score, n

    def cond(carry):
        pose, it, conv, lam, _ = carry
        return (it < max_iters) & (~conv)

    def body(carry):
        pose, it, conv, lam, _ = carry
        H, g, score, n = _terms(pose)
        diag = jnp.clip(jnp.abs(jnp.diagonal(H)), 1e-6, None)
        dx = jnp.linalg.solve(H + (lam * 1e-4) * jnp.diag(diag) +
                              1e-6 * jnp.eye(6, dtype=H.dtype), -g)

        cand = jax.vmap(
            lambda a: geo.pose_compose(geo.se3_exp(a * dx), pose)
        )(alphas)
        cand_scores = jax.vmap(
            lambda P: score_only(src, gvm, precisions, P, d1, d2)
        )(cand)
        if axis_reduce is not None:
            cand_scores = axis_reduce(cand_scores)
        best = jnp.argmin(cand_scores)
        improved = cand_scores[best] < score
        pose_next = jnp.where(improved, cand[best], pose)
        lam_next = jnp.where(improved, jnp.maximum(lam * 0.5, 1e-4),
                             jnp.minimum(lam * 8.0, 1e4))
        step = alphas[best] * jnp.linalg.norm(dx)
        conv_next = improved & (step < CONVERGE_EPS)
        starved = n < 6
        return (pose_next, it + 1, conv_next | starved, lam_next, score)

    init = (init_pose.astype(jnp.float32), jnp.int32(0), jnp.array(False),
            jnp.float32(1e-2), jnp.float32(0.0))
    pose, iters, conv, _, _ = jax.lax.while_loop(cond, body, init)
    pose = geo.reorthonormalize(pose)
    _, _, final_score, n = _terms(pose)
    n_pts = jnp.sum(src.mask.astype(jnp.int32))
    if axis_reduce is not None:
        n_pts = axis_reduce(n_pts.astype(jnp.float32)[None]
                            )[0].astype(jnp.int32)
    n_pts = jnp.maximum(n_pts, 1)
    trans_prob = -final_score / n_pts.astype(jnp.float32)
    return NdtResult(pose, conv & (n >= 6), iters, trans_prob)
