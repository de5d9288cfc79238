"""Batched SE(3) pose-graph solver — the framework's GTSAM/iSAM2 replacement.

The reference backend delegates to GTSAM iSAM2 (``backend/src/Backend.cpp:29-123``:
prior + Between factors, diagonal noise, incremental update after every
keyframe/LC event). This module re-architects that role for an
accelerator (SURVEY.md §7): the factor graph is a padded edge tensor, residuals and
Jacobians are one vmapped autodiff evaluation, and the normal equations are
never materialized densely — Levenberg-Marquardt steps solve
``(H + lambda D) dx = -g`` by **block-Jacobi preconditioned conjugate
gradient** whose matvec works on the block-sparse 6x6 edge blocks.

Distribution (communication-optimal for SLAM-scale graphs): the O(E) work —
per-edge SE(3) residuals, autodiff Jacobians, 6x6 block products — is
sharded over the mesh axis; each LM iteration then reconstructs the COMPACT
block-sparse normal equations (per-edge [H_ii, H_jj, H_ij, g_i, g_j, chi2,
i, j] = 123 floats) on every device with ONE ``all_gather``, and the whole
PCG inner solve runs replicated with ZERO collectives. Rationale: at SLAM
scale (K <= 10^4, E <= 4K) a CG matvec is < 1 MFLOP — pure latency — while
the linearization carries the real FLOPs (manifold logs + autodiff); so
shard the flops, gather the 6x6-block summary once, and never put a
collective inside CG. This cut the solver's collective count from
``1 + iters*(3 + cg_iters)`` (~211) to ``1 + iters`` (~7), which is what
makes the measured multi-host scaling honest even over high-latency links
(benchmarks/bench_scaling.py).

Conventions:
- twist ordering [rho (trans), w (rot)] as everywhere in the framework
  (ops/geometry.py). Note GTSAM orders (rot, trans) — noise vectors from the
  reference (Backend.cpp:90-97) are re-ordered by the backend model layer.
- right perturbation ``T_k <- T_k exp(xi_k)`` (GTSAM convention), so the
  between-factor residual is ``r_e = log(Tij^-1 (T_i exp(xi_i))^-1 (T_j exp(xi_j)))``.
- ``edge_info`` is the diagonal information (1/variance) of each edge; padding
  edges carry zero info and contribute nothing.
- gauge freedom is fixed by a diagonal prior on node 0 (PriorFactor role).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import geometry as geo


class PoseGraph(NamedTuple):
    """Padded pose-graph tensors (static shapes K, E)."""

    poses: jax.Array       # (K, 4, 4) current estimates
    kf_mask: jax.Array     # (K,) bool valid nodes
    edge_i: jax.Array      # (E,) int32 from-node
    edge_j: jax.Array      # (E,) int32 to-node
    edge_T: jax.Array      # (E, 4, 4) measured between T_i^-1 T_j
    edge_info: jax.Array   # (E, 6) diagonal information [trans, rot]
    edge_mask: jax.Array   # (E,) bool
    prior_pose: jax.Array  # (4, 4) prior on node 0
    prior_info: jax.Array  # (6,) diagonal information of the prior


class SolveResult(NamedTuple):
    poses: jax.Array     # (K, 4, 4) optimized
    cost0: jax.Array     # () initial chi2
    cost: jax.Array      # () final chi2
    iters: jax.Array     # () int32 LM iterations executed
    accepted: jax.Array  # () int32 accepted LM steps


def _edge_residual(xi_i, xi_j, Ti, Tj, Tij):
    """r = log(Tij^-1 (Ti exp(xi_i))^-1 (Tj exp(xi_j))), (6,)."""
    A = geo.pose_compose(Ti, geo.se3_exp(xi_i))
    B = geo.pose_compose(Tj, geo.se3_exp(xi_j))
    return geo.se3_log(
        geo.pose_compose(geo.pose_inverse(Tij),
                         geo.pose_compose(geo.pose_inverse(A), B))
    )


def _prior_residual(xi, T, Tp):
    """r = log(Tp^-1 (T exp(xi))), (6,)."""
    return geo.se3_log(
        geo.pose_compose(geo.pose_inverse(Tp), geo.pose_compose(T, geo.se3_exp(xi)))
    )


# host scalar zeros: a module-level jnp array would be a device-resident
# buffer captured by every program that closes over it (same rule as
# voxel.INVALID_KEY)
_zero6 = np.zeros((6,), np.float32)


def _linearize_edges(g: PoseGraph):
    """Vmapped residuals + autodiff Jacobians at xi = 0.

    Returns (r (E,6), Ji (E,6,6), Jj (E,6,6)) with padding edges zeroed.
    """
    Ti = g.poses[g.edge_i]
    Tj = g.poses[g.edge_j]

    def one(Ti, Tj, Tij):
        r = _edge_residual(_zero6, _zero6, Ti, Tj, Tij)
        Ji = jax.jacfwd(_edge_residual, argnums=0)(_zero6, _zero6, Ti, Tj, Tij)
        Jj = jax.jacfwd(_edge_residual, argnums=1)(_zero6, _zero6, Ti, Tj, Tij)
        return r, Ji, Jj

    r, Ji, Jj = jax.vmap(one)(Ti, Tj, g.edge_T)
    m = g.edge_mask[:, None]
    return jnp.where(m, r, 0.0), Ji * m[:, :, None], Jj * m[:, :, None]


def _linearize_prior(g: PoseGraph):
    r = _prior_residual(_zero6, g.poses[0], g.prior_pose)
    Jp = jax.jacfwd(_prior_residual, argnums=0)(_zero6, g.poses[0], g.prior_pose)
    return r, Jp


def _psum(x, axis):
    return jax.lax.psum(x, axis) if axis is not None else x


@partial(jax.jit, static_argnames=("axis",))
def graph_cost(g: PoseGraph, axis: str | None = None) -> jax.Array:
    """Total chi2 = sum_e r^T W r + prior (the GTSAM error function role).

    With ``axis`` set (inside shard_map, edges sharded over that mesh axis)
    the edge sum rides a psum; the prior is added once post-reduction.
    Jitted: the vmapped autodiff body is ~20 s of EAGER op dispatch
    otherwise (jit-under-jit is free when called from compiled callers).
    """
    r, _, _ = _linearize_edges(g)
    rp, _ = _linearize_prior(g)
    edge_chi2 = _psum(jnp.sum(r * r * g.edge_info), axis)
    return edge_chi2 + jnp.sum(rp * rp * g.prior_info)


class _Lin(NamedTuple):
    """Block-sparse normal equations at one linearization point (replicated
    on every device after the single all_gather)."""

    cost: jax.Array   # () total chi2 (edges + prior)
    grad: jax.Array   # (K, 6) J^T W r (incl. prior)
    diag: jax.Array   # (K, 6, 6) block diagonal of H (incl. prior)
    bij: jax.Array    # (E, 6, 6) off-diagonal blocks H[i, j]
    ei: jax.Array     # (E,) int32 global from-nodes
    ej: jax.Array     # (E,) int32 global to-nodes


def _linearize_full(g: PoseGraph, poses: jax.Array,
                    axis: str | None = None,
                    shard_cg: bool = False,
                    shard_lin: bool = False) -> _Lin:
    """Linearize + assemble the block-sparse normal equations.

    With ``axis`` set (inside shard_map, edge tensors sharded), the per-edge
    work runs on this shard only. Three distribution modes:

    - replicated CG (``shard_cg=False``): the compact per-edge summary rides
      ONE ``all_gather`` and every device holds the full block-sparse system
      — the solver's only collective, the right trade on high-latency links.
      The segment reductions then run REPLICATED over the full edge set.
    - sharded CG (``shard_cg=True``): the off-diagonal blocks STAY on their
      shard; only the already-reduced (K, 6) gradient, (K, 6, 6) block
      diagonal and chi2 ride ONE fused ``psum`` — the CG matvec then psums
      its off-diagonal contribution per iteration (``_make_hvp``). Right
      when collectives are cheap relative to O(E) compute (a device
      interconnect, or the virtual-device harness where replicated work
      burns shared cores).
    - sharded linearization (``shard_lin=True``): EVERYTHING O(E) shards —
      per-edge work AND the segment reductions (computed per shard, summed
      from gathered partials) — and ONE fused ``all_gather`` per
      linearization carries both the (K, 43) partial node system and this
      shard's (E/N, 38) off-diagonal blocks, so the downstream CG runs
      replicated and collective-free on the full system. This is the
      session-scale 2-host mode: measured at K=4096 the segment sums are
      ~half the linearization cost, and leaving them replicated (mode 1)
      capped 2-host efficiency at ~0.7 no matter how cheap collectives get.

    The prior (replicated) is added after the reduction, exactly once.
    """
    gg = g._replace(poses=poses)
    r, Ji, Jj = _linearize_edges(gg)
    rp, Jp = _linearize_prior(gg)
    wi = Ji * gg.edge_info[:, :, None]          # W Ji (rows weighted)
    wj = Jj * gg.edge_info[:, :, None]
    bii = jnp.einsum("eab,eac->ebc", wi, Ji)    # Ji^T W Ji
    bjj = jnp.einsum("eab,eac->ebc", wj, Jj)
    bij = jnp.einsum("eab,eac->ebc", wi, Jj)    # Ji^T W Jj = H[i, j]
    gi = jnp.einsum("eab,ea->eb", wi, r)
    gj = jnp.einsum("eab,ea->eb", wj, r)
    chi2 = jnp.sum(r * r * gg.edge_info, axis=1)
    ei, ej = gg.edge_i, gg.edge_j
    if axis is not None and shard_lin:
        # same assembly as shard_cg: bij/ei/ej stay LOCAL (the LM carry and
        # accept-selects then touch only this shard's E/N rows — carrying
        # REPLICATED full-E blocks measured ~27 ms/iteration of pure copy
        # traffic on one core at E=10k), nodes ride one fused psum; the
        # off-diagonal blocks are gathered per LM iteration by solve_impl
        # for the replicated CG.
        shard_cg = True
    if axis is not None and not shard_cg:
        packed = jnp.concatenate([
            bii.reshape(-1, 36), bjj.reshape(-1, 36), bij.reshape(-1, 36),
            gi, gj, chi2[:, None],
            ei.astype(jnp.float32)[:, None],   # exact for idx < 2^24
            ej.astype(jnp.float32)[:, None],
        ], axis=1)                              # (E_local, 123)
        packed = jax.lax.all_gather(packed, axis, axis=0, tiled=True)
        bii = packed[:, :36].reshape(-1, 6, 6)
        bjj = packed[:, 36:72].reshape(-1, 6, 6)
        bij = packed[:, 72:108].reshape(-1, 6, 6)
        gi = packed[:, 108:114]
        gj = packed[:, 114:120]
        chi2 = packed[:, 120]
        ei = packed[:, 121].astype(jnp.int32)
        ej = packed[:, 122].astype(jnp.int32)
    K = g.poses.shape[0]
    grad = jax.ops.segment_sum(gi, ei, num_segments=K)
    grad = grad + jax.ops.segment_sum(gj, ej, num_segments=K)
    diag = jax.ops.segment_sum(bii, ei, num_segments=K)
    diag = diag + jax.ops.segment_sum(bjj, ej, num_segments=K)
    cost = jnp.sum(chi2)
    if axis is not None and shard_cg:
        cost_col = jnp.zeros((K, 1), grad.dtype).at[0, 0].set(cost)
        packed = jnp.concatenate([grad, diag.reshape(K, 36), cost_col],
                                 axis=1)                       # (K, 43)
        packed = jax.lax.psum(packed, axis)
        grad = packed[:, :6]
        diag = packed[:, 6:42].reshape(K, 6, 6)
        cost = packed[0, 42]
    wp = Jp * g.prior_info[:, None]
    grad = grad.at[0].add(jnp.einsum("ab,a->b", wp, rp))
    diag = diag.at[0].add(jnp.einsum("ab,ac->bc", wp, Jp))
    cost = cost + jnp.sum(rp * rp * g.prior_info)
    return _Lin(cost, grad, diag, bij, ei, ej)


def _make_hvp(lin: _Lin, lam, axis: str | None = None,
              shard_cg: bool = False):
    """(H + lambda diag(H)) v from the block-sparse form.

    Replicated mode: collective-free — the diagonal blocks (incl. prior) act
    directly; the off-diagonal blocks contribute H[i,j] v_j at i and
    H[i,j]^T v_i at j. Sharded mode: the off-diagonal blocks are this
    shard's partition, so their contribution rides one (K, 6) ``psum``; the
    (replicated) diagonal and damping act locally after the reduction so
    they are summed exactly once.
    """
    K = lin.grad.shape[0]
    damp = lam * jnp.diagonal(lin.diag, axis1=-2, axis2=-1)  # (K, 6)
    damp = jnp.maximum(damp, lam * 1e-6)

    def hvp(v):  # v: (K, 6)
        ui = jnp.einsum("eab,eb->ea", lin.bij, v[lin.ej])    # at i
        uj = jnp.einsum("eab,ea->eb", lin.bij, v[lin.ei])    # at j (B^T v_i)
        off = jax.ops.segment_sum(ui, lin.ei, num_segments=K)
        off = off + jax.ops.segment_sum(uj, lin.ej, num_segments=K)
        if axis is not None and shard_cg:
            off = jax.lax.psum(off, axis)
        out = jnp.einsum("kab,kb->ka", lin.diag, v) + off
        return out + damp * v

    return hvp


# Largest node count solved DENSELY on a single device: H is (6K, 6K), so
# K=512 is a 9.4 MB matrix and a ~10 GFLOP factorization per LM iteration.
# Measured on one H100 80GB HBM3 at a 400 W power limit
# (ring graphs of dist_posegraph._ring_graph with K/16 loop closures, the
# backend's 12-iteration loop-closure budget): the dense solve takes 111 ms
# at K=512 and reaches the optimum (chi2 ~1e-7), while 64-iteration PCG
# takes 31 ms but stops at chi2 0.14 — the exact solve is kept where it is
# affordable. At K=1024 and 2048 dense costs 283 and 893 ms against PCG's
# 30 and 38 ms, so larger graphs run PCG.
DENSE_SOLVE_MAX_K = 512


def _dense_lm_solve(lin: _Lin, damped_diag, grad, mask):
    """One damped-normal-equation solve via a dense (6K, 6K) factorization.

    Builds H from the block-sparse form (diagonal blocks + scattered
    off-diagonal blocks) and solves in one shot — the exact solve for
    bucket-sized graphs (see DENSE_SOLVE_MAX_K). Masked nodes get identity
    rows and zero rhs, pinning their update to 0 like _pcg's masking.
    """
    K = grad.shape[0]
    eye6 = jnp.eye(6, dtype=damped_diag.dtype)
    diag_blocks = jnp.where(mask[:, None, None], damped_diag, eye6)
    H4 = jnp.zeros((K, K, 6, 6), damped_diag.dtype)
    idx = jnp.arange(K)
    H4 = H4.at[idx, idx].set(diag_blocks)
    # zero off-diagonal blocks touching a masked node BEFORE scattering:
    # a real edge incident to a masked node would otherwise couple the
    # pinned (identity-row, dx=0-intended) node into unmasked rows —
    # matching _pcg, which re-zeroes masked components every iteration
    e_live = (mask[lin.ei] & mask[lin.ej]).astype(lin.bij.dtype)
    bij = lin.bij * e_live[:, None, None]
    H4 = H4.at[lin.ei, lin.ej].add(bij)
    H4 = H4.at[lin.ej, lin.ei].add(jnp.swapaxes(bij, -1, -2))
    H = H4.transpose(0, 2, 1, 3).reshape(K * 6, K * 6)
    b = (-grad * mask[:, None].astype(grad.dtype)).reshape(K * 6)
    dx = jnp.linalg.solve(H, b).reshape(K, 6)
    return dx * mask[:, None].astype(grad.dtype)


def _pcg_ksharded(lin: _Lin, lam, damped_diag, mask, iters: int, axis: str,
                  tol: float = 1e-8, rel_tol: float = 1e-2):
    """Fully-sharded PCG for ``shard_cg`` mode: CG VECTORS shard over K.

    The round-4 sharded-CG kept x/r/z/p replicated — every device ran the
    full O(K) vector updates and preconditioner applies, which multiplies
    real CPU load on the shared-core virtual-device harness (measured: the
    8-virtual-device solve was slower than 1 device purely from the CG
    inner loop). Here each device owns a K/N slice: the matvec gathers p
    once (K x 6, ~100 KB), computes its edge shard's contribution and
    psum_scatters straight back to slices; the block-Jacobi inverse is
    computed and applied on the local slice only; the two dot products ride
    scalar psums. 4 small collectives per CG iteration, and NO O(K) or
    O(E) work is replicated anywhere in the solve.

    Requires K % n_dev == 0 (callers fall back to the replicated CG
    otherwise). Returns the FULL dx (one final all_gather).
    """
    K = lin.grad.shape[0]
    n_dev = jax.lax.axis_size(axis)
    kn = K // n_dev
    me = jax.lax.axis_index(axis)

    def sl(a):
        return jax.lax.dynamic_slice_in_dim(a, me * kn, kn)

    b = -lin.grad
    m_sl = sl(mask)[:, None].astype(b.dtype)
    pinv_sl = jnp.linalg.inv(sl(damped_diag))        # local slice only
    diag_sl = sl(lin.diag)
    damp_sl = jnp.maximum(
        lam * jnp.diagonal(diag_sl, axis1=-2, axis2=-1), lam * 1e-6)

    def apply_p(r_sl):
        return jnp.einsum("kab,kb->ka", pinv_sl, r_sl) * m_sl

    # Deferred-beta PCG: exactly TWO collectives per iteration.
    #   A: all_gather([z_sl | p_prev_sl | rz_part]) — beta and the new
    #      search direction are formed AFTER the gather, so the rz dot
    #      product rides the same collective as the direction vectors;
    #   B: psum([off-diagonal H p partial | p.Hp partial]) — the matvec
    #      reduction and the alpha dot product fused.
    # The convergence test uses the rz of the PREVIOUS iteration (one-lag
    # exit: at most one extra iteration, no extra collective).
    x0 = jnp.zeros((kn, 6), b.dtype)
    r0 = sl(b) * m_sl
    z0 = apply_p(r0)
    rz_part0 = jnp.sum(r0 * z0)
    rz0 = jax.lax.psum(rz_part0, axis)
    floor = jnp.maximum(rel_tol * rel_tol * rz0, tol)

    def cond(c):
        _, _, _, _, _, rz_prev, it = c
        return (it < iters) & (rz_prev > floor)

    def body(c):
        x, r, z, p_prev, rz_part, rz_prev, it = c
        # A: gather direction ingredients + the rz reduction in one ride
        packed = jnp.concatenate(
            [z, p_prev, jnp.full((kn, 1), rz_part / kn, b.dtype)], axis=1)
        gathered = jax.lax.all_gather(packed, axis, axis=0, tiled=True)
        z_full = gathered[:, :6]
        p_prev_full = gathered[:, 6:12]
        rz = jnp.sum(gathered[:, 12])
        beta = jnp.where(it == 0, 0.0, rz / jnp.maximum(rz_prev, 1e-30))
        p_full = z_full + beta * p_prev_full
        p = z + beta * p_prev
        # B: matvec off-diagonal partial + the diag-term dot partial fused
        # into one psum; after it, off is replicated so the p.Hp
        # off-diagonal dot is local on every device.
        ui = jnp.einsum("eab,eb->ea", lin.bij, p_full[lin.ej])
        uj = jnp.einsum("eab,ea->eb", lin.bij, p_full[lin.ei])
        off = jax.ops.segment_sum(ui, lin.ei, num_segments=K)
        off = off + jax.ops.segment_sum(uj, lin.ej, num_segments=K)
        diag_term = jnp.einsum("kab,kb->ka", diag_sl, p) + damp_sl * p
        pHp_diag_part = jnp.sum(p * diag_term)
        red = jnp.concatenate(
            [off, jnp.full((K, 1), pHp_diag_part / K, b.dtype)], axis=1)
        red = jax.lax.psum(red, axis)
        off_full = red[:, :6]
        Hp = (sl(off_full) + diag_term) * m_sl
        pHp = jnp.sum(p_full * off_full) + jnp.sum(red[:, 6])
        alpha = rz / jnp.maximum(pHp, 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z = apply_p(r)
        rz_part_new = jnp.sum(r * z)
        return (x, r, z, p, rz_part_new, rz, it + 1)

    x_sl, _, _, _, _, _, _ = jax.lax.while_loop(
        cond, body, (x0, r0, z0, jnp.zeros((kn, 6), b.dtype), rz_part0,
                     rz0, 0))
    return jax.lax.all_gather(x_sl, axis, axis=0, tiled=True)


def _pcg(hvp, b, precond_inv, mask, iters: int, tol: float = 1e-8,
         rel_tol: float = 1e-2):
    """Block-Jacobi preconditioned CG on H dx = b (masked nodes pinned to 0).

    Early exit on ``rz < rel_tol^2 * rz_initial`` (inexact-Newton forcing:
    the LM outer loop relinearizes anyway, so solving the inner system past
    ~1e-2 relative residual buys nothing) or the absolute floor ``tol``.
    Collective-free: since the block-sparse normal equations are replicated
    (see ``_linearize_full``), the whole solve is local to every device.
    """
    m = mask[:, None].astype(b.dtype)

    def apply_p(r):
        return jnp.einsum("kab,kb->ka", precond_inv, r) * m

    x0 = jnp.zeros_like(b)
    r0 = b * m
    z0 = apply_p(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    floor = jnp.maximum(rel_tol * rel_tol * rz0, tol)

    def cond(c):
        _, r, _, _, rz, it = c
        return (it < iters) & (rz > floor)

    def body(c):
        x, r, z, p, rz, it = c
        Hp = hvp(p) * m
        alpha = rz / jnp.maximum(jnp.sum(p * Hp), 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z = apply_p(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, z, p, rz_new, it + 1)

    x, _, _, _, _, _ = jax.lax.while_loop(cond, body, (x0, r0, z0, p0, rz0, 0))
    return x


def solve_impl(g: PoseGraph, max_iters: int = 10, cg_iters: int = 64,
               lambda0: float = 1e-4, axis: str | None = None,
               shard_cg: bool = False, shard_lin: bool = False) -> SolveResult:
    """Levenberg-Marquardt with PCG inner solves (trace-time body).

    Per LM iteration: solve the damped normal equations of the CARRIED
    linearization by PCG, apply the trial update ``T_k exp(dx_k)``, then
    linearize AT THE TRIAL — one fused linearize+cost evaluation — and
    accept iff the chi2 drops (lambda /= 4, keep the trial's linearization)
    else reject (lambda *= 8, keep the carried one). Matches iSAM2's role —
    a few fast damped GN steps warm-started from the current estimate —
    without its Bayes-tree machinery.

    With ``axis`` set this runs SPMD inside shard_map: edge tensors are this
    shard's partition, poses replicated. ``shard_cg`` picks the
    distribution mode (see ``_linearize_full``): False = replicated CG,
    1 + lm_iters collectives per solve (high-latency links); True = the CG
    matvec, block-Jacobi inversion and linearize reductions are all sharded
    — collectives per solve grow to ~lm_iters * (2 + cg_iters) but NO O(E)
    or O(K) dense work is replicated, which is what scales when
    collectives are cheap (and on the shared-core virtual-device harness,
    where replicated work
    multiplies real CPU load — the round-3 curve inverted past N=2 for
    exactly that reason).
    """
    eye = jnp.broadcast_to(jnp.eye(6, dtype=g.poses.dtype), (g.poses.shape[0], 6, 6))
    lin0 = _linearize_full(g, g.poses, axis, shard_cg, shard_lin)
    # shard_lin gathers the FULL system every linearization, so the inner
    # solve (hvp, preconditioner, CG) is replicated and collective-free
    inner_axis = None if shard_lin else axis
    K = g.poses.shape[0]
    n_dev = (jax.lax.axis_size(axis) if axis is not None and shard_cg
             else 1)

    def _precond_inv(damped_diag):
        if axis is None or not shard_cg or K % n_dev != 0 or n_dev == 1:
            return jnp.linalg.inv(damped_diag)
        # shard the K 6x6 inversions over the mesh, one tiled all_gather
        me = jax.lax.axis_index(axis)
        kn = K // n_dev
        sl = jax.lax.dynamic_slice_in_dim(damped_diag, me * kn, kn)
        return jax.lax.all_gather(jnp.linalg.inv(sl), axis, axis=0,
                                  tiled=True)

    use_dense = axis is None and K <= DENSE_SOLVE_MAX_K

    def _expand_lin(lin: _Lin) -> _Lin:
        """shard_lin: gather this shard's accepted off-diagonal blocks so
        the CG below runs replicated and collective-free. One all_gather
        per LM iteration; the LM carry keeps the LOCAL blocks."""
        packed = jnp.concatenate([
            lin.bij.reshape(-1, 36),
            lin.ei.astype(jnp.float32)[:, None],   # exact < 2^24
            lin.ej.astype(jnp.float32)[:, None],
        ], axis=1)
        packed = jax.lax.all_gather(packed, axis, axis=0, tiled=True)
        return lin._replace(
            bij=packed[:, :36].reshape(-1, 6, 6),
            ei=packed[:, 36].astype(jnp.int32),
            ej=packed[:, 37].astype(jnp.int32))

    def lm_body(carry):
        poses, lam, lin, it, accepted = carry
        damped_diag = lin.diag + lam * (
            lin.diag * jnp.broadcast_to(jnp.eye(6, dtype=lin.diag.dtype),
                                        lin.diag.shape)
        ) + 1e-8 * eye
        if use_dense:
            dx = _dense_lm_solve(lin, damped_diag, lin.grad, g.kf_mask)
        elif (axis is not None and shard_cg and not shard_lin
                and K % n_dev == 0 and n_dev > 1):
            # fully-sharded inner solve: vectors, matvec, preconditioner
            # all K/E-sharded — nothing O(K)/O(E) replicated
            dx = _pcg_ksharded(lin, lam, damped_diag, g.kf_mask, cg_iters,
                               axis)
        else:
            precond_inv = _precond_inv(damped_diag)
            cg_lin = _expand_lin(lin) if shard_lin else lin
            hvp = _make_hvp(cg_lin, lam, inner_axis,
                            shard_cg and not shard_lin)
            dx = _pcg(hvp, -lin.grad, precond_inv, g.kf_mask, cg_iters)

        trial = geo.pose_compose(poses, geo.se3_exp(dx))
        trial = geo.reorthonormalize(trial)
        trial = jnp.where(g.kf_mask[:, None, None], trial, poses)
        lin_t = _linearize_full(g, trial, axis, shard_cg, shard_lin)
        accept = lin_t.cost < lin.cost
        poses = jnp.where(accept, trial, poses)
        lin = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), lin_t, lin)
        lam = jnp.where(accept, lam * 0.25, lam * 8.0)
        lam = jnp.clip(lam, 1e-9, 1e6)
        return poses, lam, lin, it + 1, accepted + accept.astype(jnp.int32)

    def lm_cond(carry):
        _, lam, _, it, _ = carry
        return (it < max_iters) & (lam < 1e5)

    init = (g.poses, jnp.asarray(lambda0, g.poses.dtype), lin0, jnp.int32(0),
            jnp.int32(0))
    poses, _, lin, iters, accepted = jax.lax.while_loop(lm_cond, lm_body, init)
    return SolveResult(poses, lin0.cost, lin.cost, iters, accepted)


@partial(jax.jit, static_argnames=("max_iters", "cg_iters"))
def solve(g: PoseGraph, max_iters: int = 10, cg_iters: int = 64,
          lambda0: float = 1e-4) -> SolveResult:
    """Single-device jitted LM+PCG solve (see ``solve_impl``)."""
    return solve_impl(g, max_iters, cg_iters, lambda0)
