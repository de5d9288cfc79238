"""ScanContext place-recognition descriptor as pure tensor code.

Re-architecture of the reference's ScanContext plugin
(``backend/src/ScanContext.cpp:56-278``, itself adapted from the IROS'18
code): the polar BEV max-height descriptor becomes one scatter-max, ring-key
retrieval becomes a brute-force distance + top-k (a 20-dim kd-tree over a few
thousand keys is pointless on a device — one (N,20) matmul-shaped reduction
replaces it), and the circular-shift alignment search becomes a batched roll + cosine
column distance evaluated for ALL 60 shifts at once.

Deviations from the reference, both strictly-better simplifications:
- the reference narrows the shift search to ``argmin(sector-key shift) +-
  searchRatio*60/2`` (ScanContext.cpp:120-134) as a CPU shortcut; we evaluate
  every shift in one vectorized pass (finds the global minimum);
- the reference rebuilds its ring-key kd-tree only every ``buildTreeGap``
  queries, searching a stale database between rebuilds (ScanContext.cpp:237-245);
  brute force is always fresh.
Candidate eligibility (exclude ``numExcludeRecent`` newest; query only fires
once ``id > numExcludeRecent + numCandidates``) matches the reference.

Constants (ScanContext.hpp:17-19): 20 rings x 60 sectors, 80 m radius.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

NUM_RING = 20
NUM_SECTOR = 60
MAX_RADIUS = 80.0
SECTOR_ANGLE_RAD = 2.0 * jnp.pi / NUM_SECTOR


@partial(jax.jit, static_argnames=())
def make_descriptor(xyz: jax.Array, mask: jax.Array,
                    lidar_height: float | jax.Array = 2.0) -> jax.Array:
    """(N, 3) sensor-frame points -> (20, 60) polar max-height descriptor.

    Parity with ``makeScanContext`` (ScanContext.cpp:152-195): z is shifted
    by the lidar height, range > 80 m is dropped, bin indices are
    ``clamp(ceil(frac * bins), 1, bins) - 1``, empty bins are 0.
    """
    x, y = xyz[:, 0], xyz[:, 1]
    z = xyz[:, 2] + lidar_height
    rng = jnp.sqrt(x * x + y * y)
    theta = jnp.arctan2(y, x)  # xy2theta: [0, 2pi)
    theta = jnp.where(theta < 0, theta + 2 * jnp.pi, theta)

    valid = mask & (rng <= MAX_RADIUS)
    ring = jnp.clip(jnp.ceil(rng / MAX_RADIUS * NUM_RING), 1, NUM_RING) - 1
    sector = jnp.clip(jnp.ceil(theta / (2 * jnp.pi) * NUM_SECTOR), 1, NUM_SECTOR) - 1
    flat = (ring * NUM_SECTOR + sector).astype(jnp.int32)
    flat = jnp.where(valid, flat, NUM_RING * NUM_SECTOR)

    # scatter-max of z; empty bins stay at 0 (the reference's NO_POINT reset)
    desc = jnp.full((NUM_RING * NUM_SECTOR,), -jnp.inf, xyz.dtype).at[flat].max(
        jnp.where(valid, z, -jnp.inf), mode="drop"
    )
    desc = jnp.where(jnp.isfinite(desc), desc, 0.0)
    return desc.reshape(NUM_RING, NUM_SECTOR)


def ring_key(desc: jax.Array) -> jax.Array:
    """Row-wise means, the rotation-invariant retrieval key (..., 20)."""
    return jnp.mean(desc, axis=-1)


def sector_key(desc: jax.Array) -> jax.Array:
    """Column-wise means (kept for API parity; retrieval here evaluates all
    shifts so the sector-key prealign is unnecessary) (..., 60)."""
    return jnp.mean(desc, axis=-2)


def _all_shift_distances(sc1: jax.Array, sc2: jax.Array) -> jax.Array:
    """Cosine column distance of sc1 vs every circular shift of sc2 -> (60,).

    Matches ``computeSimularity`` (ScanContext.cpp:69-93): per-column cosine
    similarity, columns where either side is all-zero are excluded, distance
    = 1 - mean similarity.
    """
    shifts = jnp.arange(NUM_SECTOR)
    # sc2 shifted right by s: column c of shifted = column (c - s) mod 60
    idx = (jnp.arange(NUM_SECTOR)[None, :] - shifts[:, None]) % NUM_SECTOR
    sc2_sh = sc2[:, idx]                       # (20, 60shift, 60col) -> transpose
    sc2_sh = jnp.transpose(sc2_sh, (1, 0, 2))  # (60shift, 20, 60)

    dots = jnp.einsum("rc,src->sc", sc1, sc2_sh)
    n1 = jnp.linalg.norm(sc1, axis=0)                  # (60,)
    n2 = jnp.linalg.norm(sc2_sh, axis=1)               # (60shift, 60)
    eff = (n1[None, :] > 0) & (n2 > 0)
    sim = jnp.where(eff, dots / jnp.maximum(n1[None, :] * n2, 1e-12), 0.0)
    cnt = jnp.maximum(jnp.sum(eff, axis=1), 1)
    return 1.0 - jnp.sum(sim, axis=1) / cnt


def distance_between(sc1: jax.Array, sc2: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(min distance, argmin shift) over all 60 shifts (distanceBtnScanContext)."""
    d = _all_shift_distances(sc1, sc2)
    a = jnp.argmin(d)
    return d[a], a


class QueryResult(NamedTuple):
    idx: jax.Array       # () int32, matched context id or -1
    yaw: jax.Array       # () f32, yaw offset in rad (sector angle * shift)
    min_dist: jax.Array  # () f32


@partial(jax.jit, static_argnames=("num_candidates",))
def query(descs: jax.Array, ring_keys: jax.Array, qid: jax.Array,
          num_exclude_recent: jax.Array, dist_thres: jax.Array,
          num_candidates: int = 10) -> QueryResult:
    """Match context ``qid`` against contexts ``[0, qid - num_exclude_recent)``.

    descs: (Ncap, 20, 60) database (rows >= qid are ignored), ring_keys the
    matching (Ncap, 20). Mirrors ``ScanContext::query`` (ScanContext.cpp:228-278)
    with brute-force ring-key top-k.
    """
    ncap = descs.shape[0]
    q_ring = ring_keys[qid]
    allowed_n = qid - num_exclude_recent
    eligible = qid > num_exclude_recent + num_candidates

    rows = jnp.arange(ncap)
    allowed = rows < allowed_n
    d2 = jnp.sum((ring_keys - q_ring[None, :]) ** 2, axis=-1)
    d2 = jnp.where(allowed, d2, jnp.inf)
    _, cand = jax.lax.top_k(-d2, num_candidates)          # (C,)
    cand_ok = jnp.isfinite(d2[cand])

    q_desc = descs[qid]
    dists, shifts = jax.vmap(lambda c: distance_between(q_desc, descs[c]))(cand)
    dists = jnp.where(cand_ok, dists, jnp.inf)
    best = jnp.argmin(dists)
    min_dist = dists[best]
    ok = eligible & (min_dist < dist_thres)
    idx = jnp.where(ok, cand[best], -1)
    yaw = jnp.where(ok, SECTOR_ANGLE_RAD * shifts[best].astype(jnp.float32), 0.0)
    return QueryResult(idx.astype(jnp.int32), yaw, min_dist)
