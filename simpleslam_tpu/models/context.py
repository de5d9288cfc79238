"""Place-recognition context plugin API (reference ContextBase family).

Parity with ``backend/include/backend/ContextBase.hpp:19-39`` — an
any-typed descriptor plugin with ``addContext(source)``, ``query(id) ->
QueryResult`` and save/load hooks — plus the two concrete plugins the
reference ships:

- **ScanContext** (``backend/src/ScanContext.cpp:56-278``): polar BEV
  max-height descriptors; the tensor kernels live in ``ops/scancontext.py``,
  this class owns the fixed-capacity device database and the query gate.
- **DistContext** (``backend/src/DistContext.cpp:14-31``): the reference's
  2D-translation-distance context is a stub whose ``query`` always returns
  -1; here it is completed to a working (if weak) baseline: candidates are
  past keyframes within ``distThres`` meters of the query position,
  excluding the ``numExcludeRecent`` newest — useful as a cheap geometric
  prior and as the simplest plugin example.

Plugins are selected by ``backend.context.used`` in the config; the
``LoopClosureManager`` talks only to this interface.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax.numpy as jnp
import numpy as np

import jax

from ..ops import pointcloud as pcops
from ..ops import scancontext as sc
from ..utils.config import Params
from ..utils.logging import Logger

# donated in-place row setters for the descriptor database: appending a
# context must not reallocate+copy the whole (cap, 20, 60) store per keyframe
_set_desc = jax.jit(lambda buf, i, row: buf.at[i].set(row), donate_argnums=0)


# fused ingest: descriptor build + both row-sets in ONE dispatch instead of
# three, each paying its own dispatch overhead for ~0 compute.
@partial(jax.jit, donate_argnums=(0, 1))
def _ingest(descs, ring_keys, i, xyz, mask, lidar_height):
    d = sc.make_descriptor(xyz, mask, lidar_height)
    return descs.at[i].set(d), ring_keys.at[i].set(sc.ring_key(d))


# store-side ingest: ONE dispatch builds up to _CTX_CHUNK descriptors
# straight from the device-resident keyframe store (pipeline/streamed.py
# uploads each keyframe cloud exactly once) — the host-cloud path re-ships
# ~96 KB per context over the link for data the device already holds.
@partial(jax.jit, donate_argnums=(0, 1))
def _ingest_from_store(descs, ring_keys, store, row_idx, ctx_idx, val,
                       lidar_height):
    cap = descs.shape[0]

    def body(k, carry):
        de, rk = carry
        xyz = store[row_idx[k]]
        mask = (xyz[:, 0] < 0.5 * pcops.PAD_COORD) & val[k]
        d = sc.make_descriptor(xyz, mask, lidar_height)
        i = jnp.where(val[k], ctx_idx[k], cap)  # cap = OOB -> dropped
        de = de.at[i].set(d, mode="drop")
        rk = rk.at[i].set(sc.ring_key(d), mode="drop")
        return de, rk

    return jax.lax.fori_loop(0, row_idx.shape[0], body, (descs, ring_keys))


# Batched retrieval: a keyframe EVENT usually carries several new contexts
# (the backend coalesces keyframes that landed since its last pass), and each
# scalar query costs a blocking link round-trip for its 3-scalar result. One
# chunked dispatch + ONE fetch serves up to _CTX_CHUNK of them — fixed chunk
# shape so only one program ever compiles; invalid lanes return idx -1.
# Ingest stays scalar: its dispatches are async (nothing fetched), and a
# padded batch upload would ship _CTX_CHUNK full clouds for an event that
# typically adds two.
_CTX_CHUNK = 8


@partial(jax.jit, static_argnames=("num_candidates",))
def _query_batch(descs, ring_keys, qids, val, num_exclude_recent, dist_thres,
                 num_candidates: int = 10):
    q = jax.vmap(lambda i: sc.query(descs, ring_keys, i, num_exclude_recent,
                                    dist_thres,
                                    num_candidates=num_candidates))(qids)
    idx = jnp.where(val, q.idx, -1)
    return jnp.stack([idx.astype(jnp.float32), q.yaw, q.min_dist], axis=1)


# one packed fetch for query results (3 scalars -> 1 link round-trip)
_pack_query = jax.jit(lambda q: jnp.stack(
    [q.idx.astype(jnp.float32), q.yaw, q.min_dist]))


class QueryResult(NamedTuple):
    """Matched context id (or -1) + yaw alignment hint (ContextBase.hpp:24-27)."""

    idx: int
    yaw: float
    min_dist: float


class ContextBase:
    """Descriptor plugin API (ContextBase.hpp:19-39).

    ``add_context`` ingests one keyframe source (xyz cloud + pose);
    ``query(id)`` matches context ``id`` against strictly older contexts.
    """

    def __init__(self) -> None:
        self.n_contexts = 0

    def add_context(self, xyz: np.ndarray, pose: np.ndarray) -> None:
        raise NotImplementedError

    def query(self, qid: int) -> QueryResult:
        raise NotImplementedError

    # batched forms — default to the scalar calls; device-database plugins
    # override them to coalesce a keyframe event's contexts into single
    # dispatches (each scalar call is a link round-trip)
    def add_contexts(self, items) -> None:
        for xyz, pose in items:
            self.add_context(xyz, pose)

    def query_many(self, qids) -> "list[QueryResult]":
        return [self.query(q) for q in qids]

    # persistence hooks (stubs in the reference too, ContextBase.hpp:35-38)
    def save_context(self, path: str) -> None:
        pass

    def load_context(self, path: str) -> None:
        pass


class ScanContext(ContextBase):
    """Fixed-capacity device database of ScanContext descriptors."""

    def __init__(self) -> None:
        super().__init__()
        cfg = Params.get_instance()
        sc_cfg = cfg["backend"]["context"]["scancontext"]
        self.lg = Logger.get_instance()
        self.num_exclude_recent = int(sc_cfg["numExcludeRecent"])
        self.num_candidates = int(sc_cfg["numCandidatesFromTree"])
        self.dist_thres = float(sc_cfg["scDistThres"])
        self.lidar_height = float(cfg["tf"]["lidar_height"])
        self._cap = int(cfg["tpu"]["max_keyframes"])
        self._pc_capacity = int(cfg["tpu"]["ds_scan_capacity"])
        self.descs = jnp.zeros((self._cap, sc.NUM_RING, sc.NUM_SECTOR), jnp.float32)
        self.ring_keys = jnp.zeros((self._cap, sc.NUM_RING), jnp.float32)

    def add_context(self, xyz: np.ndarray, pose: np.ndarray) -> None:
        if self.n_contexts >= self._cap:
            self.lg.error("context capacity (%d) exceeded!", self._cap)
            return
        pc = pcops.from_numpy(xyz, self._pc_capacity)
        i = self.n_contexts
        self.descs, self.ring_keys = _ingest(
            self.descs, self.ring_keys, jnp.int32(i), pc.xyz, pc.mask,
            jnp.float32(self.lidar_height))
        self.n_contexts = i + 1

    def query(self, qid: int) -> QueryResult:
        q = sc.query(self.descs, self.ring_keys, jnp.int32(qid),
                     jnp.int32(self.num_exclude_recent),
                     jnp.float32(self.dist_thres),
                     num_candidates=self.num_candidates)
        idx, yaw, min_dist = np.asarray(_pack_query(q))  # one fetch
        return QueryResult(int(idx), float(yaw), float(min_dist))

    def add_contexts_from_store(self, store, kf_indices) -> None:
        """Batched device-side ingest from the resident keyframe store:
        ONE dispatch per _CTX_CHUNK new keyframes, zero cloud upload."""
        idx = list(kf_indices)
        for lo in range(0, len(idx), _CTX_CHUNK):
            chunk = idx[lo: lo + _CTX_CHUNK]
            rows = np.zeros(_CTX_CHUNK, np.int32)
            cids = np.zeros(_CTX_CHUNK, np.int32)
            val = np.zeros(_CTX_CHUNK, bool)
            for c, kf_i in enumerate(chunk):
                if self.n_contexts >= self._cap:
                    self.lg.error("context capacity (%d) exceeded!",
                                  self._cap)
                    break
                rows[c] = kf_i
                cids[c] = self.n_contexts
                val[c] = True
                self.n_contexts += 1
            self.descs, self.ring_keys = _ingest_from_store(
                self.descs, self.ring_keys, store, jnp.asarray(rows),
                jnp.asarray(cids), jnp.asarray(val),
                jnp.float32(self.lidar_height))

    def query_dispatch(self, qids):
        """Dispatch the chunked retrievals WITHOUT fetching — returns an
        opaque handle for ``query_collect``. Lets the caller overlap the
        retrieval's link round-trip with other blocking fetches (the
        backend's solve fetch)."""
        pend = []
        for lo in range(0, len(qids), _CTX_CHUNK):
            chunk = list(qids[lo: lo + _CTX_CHUNK])
            ids = np.zeros(_CTX_CHUNK, np.int32)
            val = np.zeros(_CTX_CHUNK, bool)
            for c, q in enumerate(chunk):
                ids[c] = q
                val[c] = True
            arr = _query_batch(
                self.descs, self.ring_keys, jnp.asarray(ids),
                jnp.asarray(val), jnp.int32(self.num_exclude_recent),
                jnp.float32(self.dist_thres),
                num_candidates=self.num_candidates)
            pend.append((len(chunk), arr))
        return pend

    @staticmethod
    def query_collect(pend) -> "list[QueryResult]":
        out: list[QueryResult] = []
        for n, arr in pend:
            packed = np.asarray(arr)
            for c in range(n):
                out.append(QueryResult(int(packed[c, 0]), float(packed[c, 1]),
                                       float(packed[c, 2])))
        return out

    def query_many(self, qids) -> "list[QueryResult]":
        """Chunked batch query: one dispatch + ONE fetch per _CTX_CHUNK ids."""
        return self.query_collect(self.query_dispatch(qids))

    @staticmethod
    def _npy_path(path: str) -> str:
        # np.save appends '.npy' to bare paths but np.load does not — a
        # save/load round-trip on the same bare path would FileNotFoundError;
        # normalize once for both directions (advisor finding, round 1)
        return path if path.endswith(".npy") else path + ".npy"

    def save_context(self, path: str) -> None:
        np.save(self._npy_path(path), np.asarray(self.descs[: self.n_contexts]))

    def load_context(self, path: str) -> None:
        arr = np.load(self._npy_path(path))
        n = min(len(arr), self._cap)
        self.descs = self.descs.at[:n].set(jnp.asarray(arr[:n]))
        self.ring_keys = self.ring_keys.at[:n].set(
            sc.ring_key(jnp.asarray(arr[:n])))
        self.n_contexts = n


class DistContext(ContextBase):
    """2D-translation-distance context (DistContext.cpp:14-31, completed).

    The reference's version stores (x, y) per keyframe but leaves ``query``
    unimplemented (returns -1). Here the natural completion: nearest past
    keyframe within ``distThres`` m in the xy-plane, skipping the most
    recent ``numExcludeRecent``. No yaw hint (0.0).
    """

    def __init__(self, dist_thres: float = 5.0,
                 num_exclude_recent: Optional[int] = None) -> None:
        super().__init__()
        cfg = Params.get_instance()
        sc_cfg = cfg["backend"]["context"]["scancontext"]
        self.dist_thres = float(
            cfg["backend"]["context"].get("distcontext", {}).get(
                "distThres", dist_thres))
        self.num_exclude_recent = (
            num_exclude_recent if num_exclude_recent is not None
            else int(sc_cfg["numExcludeRecent"]))
        self._xy: list = []

    def add_context(self, xyz: np.ndarray, pose: np.ndarray) -> None:
        self._xy.append(np.asarray(pose[:2, 3], np.float64))
        self.n_contexts = len(self._xy)

    def query(self, qid: int) -> QueryResult:
        allowed = qid - self.num_exclude_recent
        if allowed <= 0:
            return QueryResult(-1, 0.0, float("inf"))
        past = np.stack(self._xy[:allowed])
        d = np.linalg.norm(past - self._xy[qid][None, :], axis=1)
        best = int(np.argmin(d))
        if d[best] < self.dist_thres:
            return QueryResult(best, 0.0, float(d[best]))
        return QueryResult(-1, 0.0, float(d[best]))


def make_context(kind: Optional[str] = None) -> ContextBase:
    """Config-driven plugin factory (``backend.context.used``)."""
    if kind is None:
        kind = Params.get_instance()["backend"]["context"].get(
            "used", "scancontext")
    if kind == "scancontext":
        return ScanContext()
    if kind == "distcontext":
        return DistContext()
    raise ValueError(f"unknown context plugin: {kind}")
