"""Loop-closure detection + verification (reference LoopClosureManager).

Parity with ``backend/src/LoopClosureManager.cpp:11-127``:
- ``add_context``: for each new keyframe, voxel-downsample its cloud at
  ``contextDownSampleGridSize`` and append a ScanContext descriptor (:28-37);
- ``lc_handler_once``: for each unprocessed context, ScanContext query ->
  candidate keyframe; build a history submap of ``+-historySubmapRange``
  neighbor keyframes transformed into the map frame and downsampled (:40-60);
  verify by VGICP with the loosened LC parameters; accept when converged and
  fitness < ``fitnessThreshold``; push an ``LCResult`` and fire the LC event
  (:62-119).

Deliberate fix over the reference: the accepted between-measurement uses the
**VGICP-refined** pose, ``between = old_pose^-1 * refined``. The reference
computes ``old_pose.inverse() * cur_pose`` from the *unrefined* current
estimate (LoopClosureManager.cpp:108) — a factor whose residual is zero at
the current estimate, i.e. no correction signal (consistent with its README
benchmarking LC disabled). A loop closure that actually closes loops needs
the refined pose.

The place-recognition descriptor is a plugin (``models/context.py`` —
ScanContext by default, selected by ``backend.context.used``), mirroring the
reference's ``ContextBase`` polymorphism (LoopClosureManager.hpp:17-76).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .. import native
from ..ops import pointcloud as pcops
from ..utils.concurrency import SafeDeque
from ..utils.config import Params
from ..utils.logging import Logger
from .context import make_context
from .mapmanager import MapManager
from .registration import VgicpRegister


@dataclass
class LCResult:
    from_idx: int
    to_idx: int
    between: np.ndarray  # (4, 4): T_from^-1 * T_to_refined


# Seed the verification init from the descriptor yaw hint when it disagrees
# with the current estimate by more than this (rad). The retrieval shift s
# implies yaw(query) = yaw(old) - s*sector_angle (ops/scancontext.py query);
# VGICP's loosened correspondence radius absorbs translation drift but not a
# large rotation error, so big-angle revisits need the hint. Below the
# threshold the odometry yaw is finer-grained than the 6 deg sector quantum.
YAW_SEED_THRESH = 0.35


def _wrap_angle(a: float) -> float:
    return float(np.arctan2(np.sin(a), np.cos(a)))


class LoopClosureManager:
    def __init__(self, map_manager: MapManager, context=None):
        cfg = Params.get_instance()
        lc_cfg = cfg["backend"]["lc"]
        self.lg = Logger.get_instance()
        self.map_manager = map_manager
        self.kf_obj = map_manager.kf_obj

        self.context_ds = float(lc_cfg["contextDownSampleGridSize"])
        self.history_range = int(lc_cfg["historySubmapRange"])
        self.fitness_thresh = float(lc_cfg["fitnessThreshold"])
        # Optional closure plausibility gate: reject accepted closures whose
        # implied correction ||refined - cur_pose|| exceeds this (meters).
        # 0 disables (reference behavior). Deployment-tuned like every LC
        # threshold: set it to a generous multiple of the expected drift
        # scale — a "verified" closure demanding a far larger correction is
        # a false positive (similar-looking structure), and one such edge
        # bends the whole graph.
        self.max_correction = float(lc_cfg.get("maxCorrectionMeters", 0.0))
        self.n_rejected_correction = 0

        self.context = context if context is not None else make_context()
        self.lc_size = 0  # processed watermark (lc_size_)

        self.register = VgicpRegister()
        self.register.init_for_lc()
        # accepted-closure queue: bounded (drop-oldest with counting) like
        # every inter-thread queue here, but sized for a whole dense-revisit
        # handler pass — one pass over a keyframe burst can accept more than
        # ten closures before the backend's next drain, and each entry is a
        # 4x4 + two ints (config: backend.lc.queueSize)
        self._lc_queue_cap = int(
            cfg["backend"]["lc"].get("queueSize", 128))
        self.lc_queue: SafeDeque[LCResult] = SafeDeque(self._lc_queue_cap)
        self._ctx_capacity = int(cfg["tpu"]["ds_scan_capacity"])
        # amortized verification: the history-submap target for a given
        # old_key is identical across candidates until any pose in its
        # window moves (a backend correction) — cache one build per
        # (old_key, window-pose fingerprint). At real revisit density many
        # consecutive queries hit the same map region, so this removes the
        # dominant per-candidate cost (the Gaussian-voxel map build).
        self._target_cache: dict = {}
        self._target_cache_max = 8
        self.dropped_closures = 0  # accepted-but-dropped (queue overflow)
        # detector funnel counters (observability: queries -> retrieval
        # candidates -> verifications -> accepts = n_lc_edges on the backend)
        self.n_queries = 0
        self.n_candidates = 0
        self.n_verify_converged = 0

    @property
    def n_contexts(self) -> int:
        return self.context.n_contexts

    def prewarm(self) -> None:
        """Compile (or cache-load) the verification programs up front.

        The VGICP verify chain (build_target + align + fitness) only
        compiles at the FIRST retrieval candidate — deep into a session, on
        the critical path (seconds of persistent-cache loads, more when
        cold). Run it once on synthetic data at the
        production capacities before the stream starts."""
        rng = np.random.default_rng(0)
        cap = int(Params.get_instance()["tpu"]["submap_capacity"])
        sub = rng.uniform(-20.0, 20.0, (4096, 3)).astype(np.float32)
        src = sub[:1024] + rng.normal(0.0, 0.02, (1024, 3)).astype(np.float32)
        target = self.register.build_target(
            pcops.from_numpy(sub, cap), jnp.zeros(3, jnp.float32))
        self.register.scan2map(
            pcops.from_numpy(src, self._ctx_capacity), target, np.eye(4))
        self.register.get_fitness_score()

    # -- context ingestion (LoopClosureManager.cpp:28-37; call under kf lock) --
    def add_context(self) -> None:
        kfs = self.kf_obj.keyframes
        n0 = self.context.n_contexts
        new = list(range(n0, len(kfs)))
        if not new:
            return
        # device-store fast path: keyframe clouds already live on the device
        # (row index == keyframe index, pipeline/streamed.py), so the
        # descriptor ingest needs no cloud upload at all. Valid when the
        # context's own downsample grid matches the stored clouds' grid
        # (they are the same prep output then).
        store = getattr(self.map_manager, "_kf_store", None)
        cfg = Params.get_instance()
        grid_ok = abs(self.context_ds
                      - float(cfg["downSampleVoxelGridSize"])) < 1e-9
        if (store is not None and grid_ok
                and hasattr(self.context, "add_contexts_from_store")):
            # dispatch under the store lock: the main thread's donated row
            # updates must not invalidate the handle mid-dispatch
            with self.map_manager.kf_store_lock:
                self.context.add_contexts_from_store(
                    self.map_manager._kf_store, new)
            return
        items = [(native.voxel_downsample_first(kfs[i].xyz, self.context_ds),
                  kfs[i].pose) for i in new]
        if items:  # one chunked dispatch for the whole event's new contexts
            self.context.add_contexts(items)

    # -- retrieval overlap (no reference counterpart: link-latency hiding) ----
    def dispatch_queries(self) -> None:
        """Dispatch the new contexts' retrievals WITHOUT fetching, so the
        round-trip overlaps the backend's blocking solve fetch; the next
        ``lc_handler_once`` collects the in-flight results."""
        new_ids = list(range(self.lc_size, self.n_contexts))
        if new_ids and hasattr(self.context, "query_dispatch"):
            self._pending_queries = (new_ids,
                                     self.context.query_dispatch(new_ids))

    # -- history submap (LoopClosureManager.cpp:40-60; call under kf lock) -----
    def _history_submap(self, key: int) -> np.ndarray:
        kfs = self.kf_obj.keyframes
        sel = [i for i in range(key - self.history_range,
                                key + self.history_range + 1)
               if 0 <= i < len(kfs)]
        merged = native.transform_concat(
            [kfs[i].xyz for i in sel],
            np.stack([kfs[i].pose for i in sel]) if sel else np.zeros((0, 4, 4)))
        return native.voxel_downsample_first(merged, self.context_ds)

    # -- detection pass (LoopClosureManager.cpp:62-119) ------------------------
    def lc_handler_once(self) -> int:
        """Process all new contexts; returns the number of accepted closures."""
        accepted = 0
        new_ids = list(range(self.lc_size, self.n_contexts))
        if not new_ids:
            return 0  # nothing new: skip the retrieval dispatch round-trip
        # one chunked dispatch + fetch for ALL new contexts' retrievals
        # (each scalar query costs a full link round-trip); an overlapped
        # pre-dispatch from ``dispatch_queries`` is collected if it covers
        # exactly these ids
        pend = getattr(self, "_pending_queries", None)
        self._pending_queries = None
        if pend is not None and pend[0] == new_ids:
            queries = self.context.query_collect(pend[1])
        else:
            queries = self.context.query_many(new_ids)
        self.n_queries += len(new_ids)
        for i, q in zip(new_ids, queries):
            old_key = q.idx
            if old_key < 0:
                continue
            self.n_candidates += 1
            self.lg.info("%d to %d min dist: %.4f", i, old_key, q.min_dist)

            with self.kf_obj.lock:
                kfs = self.kf_obj.keyframes
                old_pose = kfs[old_key].pose.copy()
                cur_pose = kfs[i].pose.copy()
                scan_xyz = kfs[i].xyz
                sel = [k for k in range(old_key - self.history_range,
                                        old_key + self.history_range + 1)
                       if 0 <= k < len(kfs)]
                fprint = np.stack([kfs[k].pose for k in sel]).tobytes()
                cached = self._target_cache.get(old_key)
                submap = (None if cached is not None and cached[0] == fprint
                          else self._history_submap(old_key))

            if submap is None:
                target = cached[1]
            else:
                cap = int(Params.get_instance()["tpu"]["submap_capacity"])
                if len(submap) > cap:
                    self.lg.warn("LC submap truncated: %d > capacity %d",
                                 len(submap), cap)
                sub_pc = pcops.from_numpy(submap, cap)
                target = self.register.build_target(
                    sub_pc, jnp.asarray(old_pose[:3, 3].astype(np.float32)))
                if len(self._target_cache) >= self._target_cache_max:
                    self._target_cache.pop(next(iter(self._target_cache)))
                self._target_cache[old_key] = (fprint, target)
            # yaw-hint seeding: rotate the init about z so the relative yaw
            # matches the descriptor alignment for large-angle revisits
            init_pose = cur_pose
            psi_old = np.arctan2(old_pose[1, 0], old_pose[0, 0])
            psi_cur = np.arctan2(cur_pose[1, 0], cur_pose[0, 0])
            dpsi = _wrap_angle(psi_old - q.yaw - psi_cur)
            if abs(dpsi) > YAW_SEED_THRESH:
                c, s = np.cos(dpsi), np.sin(dpsi)
                rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
                init_pose = cur_pose.copy()
                init_pose[:3, :3] = rz @ cur_pose[:3, :3]
                self.lg.info("yaw-hint seed: rotating LC init by %.2f rad",
                             dpsi)

            src = pcops.from_numpy(scan_xyz, self._ctx_capacity)
            refined, conv = self.register.scan2map(src, target, init_pose)
            fs = self.register.get_fitness_score()
            self.lg.info("%d to %d fitness score: %.4f (conv=%s)",
                         old_key, i, fs, conv)
            self.n_verify_converged += bool(conv)
            if conv and fs < self.fitness_thresh:
                corr = float(np.linalg.norm(refined[:3, 3] - cur_pose[:3, 3]))
                if self.max_correction > 0 and corr > self.max_correction:
                    self.n_rejected_correction += 1
                    self.lg.warn(
                        "rejecting closure %d->%d: implied correction "
                        "%.2f m > %.2f m gate", old_key, i, corr,
                        self.max_correction)
                    continue
                between = np.linalg.inv(old_pose) @ refined
                if len(self.lc_queue) >= self._lc_queue_cap:
                    # drop-oldest overflow loses an ACCEPTED factor — count
                    # and log it instead of silently shrinking the graph
                    # (the backend drains this queue on the next LC event,
                    # so sustained overflow means the backend is lagging)
                    self.dropped_closures += 1
                    self.lg.error(
                        "LC queue overflow: dropping oldest accepted "
                        "closure (%d dropped so far)", self.dropped_closures)
                self.lc_queue.push_back(LCResult(old_key, i, between), block=False)
                accepted += 1

        self.lc_size = self.n_contexts
        if accepted:
            self.kf_obj.lc_is_happening()
        return accepted


