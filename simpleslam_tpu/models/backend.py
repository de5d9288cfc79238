"""Backend: keyframe pose-graph optimization + correction broadcast.

Re-architecture of the reference backend (``backend/src/Backend.cpp:29-360``)
with the GTSAM iSAM2 pimpl replaced by the framework's own batched LM+PCG
solver (``ops/posegraph.py``). Behavioral parity:

- prior factor on keyframe 0 (``addPrior``, Backend.cpp:85);
- odometry Between factors from the **nearest** keyframe at insertion time
  (not simply the previous one): ``from = mClosestKfIdx[...]`` recorded by
  ``MapManager::putKeyFrame`` (Backend.cpp:240-252);
- between measurement taken from the current estimates at insertion
  (``from.between(to)``, Backend.cpp:245);
- LC factors drained from the loop-closure queue (Backend.cpp:255-268);
- event-driven pass (``optimHandler``, Backend.cpp:270-346): NewKFCome ->
  add context + persist kfs + odom factors; LC -> loop factors; then solve,
  write back optimized poses, broadcast the rigid correction
  ``delta = kf_back_new * kf_back_old^-1`` to every GlobalOdom entry and to
  odom2map;
- factor-graph save/reload via g2o for remapping (Backend.cpp:125-222) and
  TUM trajectory save on shutdown (Backend.cpp:349-358).

Noise models (Backend.cpp:90-97, gtsam orders (rot, trans); our twist order
is (trans, rot)): variances
  prior: rot (1e-2, 1e-2, pi/72), trans (1e-1, 1e-1, 1e-1)
  odom:  rot 1e-4, trans 1e-1      lc: all 1e-1
"""

from __future__ import annotations

import math
import os
import threading
from functools import partial
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import posegraph as pgo
from ..utils import fileio
from ..utils.config import Params
from ..utils.logging import Logger
from .frontend import Frontend
from .mapmanager import KFEvent, MapManager

# diagonal variances in OUR ordering [trans(3), rot(3)]
PRIOR_VAR = np.array([1e-1, 1e-1, 1e-1, 1e-2, 1e-2, math.pi / 72])
ODOM_VAR = np.array([1e-1, 1e-1, 1e-1, 1e-4, 1e-4, 1e-4])
LC_VAR = np.array([1e-1, 1e-1, 1e-1, 1e-1, 1e-1, 1e-1])

# g2o info matrices order (trans, rot) like ours; gtsam reorders on its own
# load (Backend.cpp:186-190) — files interoperate both ways.

# Donated in-place row writes for the device-resident factor graph: per
# keyframe event only the NEW rows are uploaded (the iSAM2 incrementality
# role — per-event cost is O(new work), not O(capacity)). ALL new pose and
# edge rows of one event land in ONE fused dispatch instead of 7+ per-buffer
# setter dispatches, each with its own launch overhead. Rows come in
# fixed-size chunks (_SYNC_CHUNK) with a validity lane; invalid lanes write
# the row's current value back (duplicate identical writes are well-defined).
_SYNC_CHUNK = 8


@partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4, 5, 6))
def _write_rows(poses, kmask, ei, ej, eT, einfo, emask,
                kidx, krows, kval, eidx, eiv, ejv, eTv, einfov, evalv):
    poses = poses.at[kidx].set(
        jnp.where(kval[:, None, None], krows, poses[kidx]))
    kmask = kmask.at[kidx].set(kmask[kidx] | kval)
    ei = ei.at[eidx].set(jnp.where(evalv, eiv, ei[eidx]))
    ej = ej.at[eidx].set(jnp.where(evalv, ejv, ej[eidx]))
    eT = eT.at[eidx].set(jnp.where(evalv[:, None, None], eTv, eT[eidx]))
    einfo = einfo.at[eidx].set(
        jnp.where(evalv[:, None], einfov, einfo[eidx]))
    emask = emask.at[eidx].set(emask[eidx] | evalv)
    return poses, kmask, ei, ej, eT, einfo, emask

# Pack the whole solve result into ONE fixed-shape buffer so the host does a
# single fetch per event. Fetching `poses[:k]` instead would compile a new
# slice program for every new keyframe count (a per-event recompile) and cost
# 4 sync round-trips (poses + 3 logged scalars) over the device link.
_pack_solve = jax.jit(lambda poses, cost0, cost, iters: jnp.concatenate([
    poses.reshape(-1),
    jnp.stack([cost0, cost, iters.astype(jnp.float32)])]))


class Backend:
    def __init__(self, frontend: Frontend, map_manager: MapManager,
                 lcm=None):
        cfg = Params.get_instance()
        self.lg = Logger.get_instance()
        self.frontend = frontend
        self.map_manager = map_manager
        self.lcm = lcm
        self.kf_obj = map_manager.kf_obj
        self.save_map_dir: str = cfg["saveMapDir"]

        tpu = cfg["tpu"]
        self.k_cap = int(tpu["max_keyframes"])
        self.e_cap = int(tpu["max_edges"])
        # bucketed device capacities: the padded solve costs O(capacity) per
        # LM iteration, so a run with 30 keyframes must not pay for the
        # (max_keyframes, max_edges) envelope. Buckets grow x4 on demand
        # (rebuild + one recompile per growth — log4(max/min) times per run).
        self._k_bucket = min(int(tpu.get("kf_bucket", 128)), self.k_cap)
        self._e_bucket = min(int(tpu.get("edge_bucket", 512)), self.e_cap)
        # multi-device: solve the graph edge-sharded over the configured mesh
        # (the executor shards registration over the same devices; see
        # tpu.mesh_devices in utils/config.py)
        mesh_n = int(tpu.get("mesh_devices", 0))
        self._mesh = None
        self._sharded_solvers = {}
        if mesh_n:
            from ..parallel.mesh import make_mesh

            self._mesh = make_mesh(mesh_n, ("kf",))
            # edge buckets must split evenly over the mesh
            self._e_bucket = -(-self._e_bucket // mesh_n) * mesh_n

        # factor storage (host mirror for g2o persistence; the solver state
        # is the device-resident graph below)
        self.edge_i: List[int] = []
        self.edge_j: List[int] = []
        self.edge_T: List[np.ndarray] = []
        self.edge_var: List[np.ndarray] = []
        self.n_lc_edges = 0  # accepted loop-closure factors (observability)
        self.prior_pose: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        # Whether the graph can have nonzero residual at the current
        # estimate. Odometry-only graphs built in-session are EXACTLY
        # consistent by construction: every between factor is computed from
        # the very poses it constrains (add_odom_factor), correction
        # broadcasts rewrite all keyframes rigidly (relative poses
        # preserved), and the node-0 prior only ever matches the solve
        # write-back that respects it — so chi2 == 0 and dx == 0
        # identically, and the solve is a provable no-op (the existing
        # moved < 1e-4 short-circuit confirms this at runtime, after paying
        # for the solve). Loop-closure factors and graphs reloaded from g2o
        # are the only stress sources — plus one conservative trigger: a
        # SECOND edge on an (i, j) pair may have been measured at different
        # poses than the first (an event re-fire after external pose edits)
        # and the two can disagree; duplicates mark the graph stressed.
        # Until a stress source exists, optim_once skips the solve
        # round-trip entirely. Once stressed, always stressed: an actual
        # solve moves poses non-rigidly, leaving older factors with real
        # residual forever after.
        self._graph_stressed = False
        self._edge_pairs: set = set()
        self.n_skipped_noop_solves = 0

        # device-resident factor graph (iSAM2 incrementality role): built
        # once, then per event only NEW keyframe poses / edges are written
        # into their rows via donated updates; the optimized poses stay on
        # device between solves (zero re-upload)
        self._g: Optional[pgo.PoseGraph] = None
        self._k_dev = 0  # pose rows synced to device
        self._e_dev = 0  # edge rows synced to device

        self._load_factor_graph()

    # -- factor building (Backend.cpp:224-268) -------------------------------
    def _add_between(self, i: int, j: int, T_ij: np.ndarray, var: np.ndarray) -> None:
        if len(self.edge_i) >= self.e_cap:
            self.lg.error("factor graph edge capacity (%d) exceeded, dropping edge!",
                          self.e_cap)
            return
        if (i, j) in self._edge_pairs:
            self._graph_stressed = True  # duplicate pair: may disagree
        self._edge_pairs.add((i, j))
        self.edge_i.append(i)
        self.edge_j.append(j)
        self.edge_T.append(T_ij.copy())
        self.edge_var.append(var)

    def add_odom_factor(self) -> None:
        """Called under kf_obj.lock. Factors for keyframes [kf_nums, len)."""
        kfs = self.kf_obj.keyframes
        n = self.kf_obj.kf_nums
        if n == 0 and kfs:
            self.prior_pose = kfs[0].pose.copy()
            n = 1
        cidx = 0
        for i in range(max(n, 1), len(kfs)):
            from_idx = self.kf_obj.closest_kf_idx[cidx]
            cidx += 1
            T_from = kfs[from_idx].pose
            T_to = kfs[i].pose
            self.lg.info("factor graph add edge from %d to %d", from_idx, i)
            self._add_between(from_idx, i, np.linalg.inv(T_from) @ T_to, ODOM_VAR)

    def add_loop_factor(self) -> None:
        if self.lcm is None:
            return
        while True:
            r = self.lcm.lc_queue.consume_front()
            if r is None:
                break
            n0 = len(self.edge_i)
            self._add_between(r.from_idx, r.to_idx, r.between, LC_VAR)
            self.n_lc_edges += len(self.edge_i) - n0
            if len(self.edge_i) > n0:
                self._graph_stressed = True

    # -- the optimization pass (Backend.cpp:270-346) --------------------------
    def optim_once(self, pre_fetch_hook=None) -> bool:
        """One event-driven pass; returns True if a solve ran.

        ``pre_fetch_hook`` (link-latency hiding): called after the solve is
        DISPATCHED but before its blocking result fetch — the streamed
        worker passes the loop-closure retrieval dispatch here so both
        round-trips ride the link concurrently."""
        with self.kf_obj.lock:
            event = self.kf_obj.get_and_reset_event()
            if event == KFEvent.NONE:
                return False
            if event & KFEvent.NEW_KF:
                if self.lcm is not None:
                    self.lcm.add_context()
                self.map_manager.save_kfs()
                self.add_odom_factor()
                self.kf_obj.kf_nums = len(self.kf_obj.keyframes)
                self.kf_obj.closest_kf_idx.clear()
            if event & KFEvent.LC:
                self.lg.info("loop closure comes in backend!")
                self.add_loop_factor()
            kf_poses = [kf.pose.copy() for kf in self.kf_obj.keyframes]

        if not kf_poses or self.prior_pose is None:
            return False
        if not self._graph_stressed:
            # provable no-op (see _graph_stressed): skip the solve's
            # dispatch + fetch round-trips, but still fire the hook so the
            # loop-closure retrieval dispatch it carries is not lost
            if pre_fetch_hook is not None:
                pre_fetch_hook()
            self.n_skipped_noop_solves += 1
            self.last_delta = np.eye(4)
            self.last_kf_count = len(kf_poses)
            return False
        opt = self._solve(kf_poses, strong=bool(event & KFEvent.LC),
                          pre_fetch_hook=pre_fetch_hook)

        # No-op solve short-circuit: a consistent odometry-only graph leaves
        # every pose where it was (chi2 ~ 0, dx ~ 0). Writing the f32 solve
        # round-trip back — and broadcasting a float-noise "delta" the
        # executor then composes/reorthonormalizes into its pose chain ~100
        # times per session — perturbs downstream state for zero correction,
        # and at marginal-geometry stretches those micro-perturbations were
        # measured flipping a bistable registration between runs. Real
        # corrections (loop closures, drift redistribution) pass untouched.
        moved = max(
            (float(np.linalg.norm(o[:3, 3] - p[:3, 3]))
             for o, p in zip(opt, kf_poses)), default=0.0)
        if moved < 1e-4:
            self.last_delta = np.eye(4)
            self.last_kf_count = len(kf_poses)
            return False
        # solver sanity: a blown-up solve (non-finite, or absurd pose moves
        # from an inconsistent factor at f32) must never be written back —
        # one garbage write-back poisons every submap and correction after it
        if not all(np.isfinite(o).all() for o in opt) or moved > 1e4:
            self.lg.error("discarding non-finite/blown-up solve "
                          "(max move %.1f m)", moved)
            self.n_discarded_solves = getattr(
                self, "n_discarded_solves", 0) + 1
            return False

        with self.kf_obj.lock:
            kfs = self.kf_obj.keyframes
            n = min(len(opt), len(kfs))
            latest_pose = kfs[-1].pose.copy()
            for i in range(n):
                kfs[i].pose = opt[i]
            delta = kfs[-1].pose @ np.linalg.inv(latest_pose)

        # re-orthonormalize (T2SE3 role) on host
        u, _, vt = np.linalg.svd(delta[:3, :3])
        delta[:3, :3] = u @ vt

        self.frontend.global_odom.replace_all(
            lambda o: type(o)(o.stamp, delta @ o.odom)
        )
        self.frontend.odom2map.store(delta @ self.frontend.odom2map.load())
        # expose the rigid correction so executors holding pose state outside
        # the frontend (pipeline/streamed.py device chain) can apply it too,
        # plus the solve's keyframe watermark: the delta is the correction AT
        # the last keyframe of this solve, so retro-application to a recorded
        # trajectory is valid exactly for scans at/after that keyframe (the
        # GlobalOdom-deque rewrite scope, Backend.cpp:333-342)
        self.last_delta = delta
        self.last_kf_count = n
        return True

    def _solver(self, iters: int):
        """The solve program: edge-sharded over the mesh when one is
        configured, else the single-device solve."""
        if self._mesh is None:
            return partial(pgo.solve, max_iters=iters, cg_iters=64)
        fn = self._sharded_solvers.get(iters)
        if fn is None:
            from ..parallel.dist_posegraph import sharded_solve

            fn = sharded_solve(self._mesh, axis="kf", max_iters=iters,
                               cg_iters=64)
            self._sharded_solvers[iters] = fn
        return fn

    def _solve(self, kf_poses: List[np.ndarray], strong: bool,
               pre_fetch_hook=None) -> List[np.ndarray]:
        k = len(kf_poses)
        with self._lock:
            e = len(self.edge_i)
            g = self._sync_graph(kf_poses)
        # iSAM2-equivalent incremental budget: a couple of damped GN steps per
        # keyframe event, a stronger re-solve on loop closure
        # (update(1) vs +update(3), Backend.cpp:301-304)
        iters = 12 if strong else 4
        res = self._solver(iters)(g)
        # keep the optimized poses device-resident for the next event
        self._g = g._replace(poses=res.poses)
        if pre_fetch_hook is not None:
            pre_fetch_hook()  # overlap other dispatches with the fetch below
        packed = np.asarray(_pack_solve(res.poses, res.cost0, res.cost,
                                        res.iters))  # ONE fetch per event
        cost0, cost, n_it = packed[-3], packed[-2], packed[-1]
        self.lg.info("posegraph solve: k=%d e=%d chi2 %.4f -> %.4f (%d iters)",
                     k, e, float(cost0), float(cost), int(n_it))
        opt = packed[:-3].reshape(-1, 4, 4)[:k].astype(np.float64)
        out = []
        for i in range(k):
            T = np.eye(4)
            T[:3, :4] = opt[i][:3, :4]
            out.append(T)
        return out

    def _sync_graph(self, kf_poses: List[np.ndarray]) -> pgo.PoseGraph:
        """Device graph with only the NEW rows shipped over the link.

        First call builds the padded tensors once; afterwards each keyframe
        event writes just its new pose/edge rows (donated in-place updates),
        so per-event transfer is O(new work) — the iSAM2 incrementality role
        without the Bayes tree (Backend.cpp:301-306's update(graph, init)).
        The caller holds ``self._lock``.
        """
        k = len(kf_poses)
        e = len(self.edge_i)
        while k > self._k_bucket:
            self._k_bucket = min(self._k_bucket * 4, self.k_cap)
            self._g = None  # rebuild at the larger bucket
            self.n_bucket_growths = getattr(self, "n_bucket_growths", 0) + 1
        while e > self._e_bucket:
            self._e_bucket = min(self._e_bucket * 4, self.e_cap)
            if self._mesh is not None:  # keep edges mesh-divisible
                n = self._mesh.devices.size
                self._e_bucket = -(-self._e_bucket // n) * n
            self._g = None
            self.n_bucket_growths = getattr(self, "n_bucket_growths", 0) + 1
        if self._g is None:
            self._g = self._build_graph(kf_poses)
            self._k_dev, self._e_dev = k, e
            return self._g
        g = self._g
        poses, kmask = g.poses, g.kf_mask
        ei, ej, eT, einfo, emask = (g.edge_i, g.edge_j, g.edge_T,
                                    g.edge_info, g.edge_mask)
        ki, en = self._k_dev, self._e_dev
        while ki < k or en < e:
            # one fused dispatch writes up to _SYNC_CHUNK new pose rows AND
            # _SYNC_CHUNK new edge rows; invalid lanes are no-ops
            kidx = np.zeros(_SYNC_CHUNK, np.int32)
            krows = np.tile(np.eye(4, dtype=np.float32), (_SYNC_CHUNK, 1, 1))
            kval = np.zeros(_SYNC_CHUNK, bool)
            for c in range(min(_SYNC_CHUNK, k - ki)):
                kidx[c] = ki + c
                krows[c] = np.asarray(kf_poses[ki + c], np.float32)
                kval[c] = True
            eidx = np.zeros(_SYNC_CHUNK, np.int32)
            eiv = np.zeros(_SYNC_CHUNK, np.int32)
            ejv = np.zeros(_SYNC_CHUNK, np.int32)
            eTv = np.tile(np.eye(4, dtype=np.float32), (_SYNC_CHUNK, 1, 1))
            einfov = np.zeros((_SYNC_CHUNK, 6), np.float32)
            evalv = np.zeros(_SYNC_CHUNK, bool)
            for c in range(min(_SYNC_CHUNK, e - en)):
                eidx[c] = en + c
                eiv[c] = self.edge_i[en + c]
                ejv[c] = self.edge_j[en + c]
                eTv[c] = np.asarray(self.edge_T[en + c], np.float32)
                einfov[c] = 1.0 / np.asarray(self.edge_var[en + c],
                                             np.float32)
                evalv[c] = True
            poses, kmask, ei, ej, eT, einfo, emask = _write_rows(
                poses, kmask, ei, ej, eT, einfo, emask,
                jnp.asarray(kidx), jnp.asarray(krows), jnp.asarray(kval),
                jnp.asarray(eidx), jnp.asarray(eiv), jnp.asarray(ejv),
                jnp.asarray(eTv), jnp.asarray(einfov), jnp.asarray(evalv))
            ki = min(ki + _SYNC_CHUNK, k)
            en = min(en + _SYNC_CHUNK, e)
        self._k_dev, self._e_dev = k, e
        self._g = pgo.PoseGraph(
            poses=poses, kf_mask=kmask, edge_i=ei, edge_j=ej, edge_T=eT,
            edge_info=einfo, edge_mask=emask,
            prior_pose=g.prior_pose, prior_info=g.prior_info)
        return self._g

    def _build_graph(self, kf_poses: List[np.ndarray]) -> pgo.PoseGraph:
        k = len(kf_poses)
        kc, ec = self._k_bucket, self._e_bucket
        poses = np.tile(np.eye(4, dtype=np.float32), (kc, 1, 1))
        poses[:k] = np.asarray(kf_poses, np.float32)
        kf_mask = np.arange(kc) < k

        e = len(self.edge_i)
        ei = np.zeros(ec, np.int32)
        ej = np.zeros(ec, np.int32)
        eT = np.tile(np.eye(4, dtype=np.float32), (ec, 1, 1))
        einfo = np.zeros((ec, 6), np.float32)
        if e:
            ei[:e] = self.edge_i
            ej[:e] = self.edge_j
            eT[:e] = np.asarray(self.edge_T, np.float32)
            einfo[:e] = 1.0 / np.asarray(self.edge_var, np.float32)
        emask = np.arange(ec) < e

        return pgo.PoseGraph(
            poses=jnp.asarray(poses),
            kf_mask=jnp.asarray(kf_mask),
            edge_i=jnp.asarray(ei),
            edge_j=jnp.asarray(ej),
            edge_T=jnp.asarray(eT),
            edge_info=jnp.asarray(einfo),
            edge_mask=jnp.asarray(emask),
            prior_pose=jnp.asarray(self.prior_pose, jnp.float32),
            prior_info=jnp.asarray(1.0 / PRIOR_VAR, jnp.float32),
        )

    # -- persistence (Backend dtor + g2o I/O) ---------------------------------
    def save(self) -> None:
        """TUM + g2o save (Backend.cpp:349-358); also persists keyframe pcds."""
        self.map_manager.save_kfs()
        self.map_manager.save_trajectory()
        if not self.save_map_dir:
            return
        os.makedirs(self.save_map_dir, exist_ok=True)
        with self.kf_obj.lock:
            kf_poses = [kf.pose for kf in self.kf_obj.keyframes]
        with self._lock:
            edges = [
                (i, j, T, np.diag(1.0 / var))
                for i, j, T, var in zip(self.edge_i, self.edge_j,
                                        self.edge_T, self.edge_var)
            ]
        fileio.write_g2o(os.path.join(self.save_map_dir, "fg.g2o"),
                         np.asarray(kf_poses) if kf_poses else np.zeros((0, 4, 4)),
                         edges)

    def _load_factor_graph(self) -> None:
        """g2o reload for remapping (loadFactorGraph, Backend.cpp:105-222)."""
        if not self.save_map_dir:
            return
        path = os.path.join(self.save_map_dir, "fg.g2o")
        if not fileio.is_file(path):
            return
        poses, edges = fileio.load_g2o(path)
        with self.kf_obj.lock:
            nk = len(self.kf_obj.keyframes)
            if len(poses) != nk:
                self.lg.warn("g2o vertices (%d) != reloaded keyframes (%d); "
                             "dropping factor graph", len(poses), nk)
                return
            for i in range(nk):
                self.kf_obj.keyframes[i].pose = poses[i]
            self.kf_obj.kf_nums = nk
        if len(poses):
            self.prior_pose = poses[0].copy()
        for i, j, T, info in edges:
            var = 1.0 / np.clip(np.diag(info), 1e-12, None)
            self._add_between(int(i), int(j), T, var)
        if edges:
            # a reloaded graph's consistency cannot be assumed (it may carry
            # loop-closure factors or file-precision stress) — always solve
            self._graph_stressed = True
        self.lg.info("reloaded factor graph: %d vertices, %d edges",
                     len(poses), len(edges))

    # -- startup pre-compilation ----------------------------------------------
    def prewarm(self) -> None:
        """Compile (or load from the persistent cache) the solve programs
        for the CURRENT bucket sizes before the stream starts.

        Without this, the first keyframe event after a bucket growth — or
        the first loop-closure event (the strong-iteration program) — pays
        the XLA compile/cache-load stall mid-run, on the critical path
        (seconds per cache load, more per cold compile). The reference's
        analogue is GTSAM/PCL doing their
        allocations at construction time."""
        kc, ec = self._k_bucket, self._e_bucket
        eye = np.eye(4, dtype=np.float32)
        g = pgo.PoseGraph(
            poses=jnp.asarray(np.tile(eye, (kc, 1, 1))),
            kf_mask=jnp.asarray(np.arange(kc) < 2),
            edge_i=jnp.zeros(ec, jnp.int32),
            edge_j=jnp.asarray((np.arange(ec) < 1).astype(np.int32)),
            edge_T=jnp.asarray(np.tile(eye, (ec, 1, 1))),
            edge_info=jnp.asarray(np.ones((ec, 6), np.float32)),
            edge_mask=jnp.asarray(np.arange(ec) < 1),
            prior_pose=jnp.asarray(eye),
            prior_info=jnp.asarray(np.ones(6, np.float32)))
        for iters in (4, 12):  # the weak- and strong-event programs
            res = self._solver(iters)(g)
            np.asarray(_pack_solve(res.poses, res.cost0, res.cost,
                                   res.iters))
