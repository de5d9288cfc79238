"""Keyframe store + submap builder + persistence (reference MapManager).

Parity targets (``frontend/src/MapManager.cpp``):
- mapping ctor reloads keyframes from ``tum.txt`` + ``{i}.pcd`` (:18-50),
- localization ctor loads one global PCD (:52-84),
- ``put_keyframe``: NN gate on keyframe positions, insert if sq-dist > 1 m
  (:122-149; note the reference compares SQUARED distance against the 1.0
  gap — kept as-is, it is load-bearing with gap = 1),
- ``update_map``: radius-8 m keyframe gather -> transform -> concat -> voxel
  downsample -> submap swap (:151-201),
- ``save_kfs``: persist new keyframes then downsample the in-memory copy
  (:203-213),
- ``set_cur_pose`` notifies a map update when moved > 1 m (:109-119).

Device re-architecture: keyframe clouds live as host numpy (they are
persistence payloads); the submap is assembled on host (cheap, off the hot
path) and shipped to the device once per update as a padded cloud, where the
configured register builds its voxel-table target. Keyframe NN/radius
queries are brute-force numpy — K <= a few thousand makes kd-trees pointless.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, List, Optional, Set

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..ops import pointcloud as pcops
from ..ops import voxel as vox
from ..utils import fileio
from ..utils.concurrency import AtomicVar
from ..utils.config import Params
from ..utils.logging import Logger

MIN_KF_GAP = 1.0                    # MapManager.hpp:67
SURROUNDING_KF_SEARCH_RADIUS = 8.0  # MapManager.hpp:68

# donated in-place row update of the device keyframe store (no re-upload of
# the whole buffer; the old buffer's memory is reused)
_set_kf_row = jax.jit(lambda buf, i, row: buf.at[i].set(row),
                      donate_argnums=0)


@dataclass
class KeyFrame:
    stamp: float
    pose: np.ndarray               # (4, 4) float64, body pose in map frame
    xyz: np.ndarray                # (n, 3) float32 sensor-frame cloud (downsampled)


class KFEvent:
    NONE = 0
    NEW_KF = 1
    LC = 2


@dataclass
class KeyFramesObj:
    """The shared keyframe bus (frontend/include/frontend/MapManager.hpp:19-56)."""

    keyframes: List[KeyFrame] = field(default_factory=list)
    kf_nums: int = 0                      # persisted/optimized watermark
    closest_kf_idx: List[int] = field(default_factory=list)
    submap_idx: Set[int] = field(default_factory=set)
    lock: threading.RLock = field(default_factory=threading.RLock)
    event_cv: threading.Condition = None  # type: ignore[assignment]
    _event: int = KFEvent.NONE
    event_stamp: float = 0.0  # monotonic time the pending event burst began

    def __post_init__(self):
        self.event_cv = threading.Condition(self.lock)

    def new_kf_is_coming(self) -> None:
        import time

        with self.lock:
            if self._event == KFEvent.NONE:
                self.event_stamp = time.monotonic()
            self._event |= KFEvent.NEW_KF
            self.event_cv.notify_all()

    def lc_is_happening(self) -> None:
        import time

        with self.lock:
            if self._event == KFEvent.NONE:
                self.event_stamp = time.monotonic()
            self._event |= KFEvent.LC
            self.event_cv.notify_all()

    def get_and_reset_event(self) -> int:
        with self.lock:
            e = self._event
            self._event = KFEvent.NONE
            return e

    def is_event_coming(self) -> bool:
        with self.lock:
            return self._event != KFEvent.NONE

    def positions(self) -> np.ndarray:
        with self.lock:
            if not self.keyframes:
                return np.zeros((0, 3))
            return np.stack([kf.pose[:3, 3] for kf in self.keyframes])


class MapManager:
    def __init__(self, register: Any, pcd_file: Optional[str] = None):
        """Mapping mode by default; pass ``pcd_file`` for localization mode."""
        self.lg = Logger.get_instance()
        cfg = Params.get_instance()
        self.save_map_dir: str = cfg["saveMapDir"]
        self.grid_size: float = float(cfg["downSampleVoxelGridSize"])
        self.tpu_cfg = cfg["tpu"]
        self.register = register

        self.kf_obj = KeyFramesObj()
        self.is_mapping = pcd_file is None
        self.cur_pose = AtomicVar(np.eye(4))
        self._select_anchor = np.zeros(3)
        self._last_notify_pose = np.eye(4)
        self._submap_lock = threading.Lock()
        self._submap_pc: Optional[pcops.PointCloud] = None  # device padded cloud
        self._target: Any = None                             # register-built table
        self._set_update = threading.Event()
        self._static_pcd_cloud: Optional[np.ndarray] = None
        self._kf_store: Optional[jax.Array] = None
        # guards the DONATED in-place row updates of the device keyframe
        # store against concurrent readers that dispatch from it (the
        # backend worker's descriptor ingest): a reader must grab the
        # current handle and dispatch under this lock, else the donation
        # can invalidate the handle between read and dispatch
        self.kf_store_lock = threading.Lock()

        if self.is_mapping:
            if self.save_map_dir:
                self._reload_from_dir()
        else:
            xyz, _ = fileio.load_pcd(pcd_file)
            self._static_pcd_cloud = xyz
            self.kf_obj.submap_idx.add(0)
            self._rebuild_submap_from_points(xyz, np.eye(4))
            self.lg.info("load map success!! submap size: %d", len(xyz))

    # -- persistence (MapManager.cpp:18-50, 203-213) -------------------------
    def _reload_from_dir(self) -> None:
        stamps, poses = fileio.load_tum(self.save_map_dir)
        for i in range(len(stamps)):
            fn = os.path.join(self.save_map_dir, f"{i}.pcd")
            if not os.path.isfile(fn):
                self.lg.warn("missing keyframe pcd: %s", fn)
                continue
            xyz, _ = fileio.load_pcd(fn)
            xyz = self._host_downsample(xyz)
            self.kf_obj.keyframes.append(KeyFrame(stamps[i], poses[i], xyz))
        self.kf_obj.kf_nums = len(self.kf_obj.keyframes)
        if self.kf_obj.kf_nums:
            self.lg.info("reloaded %d keyframes from %s", self.kf_obj.kf_nums, self.save_map_dir)

    def save_kfs(self) -> None:
        if not (self.is_mapping and self.save_map_dir):
            return
        os.makedirs(self.save_map_dir, exist_ok=True)
        with self.kf_obj.lock:
            kfs = self.kf_obj.keyframes
            for i in range(self.kf_obj.kf_nums, len(kfs)):
                fileio.save_pcd(os.path.join(self.save_map_dir, f"{i}.pcd"), kfs[i].xyz)

    def save_trajectory(self) -> None:
        if not (self.is_mapping and self.save_map_dir):
            return
        os.makedirs(self.save_map_dir, exist_ok=True)
        with self.kf_obj.lock:
            stamps = np.array([kf.stamp for kf in self.kf_obj.keyframes])
            poses = (
                np.stack([kf.pose for kf in self.kf_obj.keyframes])
                if self.kf_obj.keyframes else np.zeros((0, 4, 4))
            )
        fileio.write_tum(self.save_map_dir, stamps, poses)

    # -- keyframe admission policy ---------------------------------------------
    # MapManager owns BOTH stages of the policy so executors cannot drift:
    # ``select_gate`` is the cheap LidarOdometry::selectKeyFrame pre-gate
    # (> MIN_KF_GAP from the last selected pose, LidarOdometry.cpp:80-87);
    # ``put_keyframe`` is the nearest-keyframe insert gate
    # (MapManager.cpp:122-149). Callers check select_gate first (it spares
    # building the KeyFrame payload), then put_keyframe decides the insert.
    def select_gate(self, pose: np.ndarray) -> bool:
        cur = pose[:3, 3] if pose.ndim == 2 else pose
        if np.linalg.norm(cur - self._select_anchor) > MIN_KF_GAP:
            self._select_anchor = cur.copy()
            return True
        return False

    # -- keyframe insertion (MapManager.cpp:122-149) --------------------------
    def put_keyframe(self, kf: KeyFrame) -> bool:
        if not self.is_mapping:
            return False
        with self.kf_obj.lock:
            kfs = self.kf_obj.keyframes
            if not kfs:
                self.lg.warn("no any keyframes, start mapping at the very first time!!")
                kfs.append(kf)
                self._select_anchor = kf.pose[:3, 3].copy()
                self.kf_obj.new_kf_is_coming()
                return True
            pos = np.stack([k.pose[:3, 3] for k in kfs])
            d2 = np.sum((pos - kf.pose[:3, 3]) ** 2, axis=1)
            nn = int(np.argmin(d2))
            if d2[nn] > MIN_KF_GAP:  # squared-distance gate, reference quirk
                kfs.append(kf)
                self._select_anchor = kf.pose[:3, 3].copy()
                self.kf_obj.closest_kf_idx.append(nn)
                self.kf_obj.new_kf_is_coming()
                return True
            return False

    # -- submap maintenance (MapManager.cpp:109-119, 151-201) ----------------
    def set_cur_pose(self, pose: np.ndarray) -> None:
        self.cur_pose.store(pose)
        if np.linalg.norm(pose[:3, 3] - self._last_notify_pose[:3, 3]) > MIN_KF_GAP:
            self._last_notify_pose = pose
            self.notify_update_map()

    def notify_update_map(self) -> None:
        self._set_update.set()

    def update_pending(self) -> bool:
        return self._set_update.is_set()

    def update_map(self) -> None:
        """Rebuild the submap around the current pose. Synchronous version of
        the resident map thread body — callers decide the threading."""
        self._set_update.clear()
        if not self.is_mapping:
            return  # localization mode: static global map
        with self.kf_obj.lock:
            kfs = list(self.kf_obj.keyframes)
            # pose SNAPSHOT under the lock: the backend worker rewrites
            # kf.pose during its write-back (optim_once holds this lock);
            # reading poses outside it could mix pre- and post-solve epochs
            # in one submap — after a large loop-closure correction that
            # mixed-epoch map is garbage and registration diverges
            kf_poses = [k.pose for k in kfs]
        if not kfs:
            self.lg.warn("no any keyframes to update!!")
            return
        pos = np.stack([p[:3, 3] for p in kf_poses])
        center = self.cur_pose.load()[:3, 3]
        d2 = np.sum((pos - center) ** 2, axis=1)
        sel = np.where(d2 <= SURROUNDING_KF_SEARCH_RADIUS ** 2)[0]
        merged = native.transform_concat(
            [kfs[i].xyz for i in sel],
            np.stack([kf_poses[i] for i in sel]) if len(sel) else np.zeros((0, 4, 4)),
        )
        with self.kf_obj.lock:
            self.kf_obj.submap_idx = set(int(i) for i in sel)
        self._rebuild_submap_from_points(merged, self.cur_pose.load())

    def _rebuild_submap_from_points(self, xyz: np.ndarray, anchor_pose: np.ndarray) -> None:
        cap = int(self.tpu_cfg["submap_capacity"])
        pc = pcops.from_numpy(xyz, cap)
        origin = jnp.asarray(anchor_pose[:3, 3].astype(np.float32))
        ds, target = self.register.build_target_from_raw(
            pc, self.grid_size, origin, cap)
        with self._submap_lock:
            self._submap_pc = ds
            self._target = target

    def _host_downsample(self, xyz: np.ndarray) -> np.ndarray:
        """Host-side voxel downsample for persistence-sized clouds (native)."""
        return native.voxel_downsample_first(xyz, self.grid_size)

    # -- device-resident keyframe store (streamed executor) -------------------
    # Keyframe clouds live on device so submap rebuilds upload only indices
    # and poses; each cloud is uploaded exactly once at insertion. This is
    # the device-resident version of updateMap's keyframe
    # gather (MapManager.cpp:176-192), with the kd-tree radius search
    # replaced by a brute-force window select on host (K is small).
    def enable_device_store(self) -> None:
        if getattr(self, "_kf_store", None) is not None:
            return
        self.kf_capacity = int(self.tpu_cfg.get("kf_capacity", 8192))
        self.kf_window = int(self.tpu_cfg.get("submap_kf_window", 16))
        if not self.is_mapping:
            return  # localization mode: static global map, no keyframe store
        max_kf = int(self.tpu_cfg["max_keyframes"])
        self._kf_store = jnp.full((max_kf, self.kf_capacity, 3),
                                  pcops.PAD_COORD, jnp.float32)
        # preload any reloaded keyframes (resume path)
        with self.kf_obj.lock:
            kfs = list(self.kf_obj.keyframes)
        for i, kf in enumerate(kfs):
            self.store_keyframe_cloud(i, kf.xyz)

    def store_keyframe_cloud(self, idx: int, xyz: np.ndarray) -> None:
        """Upload one keyframe cloud into its store row (donated update)."""
        row = np.full((self.kf_capacity, 3), pcops.PAD_COORD, np.float32)
        n = min(len(xyz), self.kf_capacity)
        row[:n] = xyz[:n]
        with self.kf_store_lock:
            self._kf_store = _set_kf_row(self._kf_store, jnp.int32(idx),
                                         jnp.asarray(row))

    # how far the anchor may drift from the last built target's center
    # before a rebuild is forced even with an unchanged keyframe window:
    # the dense registration grid spans +-96 m around its anchor while
    # queries reach lidar range + submap radius (~88 m), leaving ~8 m of
    # coverage slack — half of it is a safe staleness budget.
    REBUILD_CENTER_SLACK = 4.0

    def commit_pending_target(self) -> bool:
        """Swap in a rebuild dispatched with ``defer_swap=True`` (the
        double-buffer boundary): the executor calls this at the NEXT batch
        dispatch, so the rebuild program sits BEHIND one registration batch
        in the device queue and executes in that batch's fetch/host window
        instead of serializing ahead of it."""
        t = getattr(self, "_pending_target", None)
        if t is None:
            return False
        self._pending_target = None
        with self._submap_lock:
            self._submap_pc = None
            self._target = t
        return True

    def update_map_device(self, defer_swap: bool = False) -> None:
        """Submap target rebuild on device (streamed-path update_map).

        Rebuild policy: each build is device time that competes with
        registration batches for the one device, and the reference's
        unconditional 1 m rebuild cadence (MapManager.cpp:151-201) would
        rebuild far more often than coverage needs. A rebuild is deferred
        unless one of these holds:

        - the anchor drifted > REBUILD_CENTER_SLACK from the built target's
          center (coverage: the dense window must keep queries inside it);
        - a keyframe LEFT the window, or any windowed keyframe's pose
          changed (backend correction) — the built points are stale;
        - the map is young (< 4 keyframes), where every cloud matters.

        A NEW keyframe alone does not force a rebuild: its cloud was
        scanned from inside the current window, so the area it covers is
        already in the target at similar density — it batches into the next
        slack-triggered rebuild (<= 4 m later). Accuracy is gated by the
        pipeline ATE tests and the adversarial suite.
        """
        self._set_update.clear()
        if not self.is_mapping:
            return
        with self.kf_obj.lock:
            kfs = list(self.kf_obj.keyframes)
            # pose snapshot under the lock (see update_map: a mixed-epoch
            # window during backend write-back must not reach the target)
            kf_poses = [k.pose for k in kfs]
        if not kfs:
            self.lg.warn("no any keyframes to update!!")
            return
        pos = np.stack([p[:3, 3] for p in kf_poses])
        center = self.cur_pose.load()[:3, 3]
        d2 = np.sum((pos - center) ** 2, axis=1)
        sel = np.where(d2 <= SURROUNDING_KF_SEARCH_RADIUS ** 2)[0]
        if len(sel) > self.kf_window:  # nearest-W if the window overflows
            sel = sel[np.argsort(d2[sel])[: self.kf_window]]
        slack = float(self.tpu_cfg.get("map_rebuild_slack_m",
                                       self.REBUILD_CENTER_SLACK))
        last = getattr(self, "_last_build", None)
        if (last is not None and self._target is not None and slack > 0
                and len(kfs) >= 4):
            old_sel, old_poses, old_center = last
            sel_set = set(int(i) for i in sel)
            none_left = all(int(i) in sel_set for i in old_sel)
            # pose drift below the registration noise floor (5 cm trans /
            # ~0.1 deg rot) does not materially move target points — tiny
            # per-solve backend corrections must not force a rebuild each
            # keyframe event
            poses_same = none_left and all(
                np.linalg.norm(kf_poses[int(i)][:3, 3]
                               - old_poses[k][:3, 3]) < 0.05
                and np.abs(kf_poses[int(i)][:3, :3]
                           - old_poses[k][:3, :3]).max() < 2e-3
                for k, i in enumerate(old_sel))
            if (poses_same
                    and np.linalg.norm(center - old_center) < slack):
                with self.kf_obj.lock:  # bookkeeping still tracks the window
                    self.kf_obj.submap_idx = set(sel_set)
                return
        self._last_build = (
            np.asarray(sel).copy(),
            np.stack([kf_poses[int(i)] for i in sel]) if len(sel)
            else np.zeros((0, 4, 4)),
            center.copy())
        self.n_device_builds = getattr(self, "n_device_builds", 0) + 1
        w = self.kf_window
        idx = np.zeros(w, np.int32)
        poses = np.tile(np.eye(4, dtype=np.float32), (w, 1, 1))
        maskw = np.zeros(w, bool)
        for k, i in enumerate(sel):
            idx[k] = i
            poses[k] = kf_poses[i].astype(np.float32)
            maskw[k] = True
        target = self.register.build_target_from_window(
            self._kf_store, idx, poses, maskw,
            center.astype(np.float32), self.grid_size)
        with self.kf_obj.lock:
            self.kf_obj.submap_idx = set(int(i) for i in sel)
        if defer_swap:
            # double-buffer: registration keeps the CURRENT target until the
            # executor commits at its next batch boundary (the reference's
            # concurrent map thread also swaps behind scan2map's back,
            # MapManager.cpp:151-201 under mLockMap)
            self._pending_target = target
            return
        with self._submap_lock:
            self._submap_pc = None
            self._target = target

    # -- accessors ------------------------------------------------------------
    def is_submap_empty(self) -> bool:
        with self._submap_lock:
            return self._target is None

    def get_target(self):
        with self._submap_lock:
            return self._target

    def get_submap(self) -> Optional[pcops.PointCloud]:
        with self._submap_lock:
            return self._submap_pc

    @property
    def submap_lock(self) -> threading.Lock:
        return self._submap_lock
