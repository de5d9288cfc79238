"""Streamed odometry executor: device-resident state, one host sync per batch.

Why this exists: the per-scan classic path (``pipeline/app.py`` →
``LidarOdometry.generate_odom``) fetches the refined pose and convergence
flag back to the host EVERY scan and ships the full raw scan plus a merged
submap to the device, so every scan pays a host round trip and a dispatch
per dependency while the device work of a fused odometry step is small.
This executor keeps the loop on the device:

- the scan-to-scan pose chain (and, in lio mode, the odom→map transform)
  lives ON DEVICE and feeds the next dispatch directly;
- scans are voxel-downsampled ON HOST in the native C++ runtime by a
  producer thread (the LidarDataProxy role: chunked batch calls into a
  result dict under a condition variable, with bounded-lookahead blocking
  backpressure — dataproxy/src/LidarDataProxy.cpp:45-49), so each scan
  uploads ~96 KB instead of ~384 KB raw;
- keyframe clouds are uploaded once into a device-resident store; submap
  target rebuilds run entirely on device (``MapManager.update_map_device``)
  moving only indices and poses to the device (vs ~1.5 MB merged submaps);
- K scans run as ONE program (``lax.scan`` over the scan axis): K fused
  steps and a single fetch instead of K dispatches and K fetches;
- results (pose, convergence, fitness) are fetched ONCE per ``sync_every``
  scans; keyframe selection, submap rebuilds, and backend passes run at
  batch boundaries with <= ``sync_every`` scans of lag. The reference has
  the same asynchrony by construction: its map-update and backend threads
  run behind the odometry thread (MapManager.cpp:151-201, Backend.cpp:270).
  A backend correction is applied to the device pose chain as the same
  rigid ``delta`` broadcast the classic path applies to the frontend state
  (after EVERY solve that ran, matching optimHandler).

lio mode: the whole wheel+IMU stream is fused up front in one compiled
``lax.scan`` (``models/filter.ekf_replay`` — the device analogue of the
EkfOdomProxy producer, EkfOdomProxy.cpp:185-248); the per-scan loose
coupling ``init = odom2map ∘ local_odom`` / ``odom2map ← pose ∘
local_odom⁻¹`` (LidarOdometry.cpp:129,238) rides the device chain.

``run_offline`` remains the reference-faithful per-scan semantic baseline
the tests compare against.
"""

from __future__ import annotations

import os
import threading
from functools import partial
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..models.mapmanager import KeyFrame, KFEvent
from ..models.registration import register_kind
from ..ops import geometry as geo
from ..ops.pointcloud import PAD_COORD, PointCloud
from ..utils.config import Params
from ..utils.logging import Logger
from ..utils.tictoc import StageTimers, TicToc
from . import simulate as sim
from .app import SlamResult, SlamSystem


# Scan rows are uploaded quantized to int16 at UPLOAD_SCALE meters per
# count (~3.8 mm over +-125 m — below sensor noise, and wide enough for
# long-range sensors like the KITTI HDL-64's ~120 m returns; coordinates
# beyond the range are dropped), half the bytes of f32 rows. Whether the
# saving still matters over PCIe is an open measurement (ROADMAP D7).
# 32767 is the padding sentinel.
UPLOAD_SCALE = 125.0 / 32767.0
UPLOAD_PAD = np.int16(32767)

# Unconditional cap on the const-velocity prediction's per-scan translation
# (meters): inert for any physical sensor at scan rate, prevents the
# velocity-model feedback loop from ever amplifying a chain inconsistency
# into overflow (see _batch_body).
STEP_CAP = 5.0


def _batch_body(ds_stack: jax.Array, local_odoms: jax.Array, target,
                pose_prev: jax.Array, pose_prev2: jax.Array,
                odom2map: jax.Array, kind: str, mode: str,
                clamp: bool, degen: float, jump_cap: float = 0.0,
                reduce_fn=None, rmax_reduce_fn=None, axis_reduce=None):
    """K odometry steps as ONE program: ``lax.scan`` over the scan axis
    (trace-time body, shared by the single-device jit and the mesh-sharded
    wrapper — ``reduce_fn`` reduces per-shard normal equations there).

    ``ds_stack`` is (K, C, 3) int16 host-downsampled padded scans (see
    UPLOAD_SCALE; the validity mask derives from the UPLOAD_PAD sentinel).
    ``local_odoms`` is (K, 4, 4) EKF local odometry (lio mode; ignored in
    lo mode). Returns ((pose_K, pose_{K-1}, odom2map_K), packed (K, 21))
    where a packed row is [pose16, converged, fitness, gn_iters,
    gn_gathers, n_valid] — n_valid is the final normal-equation support
    (low support flags a starved registration long before ATE shows it).
    """

    def one(carry, inp):
        prev, prev2, o2m = carry
        raw_q, lo_pose = inp
        mask = raw_q[:, 0] != UPLOAD_PAD
        raw = jnp.where(mask[:, None],
                        raw_q.astype(jnp.float32) * UPLOAD_SCALE, PAD_COORD)
        pc = PointCloud(raw, jnp.zeros(raw.shape[:1], jnp.float32), mask)
        if mode == "lio":
            # loose coupling: predict through odom2map (LidarOdometry.cpp:129)
            init = geo.pose_compose(o2m, lo_pose)
        else:
            # constant-velocity prediction from the device chain, with the
            # extrapolated per-scan translation capped UNCONDITIONALLY: the
            # velocity model is an AMPLIFIER — once two successive chain
            # poses disagree by D, uncapped extrapolation re-applies D
            # every scan and registration can grow it further (measured: a
            # marginal-geometry stretch compounded a 3 m disagreement into
            # 1e33 m within ~40 keyframes). No physical sensor moves 5 m
            # between 10 Hz scans, so the cap is inert on every sane
            # trajectory and bounds the chain on every insane one.
            step = geo.pose_compose(geo.pose_inverse(prev2), prev)
            st_t = step[:3, 3]
            sn = jnp.linalg.norm(st_t)
            step = step.at[:3, 3].set(
                st_t * jnp.minimum(1.0, STEP_CAP / jnp.maximum(sn, 1e-9)))
            init = geo.pose_compose(prev, step)
        pose, conv, fit, iters, gathers, support = register_kind(
            pc, target, init, kind, degen, reduce_fn, rmax_reduce_fn,
            axis_reduce)
        if clamp:  # planar clamp each frame (frontend.planar_clamp config)
            pose = geo.six_dof_to_mobile(pose)
        # NaN safety is UNCONDITIONAL (a single non-finite pose poisons the
        # chain and every downstream keyframe); the jump-rejection guard is
        # opt-in via tpu.max_scan_jump_m. Rejection sounds protective but
        # measured WORSE on the deterministic longrun (3.86 m vs 0.30 m):
        # a gated scan keeps the prediction, the small defect propagates
        # into keyframes/submaps, and later registrations inherit it. The
        # reference uses every result as-is (LidarOdometry.cpp:184-199);
        # with the velocity-step cap above bounding runaways, that is also
        # the more accurate policy. A graded rejection (converged results
        # trusted to jump_cap, non-converged to a third of it) remains
        # available for live deployments that prefer bounded-jump output.
        finite = jnp.all(jnp.isfinite(pose))
        if jump_cap > 0:
            jump = jnp.linalg.norm(pose[:3, 3] - init[:3, 3])
            ok = finite & jnp.where(conv, jump <= jump_cap,
                                    jump <= jump_cap / 3.0)
        else:
            ok = finite
        pose = jnp.where(ok, pose, init)
        conv = conv & ok
        if mode == "lio":
            # odom2map update (LidarOdometry.cpp:238)
            o2m = geo.pose_compose(pose, geo.pose_inverse(lo_pose))
        packed = jnp.concatenate([
            pose.reshape(16), conv.astype(jnp.float32)[None], fit[None],
            iters.astype(jnp.float32)[None],
            gathers.astype(jnp.float32)[None],
            support.astype(jnp.float32)[None]])
        return (pose, prev, o2m), packed

    carry, packed = jax.lax.scan(
        one, (pose_prev, pose_prev2, odom2map), (ds_stack, local_odoms))
    return carry, packed


@partial(jax.jit,
         static_argnames=("kind", "mode", "clamp", "degen", "jump_cap"))
def _streamed_batch(ds_stack: jax.Array, local_odoms: jax.Array, target,
                    pose_prev: jax.Array, pose_prev2: jax.Array,
                    odom2map: jax.Array, kind: str, mode: str,
                    clamp: bool = True, degen: float = 0.0,
                    jump_cap: float = 0.0):
    return _batch_body(ds_stack, local_odoms, target, pose_prev, pose_prev2,
                       odom2map, kind, mode, clamp, degen, jump_cap)


_SHARDED_BATCH_CACHE = {}


def make_sharded_batch(mesh, kind: str, mode: str, clamp: bool, degen: float,
                       axis: str = "dp", jump_cap: float = 0.0):
    """Mesh-sharded batch program: scan POINTS sharded over ``axis``.

    The BASELINE.json north star made executable: each batch's (K, C, 3)
    scan stack is partitioned along the point axis, every device runs the
    full solver chain on its point shard against the replicated submap
    target, and per-iteration reductions ride fused psums (LOAM:
    one 43-float psum/GN iteration; NDT: 44-float + line-search psums;
    VGICP: one 44-float psum/GN iteration — see each op's ``axis_reduce``).
    The sequential pose chain / odom2map logic is replicated (it is scalar
    work). Cached per (mesh, config) so repeat calls reuse the compiled
    program.
    """
    key = (id(mesh), kind, mode, clamp, degen, axis, jump_cap)
    fn = _SHARDED_BATCH_CACHE.get(key)
    if fn is not None:
        return fn
    from jax.sharding import PartitionSpec as P

    def fused_psum(JtJ, JtE, n_valid):
        flat = jnp.concatenate(
            [JtJ.reshape(36), JtE, n_valid.astype(jnp.float32)[None]])
        flat = jax.lax.psum(flat, axis)
        return (flat[:36].reshape(6, 6), flat[36:42],
                flat[42].astype(jnp.int32))

    def body(ds_stack, local_odoms, target, pose_prev, pose_prev2, odom2map):
        return _batch_body(ds_stack, local_odoms, target, pose_prev,
                           pose_prev2, odom2map, kind, mode, clamp, degen,
                           jump_cap, fused_psum,
                           lambda r: jax.lax.pmax(r, axis),
                           lambda v: jax.lax.psum(v, axis))

    sm = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(None, axis), P(), P(), P(), P(), P()),
        out_specs=((P(), P(), P()), P()),
        check_vma=False)
    fn = jax.jit(sm)
    _SHARDED_BATCH_CACHE[key] = fn
    return fn


@jax.jit
def _apply_delta(delta: jax.Array, pose: jax.Array) -> jax.Array:
    return geo.reorthonormalize(geo.pose_compose(delta, pose))


class _BackendWorker:
    """Resident backend+LC thread (the optimHandler role, Backend.cpp:270-346).

    The reference runs pose-graph optimization and loop closure on their own
    threads behind the odometry loop; run synchronously at batch boundaries,
    the solve and the whole LC descriptor/verification chain sit on the
    odometry critical path. This worker waits on the keyframe event bus
    (``KeyFramesObj.event_cv``, the mKFcv analogue) and publishes each
    solve's rigid correction; the main loop applies pending corrections to
    the device pose chain between batches (corrections land a batch late —
    same asynchrony the reference has by construction).
    """

    def __init__(self, system: SlamSystem, timers: StageTimers):
        self.system = system
        self.kf_obj = system.map_manager.kf_obj
        self.timers = timers
        self._deltas: List[tuple] = []  # (delta 4x4, solve kf count)
        self._dlock = threading.Lock()
        self._stop = False
        self._error: Optional[BaseException] = None
        # keyframe-count watermark of the last SERVICED event (not
        # necessarily a successful solve): the executor's staleness bound
        # compares admitted keyframes against this to apply bag-mode
        # backpressure (the LidarDataProxy.cpp:45-49 blocking-push idea
        # applied to backend events)
        with self.kf_obj.lock:
            self.serviced_kf_count = len(self.kf_obj.keyframes)
        self._progress = threading.Condition()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="backend")
        self.thread.start()

    def _run(self) -> None:
        import time as _time

        kf = self.kf_obj
        tt = TicToc()
        try:
            while True:
                with kf.lock:
                    while kf._event == KFEvent.NONE and not self._stop:
                        kf.event_cv.wait(timeout=0.1)
                    if kf._event == KFEvent.NONE and self._stop:
                        return
                    stamp = kf.event_stamp
                sys_ = self.system
                tt.tic()
                hook = (sys_.loop_closure.dispatch_queries
                        if sys_.loop_closure is not None else None)
                if sys_.backend.optim_once(pre_fetch_hook=hook):
                    self._push(sys_.backend.last_delta,
                               sys_.backend.last_kf_count)
                self.timers.add("backend", tt.toc())
                # how far the resident worker runs behind the odometry loop
                # (event raised -> solve done); sustained growth here means
                # the backend cannot keep up with the keyframe rate
                self.timers.add("backend_lag", _time.monotonic() - stamp)
                if sys_.loop_closure is not None:
                    tt.tic()
                    if sys_.loop_closure.lc_handler_once():
                        if sys_.backend.optim_once():
                            self._push(sys_.backend.last_delta,
                                       sys_.backend.last_kf_count)
                    self.timers.add("lc", tt.toc())
                with self.kf_obj.lock:
                    n_now = len(self.kf_obj.keyframes)
                with self._progress:
                    self.serviced_kf_count = n_now
                    self._progress.notify_all()
        except BaseException as e:  # surface in the main loop
            self._error = e
            with self._progress:
                self._progress.notify_all()

    def _push(self, delta: np.ndarray, kf_count: int) -> None:
        with self._dlock:
            self._deltas.append((delta.copy(), kf_count))

    def wait_progress(self, timeout: float) -> None:
        """Block until the worker services another event (backpressure)."""
        if self._error is not None:
            raise RuntimeError("backend worker died") from self._error
        with self._progress:
            self._progress.wait(timeout=timeout)

    def drain(self) -> List[tuple]:
        if self._error is not None:
            raise RuntimeError("backend worker died") from self._error
        with self._dlock:
            out, self._deltas = self._deltas, []
        return out

    def close(self) -> List[tuple]:
        """Finish processing queued events, stop, return final corrections."""
        self._stop = True
        with self.kf_obj.lock:
            self.kf_obj.event_cv.notify_all()
        self.thread.join()
        return self.drain()


class _ScanPrep:
    """Producer thread: host voxel-downsample into the padded device layout.

    The LidarDataProxy role (dataproxy/src/LidarDataProxy.cpp): bounded
    lookahead with blocking backpressure in bag mode. Downsampling on host
    (C++ runtime) before upload cuts the upload ~4x. Scans are prepped in
    CHUNKS through one batched ctypes call (OpenMP over scans inside): the
    GIL is released for the whole chunk, so the producer makes real
    progress while the main thread holds the GIL for its numpy bookkeeping
    (per-scan Python-thread handoffs would serialize on the GIL instead).
    """

    def __init__(self, scans, grid: float, capacity: int, depth: int = 64,
                 chunk: int = 16, sort_grid: float = 0.0):
        self.scans = scans
        self.grid = grid
        self.capacity = capacity
        self.sort_grid = sort_grid
        self.depth = depth
        self.chunk = chunk
        self._results = {}
        self._consumed = 0  # lowest index not yet consumed (backpressure ref)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._stop = False
        self._error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="scanprep")
        self.thread.start()

    def _run(self) -> None:
        n = len(self.scans)
        try:
            nxt = 0
            while nxt < n:
                with self._cv:
                    while (not self._stop
                           and nxt - self._consumed >= self.depth):
                        self._cv.wait(timeout=0.5)
                    if self._stop:
                        return
                lo, hi = nxt, min(nxt + self.chunk, n)
                # one GIL-released native call does downsample + spatial
                # sort (consecutive registration queries then hit
                # neighboring rows of the dense target in device memory;
                # sorting by SENSOR-frame voxel key at the target grid
                # preserves locality under the rigid map transform) +
                # int16 upload quantization (see UPLOAD_SCALE)
                qrows, cnts = native.voxel_downsample_sort_quant_batch(
                    [np.asarray(self.scans[i], np.float32)
                     for i in range(lo, hi)],
                    self.grid, self.capacity, self.sort_grid, UPLOAD_SCALE)
                with self._cv:
                    for k, i in enumerate(range(lo, hi)):
                        self._results[i] = (qrows[k], int(cnts[k]))
                    self._cv.notify_all()
                nxt = hi
        except BaseException as e:  # surface in get()
            with self._cv:
                self._error = e
                self._cv.notify_all()

    def get(self, i: int):
        """Fetch scan ``i``'s prepped row (blocks until a worker finishes it).

        ``timeout`` is per-wait, not cumulative: any notify (another chunk
        landing) restarts the window, so it only fires after 60 s of total
        producer silence — a liveness check, not a hard per-index deadline.
        """
        timeout = 60.0
        with self._cv:
            while i not in self._results:
                if self._error is not None:
                    raise RuntimeError("scan prep worker died") \
                        from self._error
                if not self._cv.wait(timeout=timeout):
                    raise RuntimeError("scan prep timed out")
            out = self._results.pop(i)
            if i >= self._consumed:
                self._consumed = i + 1
                self._cv.notify_all()  # release backpressured workers
        return out

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self.thread.join(timeout=5.0)


class _LocalOdomFeeder:
    """Incremental wheel+IMU fusion for lio mode.

    Fusing the ENTIRE sensor stream in one ``ekf_replay`` before the first
    scan would put an O(stream) serial head in front of the loop
    (multi-second on hour-long streams). This feeder
    fuses the event tape in fixed 4096-event chunks THROUGH the same
    compiled step (``models/filter.ekf_replay_chunk`` carries the filter
    state across chunks, bit-identical to the whole-tape scan), advancing
    only far enough to finalize the local odoms each scan batch needs — the
    streaming, head-free shape of the reference proxy
    (EkfOdomProxy.cpp:185-248).

    Padding note: pad rows perturb the carry (an IMU pad row consumes the
    update flag and shrinks P on a zero-innovation update), so only the
    FINAL chunk — after which no real event follows — is ever padded.
    """

    CHUNK = 4096

    def __init__(self, streams, scan_stamps: np.ndarray,
                 local_np: np.ndarray):
        from ..models import filter as flt

        self._flt = flt
        (self.ev_stamps, self.ev_iswheel, self.ev_xy, self.ev_wyaw,
         self.ev_iyaw) = flt.build_tape_arrays(
            streams.wheel_stamps, streams.wheel_poses,
            streams.imu_stamps, streams.imu_quats)
        self.n_events = len(self.ev_stamps)
        self.carry = flt.ekf_carry0()
        self.pos = 0
        self.lo_stamps = np.zeros(0)
        self.lo_states = np.zeros((0, 3))
        self.scan_stamps = scan_stamps
        self.local_np = local_np
        self.filled = 0  # scans whose local_np row is final
        self.n_chunks = 0

    def _advance_chunk(self) -> None:
        flt = self._flt
        lo, hi = self.pos, min(self.pos + self.CHUNK, self.n_events)
        sl = slice(lo, hi)
        im = ~self.ev_iswheel[sl]
        last_iyaw = float(self.ev_iyaw[sl][im][-1]) if im.any() else 0.0
        tape = flt.pad_tape_chunk(
            self.ev_stamps[sl], self.ev_iswheel[sl], self.ev_xy[sl],
            self.ev_wyaw[sl], self.ev_iyaw[sl], self.CHUNK, last_iyaw)
        self.carry, res = flt.ekf_replay_chunk(self.carry, tape)
        emitted = np.asarray(res.emitted)
        self.lo_stamps = np.concatenate(
            [self.lo_stamps, np.asarray(res.stamps, np.float64)[emitted]])
        self.lo_states = np.concatenate(
            [self.lo_states, np.asarray(res.states, np.float64)[emitted]])
        self.pos = hi
        self.n_chunks += 1

    def ensure(self, hi_scan: int) -> None:
        """Finalize ``local_np`` rows [0, hi_scan] (blocking fuse as needed).

        A row is final once an emitted odom with a LATER stamp exists (the
        nearest-of-two bracket is then decided) or the tape is exhausted.
        """
        if hi_scan < self.filled:
            return
        t = float(self.scan_stamps[hi_scan])
        while self.pos < self.n_events and (
                len(self.lo_stamps) == 0 or self.lo_stamps[-1] <= t):
            self._advance_chunk()
        if len(self.lo_stamps) == 0:
            raise ValueError("lio mode needs wheel odometry in the stream")
        # nearest-stamp local odom per scan (the vectorized
        # Frontend::getClosestLocalOdom, Frontend.cpp:25-52)
        ts = self.scan_stamps[self.filled: hi_scan + 1]
        nearest = np.clip(np.searchsorted(self.lo_stamps, ts), 1,
                          len(self.lo_stamps) - 1)
        nearest -= (ts - self.lo_stamps[nearest - 1]
                    < self.lo_stamps[nearest] - ts).astype(int)
        for k, s in zip(range(self.filled, hi_scan + 1),
                        self.lo_states[nearest]):
            c, sn = np.cos(s[2]), np.sin(s[2])
            self.local_np[k, 0, 0] = c
            self.local_np[k, 0, 1] = -sn
            self.local_np[k, 1, 0] = sn
            self.local_np[k, 1, 1] = c
            self.local_np[k, 0, 3] = s[0]
            self.local_np[k, 1, 3] = s[1]
        self.filled = hi_scan + 1


def run_streamed(system: SlamSystem, streams: sim.SensorStreams,
                 sync_every: int = 16, progress: bool = False,
                 device_probe: bool = False) -> SlamResult:
    """Replay ``streams`` through the streamed executor (lo or lio mode).

    ``device_probe=True`` blocks on each batch right after dispatch and books
    the wait as ``device_exec`` — an accurate per-batch device-pipeline time
    at the cost of serializing the double-buffered overlap. Bench probes use
    it on a short segment; throughput runs leave it off.
    """
    lg = Logger.get_instance()
    cfg = Params.get_instance()
    timers = StageTimers()
    tt_all = TicToc()
    tt = TicToc()
    stats = {"gn_iters": 0.0, "gn_gathers": 0.0, "n_batches": 0, "n_reg": 0}

    mm = system.map_manager
    mm.enable_device_store()
    grid = float(system.lidar_odometry.grid_size)
    # scan-row capacity: the registration query axis. Decoupled from the
    # keyframe-store row capacity (kf_capacity) because every (Q, ...) pass
    # of the hot loop scales with it — auto mode sizes it from the first
    # scan's downsampled occupancy (+20 %, 512-aligned), so a typical scan
    # is ~75 % occupied instead of ~60 %. LATCHED on the system after the
    # first run: one capacity (one compile) per SlamSystem lifetime, so
    # multi-segment drives (bench warmup/probe/throughput, memcheck) never
    # recompile on count drift between segments.
    dsc = getattr(system, "_streamed_scan_capacity", None)
    if dsc is None:
        dsc = int(cfg["tpu"].get("ds_scan_capacity", 8192))
        if bool(cfg["tpu"].get("auto_scan_capacity", True)) \
                and len(streams.scans):
            cnt0 = len(native.voxel_downsample_first(
                np.asarray(streams.scans[0], np.float32), grid))
            dsc = max(2048, min(dsc, -(-int(cnt0 * 1.2) // 512) * 512))
        dsc = min(dsc, mm.kf_capacity)  # scan rows must fit kf-store rows
        system._streamed_scan_capacity = dsc
    kind = system.register.KIND
    mode = system.mode
    clamp = bool(cfg["frontend"].get("planar_clamp", True))
    degen = float(system.register.degen_per_row)
    # jump rejection default OFF (reference-faithful: results used as-is;
    # the measured-safer policy — see _batch_body's guard rationale). NaN
    # safety and the velocity STEP_CAP are unconditional regardless.
    jump_cap = float(cfg["tpu"].get("max_scan_jump_m", 0.0))

    # multi-device execution: tpu.mesh_devices > 0 runs the WHOLE mapping
    # pipeline on a device mesh — scan points sharded over "dp" for
    # registration (one fused psum per GN iteration), and the backend worker
    # solves the pose graph edge-sharded over the same devices
    # (models/backend.py picks the mesh up from the same config key)
    mesh_n = int(cfg["tpu"].get("mesh_devices", 0))
    if mesh_n:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(mesh_n, ("dp",))
        batch_fn = make_sharded_batch(mesh, kind, mode, clamp, degen,
                                      jump_cap=jump_cap)
    else:
        batch_fn = partial(_streamed_batch, kind=kind, mode=mode,
                           clamp=clamp, degen=degen, jump_cap=jump_cap)

    scan_stamps = np.asarray(streams.scan_stamps)
    n_scans = len(scan_stamps)
    est_poses = np.tile(np.eye(4), (n_scans, 1, 1))
    # timing-independent accuracy bookkeeping: every scan
    # records which keyframe anchored it, so late-arriving backend solves
    # reach already-recorded poses — first retroactively (rigid delta to
    # scans at/after the solve's last keyframe, the Backend.cpp:333-342
    # GlobalOdom rewrite), then at shutdown by re-basing each scan on its
    # anchor keyframe's FINAL optimized pose. ATE becomes a function of the
    # data, not of when solves land relative to the stream.
    scan_anchor = np.full(n_scans, -1, np.int64)   # scan -> keyframe idx
    kf_scan_idx: List[int] = []                    # keyframe -> scan idx
    with mm.kf_obj.lock:
        kf_scan_idx.extend([-1] * len(mm.kf_obj.keyframes))  # resumed kfs
    retired_hi = 0                                 # scans recorded so far
    n_conv = 0

    # lio: fuse the wheel+IMU stream INCREMENTALLY in compiled chunks (the
    # feeder advances just past each batch's stamps, keeping the EKF off
    # the startup critical path) and pick the closest local odom per scan
    # (the vectorized Frontend::getClosestLocalOdom, Frontend.cpp:25-52)
    local_np = np.tile(np.eye(4, dtype=np.float32), (n_scans, 1, 1))
    feeder: Optional[_LocalOdomFeeder] = None
    if mode == "lio":
        tt.tic()
        feeder = _LocalOdomFeeder(streams, scan_stamps, local_np)
        feeder.ensure(0)  # the chain anchor needs scan 0's local odom
        timers.add("ekf_replay", tt.toc())

    # spatial-sort grid: the LOAM dense-map grid, or the NDT/VGICP voxel
    # resolution (their Gaussian lookups coalesce the same way)
    sort_grid = getattr(system.register, "TARGET_GRID",
                        getattr(system.register, "RESOLUTION", 0.0))
    prep = _ScanPrep(streams.scans, grid, dsc, sort_grid=float(sort_grid))
    # Deterministic bag-mode backend (tpu.sync_backend): service keyframe
    # events INLINE at batch boundaries instead of on the resident worker
    # thread. Offline replay has no real-time constraint, and thread-timing
    # nondeterminism in WHEN solves/closures land was measured flipping a
    # marginal-geometry longrun between 0.2 m and ~15 m ATE run-to-run —
    # the exact "accuracy must be a function of the data" failure this
    # round exists to close. Throughput pays the serialized solve cost;
    # accuracy becomes reproducible. Default off (live-style asynchrony,
    # the reference's thread topology).
    sync_backend = (bool(cfg["tpu"].get("sync_backend", False))
                    and system.backend is not None)
    worker = (_BackendWorker(system, timers)
              if system.backend is not None and not sync_backend else None)

    # --- bootstrap ----------------------------------------------------------
    # Fresh map: scan 0 seeds the map (generate_odom's empty-submap branch,
    # LidarOdometry.cpp:155-160) with NO device registration — so the batch
    # program below stays the only compiled program of the loop. Continuing
    # run: scan 0 flows through the batch like any other scan.
    def _dequant(row: np.ndarray, cnt: int) -> np.ndarray:
        """Valid prefix of an int16 upload row, back in meters (f32)."""
        return row[:cnt].astype(np.float32) * UPLOAD_SCALE

    si = 0
    start_pose = mm.cur_pose.load().copy()
    odom2map_np = np.eye(4)
    if mode == "lio":
        # odom2map so the chain starts at start_pose for the first local odom
        odom2map_np = start_pose @ np.linalg.inv(local_np[0].astype(np.float64))
    if mm.is_submap_empty():
        tt.tic()
        row0, cnt0 = prep.get(0)
        pose0 = start_pose if mode != "lio" else (
            odom2map_np @ local_np[0].astype(np.float64))
        est_poses[0] = pose0
        n_conv += 1
        mm.set_cur_pose(pose0)
        xyz0 = _dequant(row0, cnt0)
        kf = KeyFrame(float(scan_stamps[0]), pose0, xyz0)
        lg.warn("at first, no submap here for now, build the map!!")
        if mm.put_keyframe(kf):
            with mm.kf_obj.lock:
                kf_idx = len(mm.kf_obj.keyframes) - 1
            mm.store_keyframe_cloud(kf_idx, xyz0)
            kf_scan_idx.append(0)
        mm.update_map_device()
        scan_anchor[0] = len(kf_scan_idx) - 1
        retired_hi = 1
        si = 1
        timers.add("bootstrap", tt.toc())

    pose_prev = jnp.asarray(est_poses[max(si - 1, 0)].astype(np.float32)) \
        if si else jnp.asarray(start_pose.astype(np.float32))
    pose_prev2 = pose_prev  # zero-velocity start
    odom2map = jnp.asarray(odom2map_np.astype(np.float32))
    kf_rows = {}  # scan idx -> prepped row kept for keyframe upload

    def dispatch(si: int, pose_prev, pose_prev2, odom2map):
        """Prep + upload + dispatch one batch (final partial batch pads by
        repeating the last scan; extra outputs ignored so only one batch
        size ever compiles)."""
        batch = list(range(si, min(si + sync_every, n_scans)))
        if feeder is not None:
            tt.tic()
            feeder.ensure(batch[-1])  # finalize this batch's local odoms
            timers.add("ekf_replay", tt.toc())
        mm.commit_pending_target()  # double-buffer swap boundary
        target = mm.get_target()
        tt.tic()
        rows = np.empty((sync_every, dsc, 3), np.int16)
        for k in range(sync_every):
            i = batch[min(k, len(batch) - 1)]
            if k < len(batch):
                row, cnt = prep.get(i)
                rows[k] = row
                kf_rows[i] = (row, cnt)
            else:
                rows[k] = rows[len(batch) - 1]
        timers.add("prep", tt.toc())
        tt.tic()
        rows_d = jnp.asarray(rows)
        locals_d = jnp.asarray(local_np[batch[0]: batch[0] + sync_every]
                               if len(batch) == sync_every else
                               np.concatenate([
                                   local_np[batch[0]: batch[-1] + 1],
                                   np.tile(local_np[batch[-1]],
                                           (sync_every - len(batch), 1, 1)),
                               ]))
        timers.add("upload", tt.toc())
        tt.tic()
        pre = pose_prev
        (pose_prev, pose_prev2, odom2map), packed = batch_fn(
            rows_d, locals_d, target, pose_prev, pose_prev2, odom2map)
        if device_probe:
            jax.block_until_ready(packed)
            timers.add("device_exec", tt.toc())
        if len(batch) < sync_every:
            # partial tail: rewind the device chain to the real last scan
            pose_prev = packed[len(batch) - 1, :16].reshape(4, 4)
            pose_prev2 = (packed[len(batch) - 2, :16].reshape(4, 4)
                          if len(batch) >= 2 else pre)
            if mode == "lio":
                odom2map = _apply_delta(
                    pose_prev,
                    geo.pose_inverse(jnp.asarray(local_np[batch[-1]])))
        timers.add("dispatch", tt.toc())
        # map rebuild dispatched BEHIND the registration batch just queued
        # (double-buffering): the batch registers against the
        # current target; the rebuild executes in its fetch/host window and
        # is committed at the next dispatch — instead of serializing a
        # build ahead of every post-keyframe batch on the one device
        if mm.update_pending():
            tt.tic()
            mm.update_map_device(defer_swap=True)
            timers.add("map_update", tt.toc())
        return batch, packed, pose_prev, pose_prev2, odom2map

    def retire(batch, packed, corr) -> None:
        """Fetch one batch's results and do the lagged host bookkeeping.

        ``corr`` composes every backend delta applied to the device chain
        AFTER this batch was dispatched: the fetched poses predate those
        corrections, so they are rebased into the current map frame here —
        keeping all recorded poses frame-consistent regardless of when a
        solve lands relative to the pipeline depth."""
        nonlocal n_conv, pose_prev, pose_prev2, odom2map, retired_hi
        # ONE fetch per batch. In probe mode the fetch is split into
        # fetch_wait (residual device-pipeline time not hidden by host work)
        # and fetch_xfer (the device->host result copy) at the cost of one
        # extra host sync; the throughput path keeps the single fetch.
        tt.tic()
        if device_probe:
            jax.block_until_ready(packed)
            timers.add("fetch_wait", tt.toc())
            stacked = np.asarray(packed)
            timers.add("fetch_xfer", tt.toc())
        else:
            stacked = np.asarray(packed)
            timers.add("fetch", tt.toc())
        stats["n_batches"] += 1
        stats["n_reg"] += len(batch)
        stats["gn_iters"] += float(np.sum(stacked[: len(batch), 18]))
        stats["gn_gathers"] += float(np.sum(stacked[: len(batch), 19]))
        sup = stacked[: len(batch), 20]
        stats["support_sum"] = stats.get("support_sum", 0.0) + float(
            np.sum(sup))
        stats["support_min"] = min(stats.get("support_min", float("inf")),
                                   float(np.min(sup)))
        if os.environ.get("SIMPLESLAM_DEBUG_SUPPORT"):
            for k, i in enumerate(batch):
                print(f"scan {i} sup {int(sup[k])} conv "
                      f"{int(stacked[k, 16])} iters {int(stacked[k, 18])} "
                      f"pos {stacked[k, 3]:.1f},{stacked[k, 7]:.1f}",
                      flush=True)
        tt.tic()
        for k, i in enumerate(batch):
            pose = stacked[k, :16].reshape(4, 4).astype(np.float64)
            pose = corr @ pose  # rebase into the current map frame
            conv = stacked[k, 16] > 0.5
            n_conv += bool(conv)
            if not conv:
                lg.warn("pcr not converge!!")
            est_poses[i] = pose
            mm.set_cur_pose(pose)  # fires the >1 m map-update notify itself
            if mm.select_gate(pose):  # MapManager owns the admission policy
                row, cnt = kf_rows[i]
                xyz = _dequant(row, cnt)
                if mm.put_keyframe(
                        KeyFrame(float(scan_stamps[i]), pose, xyz)):
                    with mm.kf_obj.lock:
                        kf_idx = len(mm.kf_obj.keyframes) - 1
                    mm.store_keyframe_cloud(kf_idx, xyz)
                    kf_scan_idx.append(i)
            scan_anchor[i] = len(kf_scan_idx) - 1
            kf_rows.pop(i, None)
        retired_hi = batch[-1] + 1
        timers.add("bookkeep", tt.toc())

        # rigid corrections from the backend worker, applied to the device
        # chain after EVERY solve that ran (optimHandler applies its delta
        # per pass, Backend.cpp:310-346); the solves themselves run on the
        # resident backend thread, off the odometry critical path
        if worker is not None:
            for delta, kf_count in worker.drain():
                _apply_backend_delta(delta, kf_count)
        elif sync_backend and mm.kf_obj.is_event_coming():
            # deterministic inline service (the optimHandler turn run
            # synchronously, run_offline-style; see sync_backend above)
            tt.tic()
            be = system.backend
            hook = (system.loop_closure.dispatch_queries
                    if system.loop_closure is not None else None)
            if be.optim_once(pre_fetch_hook=hook):
                _apply_backend_delta(be.last_delta, be.last_kf_count)
            timers.add("backend", tt.toc())
            if system.loop_closure is not None:
                tt.tic()
                if system.loop_closure.lc_handler_once():
                    if be.optim_once():
                        _apply_backend_delta(be.last_delta, be.last_kf_count)
                timers.add("lc", tt.toc())
        # map rebuilds are dispatched at the NEXT batch dispatch (see
        # dispatch(): double-buffered behind the registration batch)

    def _apply_backend_delta(delta_np: np.ndarray, kf_count: int) -> None:
        """Broadcast one solve's rigid correction EVERYWHERE pose state
        lives: the device chain (future scans), the recorded trajectory at
        and after the solve's last keyframe (the reference's GlobalOdom
        rewrite, Backend.cpp:333-342), and the corrections pending batches
        will be rebased with at retire time."""
        nonlocal pose_prev, pose_prev2, odom2map
        # correction sanity: a non-finite or implausibly large rigid delta
        # (a solve that blew up despite the backend's own guards) must not
        # reach the chain/trajectory — one poisoned delta NaNs the session
        if (not np.isfinite(delta_np).all()
                or np.linalg.norm(delta_np[:3, 3]) > 1e3):
            lg.error("dropping non-finite/implausible backend delta")
            stats["n_dropped_deltas"] = stats.get("n_dropped_deltas", 0) + 1
            return
        delta = jnp.asarray(delta_np.astype(np.float32))
        pose_prev = _apply_delta(delta, pose_prev)
        pose_prev2 = _apply_delta(delta, pose_prev2)
        odom2map = _apply_delta(delta, odom2map)
        wm = kf_scan_idx[kf_count - 1] if 0 < kf_count <= len(kf_scan_idx) \
            else -1
        wm = max(wm, 0)
        if wm < retired_hi:
            est_poses[wm:retired_hi] = np.einsum(
                "ab,nbc->nac", delta_np, est_poses[wm:retired_hi])
        for ent in pending:
            ent[2] = delta_np @ ent[2]
        stats["n_deltas"] = stats.get("n_deltas", 0) + 1

    def _consume_reloc(si: int) -> None:
        """RelocDataProxy semantics on the device chain: an /initialpose
        reloc (LidarOdometry.set_reloc_flag) resets the pose chain — and in
        lio mode re-anchors odom2map so the next init equals the reloc pose
        (LidarOdometry.cpp:121-129's reloc branch). Takes effect at the next
        batch boundary (<= sync_every scans of latency)."""
        nonlocal pose_prev, pose_prev2, odom2map
        lo = system.lidar_odometry
        with lo._reloc_lock:
            if not lo.reloc:
                return
            rpose = lo.reloc_pose.copy()
            lo.reloc = False
        lg.info("reloc-ing...")
        pose_prev = jnp.asarray(rpose.astype(np.float32))
        pose_prev2 = pose_prev  # zero-velocity restart
        if mode == "lio":
            if feeder is not None:
                feeder.ensure(min(si, n_scans - 1))
            odom2map = jnp.asarray(
                (rpose @ np.linalg.inv(local_np[min(si, n_scans - 1)]
                                       .astype(np.float64))
                 ).astype(np.float32))

    # pipelined drive: up to ``depth`` batches are dispatched BEFORE the
    # oldest is fetched, so device execution overlaps the fetch round-trip
    # AND the host bookkeeping of earlier batches. The pose chain is a pure
    # device-side dependency (dispatch passes the not-yet-computed carry of
    # batch N straight into batch N+1 — XLA chains them without a host
    # sync), so deeper pipelining costs no correctness, only lag: backend
    # corrections and keyframe admission reach the chain up to
    # depth * sync_every scans late (the classic path has the same
    # asynchrony through its map/backend threads, Backend.cpp:270). The
    # depth is a throughput knob to re-sweep on the GPU (ROADMAP S3).
    from collections import deque

    depth = max(1, int(cfg["tpu"].get("pipeline_depth", 2)))
    # staleness bound (bag-mode backpressure on backend events): when more
    # than this many admitted keyframes are unserviced by the backend
    # worker, dispatch BLOCKS until the worker catches up — the
    # LidarDataProxy.cpp:45-49 blocking-push semantics applied to keyframe
    # events, so a slow backend cannot let corrections lag arbitrarily far
    # behind the stream. <= 0 disables the bound.
    max_backlog = int(cfg["tpu"].get("backend_max_backlog_kf", 12))

    def _backlogged() -> bool:
        return (worker is not None and max_backlog > 0
                and len(kf_scan_idx) - worker.serviced_kf_count > max_backlog)

    pending = deque()
    while si < n_scans or pending:
        if si < n_scans and not _backlogged():
            # corrections reach the chain (and the rebuild at dispatch)
            # BEFORE more scans register — not only at retire: a solve
            # completing during a backpressure stall or deep pipelining
            # must not leave further batches in the stale frame (the
            # inconsistency window shrinks to in-flight solve time, the
            # reference's own async bound)
            if worker is not None:
                for delta_, kfc_ in worker.drain():
                    _apply_backend_delta(delta_, kfc_)
            _consume_reloc(si)
            batch, packed, pose_prev, pose_prev2, odom2map = dispatch(
                si, pose_prev, pose_prev2, odom2map)
            si = batch[-1] + 1
            pending.append([batch, packed, np.eye(4)])
        if pending and (len(pending) >= depth or si >= n_scans
                        or _backlogged()):
            done = pending.popleft()
            retire(done[0], done[1], done[2])
            if progress:
                lg.info("scan %d/%d", done[0][-1] + 1, n_scans)
        elif _backlogged() and not pending and si < n_scans:
            tt.tic()
            worker.wait_progress(timeout=0.05)
            timers.add("backend_backpressure", tt.toc())

    prep.close()
    if worker is not None:
        # drain queued keyframe events (reference shutdown joins the optim
        # thread, Backend.cpp:349-358); final corrections reach the chain so
        # a continuing run starts corrected
        for delta, kf_count_ in worker.close():
            _apply_backend_delta(delta, kf_count_)
    wall = tt_all.elapsed()
    with mm.kf_obj.lock:
        kf_count = len(mm.kf_obj.keyframes)
        kf_stamps = np.array([kf.stamp for kf in mm.kf_obj.keyframes])
        kf_poses = (np.stack([kf.pose for kf in mm.kf_obj.keyframes])
                    if mm.kf_obj.keyframes else np.zeros((0, 4, 4)))
    if worker is not None and len(kf_scan_idx):
        # Final reconciliation: re-base every scan on its anchor keyframe's
        # FINAL optimized pose. The backend rewrites each keyframe with its
        # individually-optimized pose (Backend.cpp:315-318) — the published
        # reference artifact is that optimized keyframe TUM (:349-358).
        # Here the per-scan trajectory inherits the same corrections: scan i
        # keeps its registration-measured offset to its anchor keyframe
        # (both recorded in the same map frame — the retro-delta application
        # above maintains that invariant), re-rooted at the anchor's final
        # pose. Late solves therefore reach every scan, making the scored
        # trajectory independent of thread/scheduler timing.
        base = est_poses.copy()
        for i in range(n_scans):
            a = int(scan_anchor[i])
            if a < 0 or a >= len(kf_scan_idx):
                continue
            j = kf_scan_idx[a]
            if j < 0 or a >= len(kf_poses):
                continue  # resumed keyframe with no scan in this run
            est_poses[i] = kf_poses[a] @ np.linalg.inv(base[j]) @ base[i]
    n_reg = max(stats["n_reg"], 1)
    return SlamResult(
        stamps=scan_stamps,
        poses=est_poses,
        timers=timers,
        wall_time=wall,
        keyframe_count=kf_count,
        converged_frac=n_conv / max(n_scans, 1),
        extras={
            "gn_iters_mean": round(stats["gn_iters"] / n_reg, 3),
            "gn_gathers_mean": round(stats["gn_gathers"] / n_reg, 3),
            "n_batches": stats["n_batches"],
            "scan_capacity": dsc,
            "support_mean": round(stats.get("support_sum", 0.0) / n_reg, 1),
            "support_min": int(stats.get("support_min", 0)),
            "n_deltas": stats.get("n_deltas", 0),
            "ekf_chunks": feeder.n_chunks if feeder is not None else 0,
            # the reference's evaluation artifact: optimized keyframe TUM
            "kf_stamps": kf_stamps,
            "kf_poses": kf_poses,
        },
    )
