"""Planar EKF wheel+IMU fusion — the LocalOdom producer of lio mode.

Re-architecture of the reference's filter stack (``filter/include/filter/*``
+ ``dataproxy/src/EkfOdomProxy.cpp:25-252`` + the locally-modified vendored
Kalman library ``kalman/ExtendedKalmanFilter.hpp:91-155``):

- 3-state planar state [x, y, yaw] with identity dynamics
  (``filter/State.hpp:7-32``, ``SystemModel.hpp:10-38``),
- 1-D IMU yaw and 2-D wheel xy measurement models with trivial Jacobians
  (``ImuMeasModel.hpp:8-49``, ``WheelMeasModel.hpp:8-53``),
- the dt²-scaled process/measurement covariances of the modified library
  (rate-noise semantics, ``ExtendedKalmanFilter.hpp:118,141``) including the
  ``dt = max(dt, 1e-6)`` clamps,
- the relative-measurement trick for both sensors (wheel: compose the last
  fused state with the wheel increment ``po * (pl^-1 * pc)``; IMU: add the
  relative yaw ``ypr(last_q^-1 * q)(0)`` to the current state yaw and wrap
  about it — ``EkfOdomProxy.cpp:150-170, 185-228``),
- the update-rate gate: the IMU update only fires on the first IMU message
  after each wheel predict (``mUpdateImuFlag``), so the filter's update rate
  equals the wheel rate.

Two execution paths:

1. ``EkfOdomProxy`` — streaming host path (live mode): tiny 3x3 numpy math
   per message; never touches the device (a 20-100 Hz stream of 3-vectors
   would pay a dispatch per message for no compute).
2. ``ekf_replay`` — the device bulk path: the *entire* sensor stream is
   fused in one ``lax.scan`` over a merged event tape. Because the EKF feeds
   the frontend one-directionally (no feedback from scan matching), offline
   replay can precompute the whole LocalOdom stream in a single compiled
   call — the idiomatic batch formulation of ``EkfOdomProxy``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.concurrency import SafeDeque
from ..utils.config import Params
from ..utils.logging import Logger
from .frontend import Odometry

# Noise setup (EkfOdomProxy.cpp:72-95; stored squared = variances).
PRIOR_STD = np.array([1e-4, 1e-4, 1e-4])
SYS_STD = np.array([1.0, 1.0, math.radians(5.0)])
IMU_STD = np.array([math.radians(0.1)])
WHEEL_STD = np.array([0.1, 0.1])
_MIN_DT = 1e-6


def _wrap_about(a: float, ref: float) -> float:
    """Wrap ``a`` into (ref - pi, ref + pi] (utils::math::correctAngles)."""
    return a - 2.0 * math.pi * round((a - ref) / (2.0 * math.pi))


def _quat_yaw(q: np.ndarray) -> float:
    """Yaw of a (w, x, y, z) quaternion (ZYX convention, trans::q2ypr row 0)."""
    w, x, y, z = q
    return math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def _pose2d(x: float, y: float, yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    T = np.eye(4)
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[0, 3], T[1, 3] = x, y
    return T


# ---------------------------------------------------------------------------
# core EKF steps (pure, shared by the numpy streaming and JAX scan paths)
# ---------------------------------------------------------------------------

def ekf_predict(P, dt, sys_var):
    """Identity-dynamics predict: x unchanged, P += dt^2 * Q
    (F = W = I, ExtendedKalmanFilter.hpp:109-122)."""
    dt = max(dt, _MIN_DT) if not isinstance(dt, jnp.ndarray) else jnp.maximum(dt, _MIN_DT)
    return P + (dt * dt) * _diag(sys_var, P)


def _diag(var, like):
    if isinstance(like, jnp.ndarray):
        return jnp.diag(jnp.asarray(var, like.dtype))
    return np.diag(var)


def ekf_update(x, P, z, H, meas_var, dt):
    """EKF update with dt^2-scaled R (ExtendedKalmanFilter.hpp:131-155)."""
    np_ = jnp if isinstance(P, jnp.ndarray) else np
    dt = np_.maximum(dt, _MIN_DT)
    R = (dt * dt) * _diag(meas_var, P)
    S = H @ P @ H.T + R
    K = P @ H.T @ np_.linalg.inv(S)
    x = x + K @ (z - H @ x)
    P = P - K @ H @ P
    return x, P


_H_IMU = np.array([[0.0, 0.0, 1.0]])
_H_WHEEL = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])


# ---------------------------------------------------------------------------
# streaming proxy (live path)
# ---------------------------------------------------------------------------

class EkfOdomProxy:
    """Message-driven fusion producer (EkfOdomProxy.cpp semantics).

    ``wheel_handler``/``imu_handler`` mirror the reference callbacks; fused
    planar odometry is pushed to ``local_odom`` at wheel rate.
    """

    def __init__(self, deque_size: Optional[int] = None):
        cfg = Params.get_instance()
        self.lg = Logger.get_instance()
        size = deque_size if deque_size is not None else int(
            cfg["frontend"]["local_size"])
        self.local_odom: SafeDeque[Odometry] = SafeDeque(size)

        self.x = np.zeros(3)
        self.P = np.diag(PRIOR_STD ** 2)
        self._update_imu_flag = False
        self._imu_last_time = -1.0
        self._imu_last_q: Optional[np.ndarray] = None
        self._wheel_last_time = -1.0
        self._wheel_last: Optional[Tuple[np.ndarray, float]] = None  # (t, yaw)

    # EkfOdomProxy.cpp:130-170
    def imu_handler(self, stamp: float, quat_wxyz: np.ndarray) -> None:
        q = np.asarray(quat_wxyz, np.float64)
        if self._imu_last_time < 0:
            self._imu_last_time = stamp
            self._imu_last_q = q
            self.x[2] = _quat_yaw(q)
            self.P = np.diag(PRIOR_STD ** 2)
            self.lg.info("imu init x done: (%g, %g, %g)", *self.x)
            return
        if self._update_imu_flag:
            self._update_imu_flag = False
            dt = stamp - self._imu_last_time
            # relative yaw, absolute-ized about the current state yaw
            dyaw = _quat_yaw(_quat_mul(_quat_conj(self._imu_last_q), q))
            z = _wrap_about(self.x[2] + dyaw, self.x[2])
            self.x, self.P = ekf_update(
                self.x, self.P, np.array([z]), _H_IMU, IMU_STD ** 2, dt)
            self._imu_last_time = stamp
            self._imu_last_q = q

    # EkfOdomProxy.cpp:185-248
    def wheel_handler(self, stamp: float, wheel_pose: np.ndarray) -> None:
        t = np.asarray(wheel_pose[:3, 3], np.float64)
        yaw = math.atan2(wheel_pose[1, 0], wheel_pose[0, 0])
        if self._wheel_last_time < 0:
            self._wheel_last_time = stamp
            self._wheel_last = (t, yaw)
            self.x[0], self.x[1] = t[0], t[1]
            self.P = np.diag(PRIOR_STD ** 2)
            self.lg.info("wheel init x done: (%g, %g, %g)", *self.x)
            return
        dt = stamp - self._wheel_last_time
        self.P = ekf_predict(self.P, dt, SYS_STD ** 2)
        self._update_imu_flag = True

        # measurement = fused state composed with the wheel increment
        lt, lyaw = self._wheel_last
        delta = _pose2d(*self.x[:2], self.x[2]) @ (
            np.linalg.inv(_pose2d(lt[0], lt[1], lyaw)) @ _pose2d(t[0], t[1], yaw)
        )
        z = delta[:2, 3]
        self.x, self.P = ekf_update(self.x, self.P, z, _H_WHEEL, WHEEL_STD ** 2, dt)

        self._wheel_last_time = stamp
        self._wheel_last = (t, yaw)
        self.local_odom.push_back(
            Odometry(stamp, _pose2d(self.x[0], self.x[1], self.x[2])), block=False
        )

    def abort(self) -> None:
        self.local_odom.abort()


def _quat_conj(q: np.ndarray) -> np.ndarray:
    return np.array([q[0], -q[1], -q[2], -q[3]])


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


# ---------------------------------------------------------------------------
# batched replay (device path): one lax.scan over the merged event tape
# ---------------------------------------------------------------------------

class EkfTape(NamedTuple):
    """Merged, stamp-sorted sensor event tape (host-built, device-consumed)."""

    stamps: jax.Array     # (E,) f32
    is_wheel: jax.Array   # (E,) bool
    wheel_xy: jax.Array   # (E, 2) wheel position (zeros on imu rows)
    wheel_yaw: jax.Array  # (E,) wheel yaw
    imu_yaw: jax.Array    # (E,) absolute imu yaw (zeros on wheel rows)


def build_tape_arrays(wheel_stamps: np.ndarray, wheel_poses: np.ndarray,
                      imu_stamps: np.ndarray, imu_quats: np.ndarray):
    """Merged, stamp-ordered event arrays (numpy, UNPADDED) — the host half
    of ``build_tape``; the chunked feeder slices these directly."""
    wy = np.arctan2(wheel_poses[:, 1, 0], wheel_poses[:, 0, 0])
    iy = np.array([_quat_yaw(q) for q in np.asarray(imu_quats, np.float64)])
    stamps = np.concatenate([wheel_stamps, imu_stamps])
    is_wheel = np.concatenate(
        [np.ones(len(wheel_stamps), bool), np.zeros(len(imu_stamps), bool)])
    xy = np.concatenate(
        [wheel_poses[:, :2, 3], np.zeros((len(imu_stamps), 2))])
    wyaw = np.concatenate([wy, np.zeros(len(imu_stamps))])
    iyaw = np.concatenate([np.zeros(len(wheel_stamps)), iy])
    order = np.lexsort((is_wheel, stamps))  # stable: imu before wheel on ties
    return (stamps[order], is_wheel[order], xy[order], wyaw[order],
            iyaw[order])


def pad_tape_chunk(stamps, is_wheel, xy, wyaw, iyaw, cap: int,
                   last_imu_yaw: float) -> EkfTape:
    """Pad one event-array slice to ``cap`` rows with no-op events: IMU rows
    at the final stamp repeating ``last_imu_yaw`` — dt = 0 so predict adds
    no process noise, emitted stays False, and the EKF carry is unchanged
    across them (the invariant chunked replay relies on)."""
    n = len(stamps)
    if cap > n:
        pad = cap - n
        last_t = stamps[-1] if n else 0.0
        stamps = np.concatenate([stamps, np.full(pad, last_t)])
        is_wheel = np.concatenate([is_wheel, np.zeros(pad, bool)])
        xy = np.concatenate([xy, np.zeros((pad, 2))])
        wyaw = np.concatenate([wyaw, np.zeros(pad)])
        iyaw = np.concatenate([iyaw, np.full(pad, last_imu_yaw)])
    return EkfTape(
        jnp.asarray(stamps, jnp.float32),
        jnp.asarray(is_wheel),
        jnp.asarray(xy, jnp.float32),
        jnp.asarray(wyaw, jnp.float32),
        jnp.asarray(iyaw, jnp.float32),
    )


def build_tape(wheel_stamps: np.ndarray, wheel_poses: np.ndarray,
               imu_stamps: np.ndarray, imu_quats: np.ndarray) -> EkfTape:
    """Merge wheel/imu streams into one stamp-ordered tape (ties: imu first,
    matching bag dispatch order where the earlier message is handled first)."""
    stamps, is_wheel, xy, wyaw, iyaw = build_tape_arrays(
        wheel_stamps, wheel_poses, imu_stamps, imu_quats)

    # pad to a power-of-2 bucket so ekf_replay compiles once per bucket, not
    # once per stream length (each compile takes seconds). The
    # padding events are IMU rows at the final stamp repeating the last IMU
    # yaw: dt = 0 so predict adds no process noise, emitted stays False for
    # non-wheel rows, and every real event precedes them in the scan — the
    # consumed (stamps, states)[emitted] rows are bit-identical.
    n = len(stamps)
    # fixed floor of 4096: one compile covers every stream up to ~5.5 min of
    # 20 Hz wheel + 100 Hz imu (scan steps are ~us each, padding is cheap);
    # longer streams fall into power-of-2 buckets
    cap = max(4096, 1 << int(np.ceil(np.log2(max(n, 1)))))
    last_iy = iyaw[np.nonzero(~is_wheel)[0][-1]] if (~is_wheel).any() else 0.0
    return pad_tape_chunk(stamps, is_wheel, xy, wyaw, iyaw, cap,
                          float(last_iy))


class EkfReplayResult(NamedTuple):
    stamps: jax.Array   # (E,) event stamps
    states: jax.Array   # (E, 3) fused [x, y, yaw] after each event
    emitted: jax.Array  # (E,) bool — True where a wheel event pushed odometry


def _ekf_step(carry, ev):
    """One event of the fused replay scan (shared by the whole-tape and
    chunked paths) — bit-level parity with the streaming proxy (same init,
    gating, dt bookkeeping and update order)."""
    f32 = jnp.float32
    sys_var = jnp.asarray(SYS_STD ** 2, f32)
    imu_var = jnp.asarray(IMU_STD ** 2, f32)
    wheel_var = jnp.asarray(WHEEL_STD ** 2, f32)
    H_imu = jnp.asarray(_H_IMU, f32)
    H_wheel = jnp.asarray(_H_WHEEL, f32)
    P0 = jnp.diag(jnp.asarray(PRIOR_STD ** 2, f32))

    def wrap(a, ref):
        return a - 2.0 * jnp.pi * jnp.round((a - ref) / (2.0 * jnp.pi))

    def rel2d(ax, ay, ayaw, bx, by, byaw):
        """xy of A^-1 * B for planar poses."""
        c, s = jnp.cos(ayaw), jnp.sin(ayaw)
        dx, dy = bx - ax, by - ay
        return c * dx + s * dy, -s * dx + c * dy, byaw - ayaw

    (x, P, imu_init, wheel_init, upd_flag,
     imu_t, imu_yaw_prev, wheel_t, wx_prev, wy_prev, wyaw_prev) = carry
    stamp, is_wheel, exy, wyaw, iyaw = ev

    def do_imu(_):
        def init(_):
            x2 = x.at[2].set(iyaw)
            return (x2, P0, True, wheel_init, upd_flag,
                    stamp, iyaw, wheel_t, wx_prev, wy_prev, wyaw_prev), x2, False

        def update(_):
            dt = stamp - imu_t
            dyaw = wrap(iyaw - imu_yaw_prev, 0.0)  # relative yaw via quats == wrapped diff
            z = wrap(x[2] + dyaw, x[2])
            x2, P2 = ekf_update(x, P, jnp.array([z]), H_imu, imu_var, dt)
            return (x2, P2, imu_init, wheel_init, False,
                    stamp, iyaw, wheel_t, wx_prev, wy_prev, wyaw_prev), x2, False

        def skip(_):
            return (x, P, imu_init, wheel_init, upd_flag,
                    imu_t, imu_yaw_prev, wheel_t, wx_prev, wy_prev, wyaw_prev), x, False

        return jax.lax.cond(
            ~imu_init, init,
            lambda o: jax.lax.cond(upd_flag, update, skip, o), None)

    def do_wheel(_):
        def init(_):
            x2 = x.at[0].set(exy[0]).at[1].set(exy[1])
            return (x2, P0, imu_init, True, upd_flag,
                    imu_t, imu_yaw_prev, stamp, exy[0], exy[1], wyaw), x2, False

        def update(_):
            dt = stamp - wheel_t
            P1 = ekf_predict(P, dt, sys_var)
            # delta = state_pose * (last_wheel^-1 * cur_wheel); z = delta.xy
            rx, ry, _ = rel2d(wx_prev, wy_prev, wyaw_prev, exy[0], exy[1], wyaw)
            c, s = jnp.cos(x[2]), jnp.sin(x[2])
            z = jnp.array([x[0] + c * rx - s * ry, x[1] + s * rx + c * ry])
            x2, P2 = ekf_update(x, P1, z, H_wheel, wheel_var, dt)
            return (x2, P2, imu_init, wheel_init, True,
                    imu_t, imu_yaw_prev, stamp, exy[0], exy[1], wyaw), x2, True

        return jax.lax.cond(~wheel_init, init, update, None)

    new_carry, xs, emitted = jax.lax.cond(is_wheel, do_wheel, do_imu, None)
    return new_carry, (xs, emitted)


def ekf_carry0():
    """Initial replay carry (pre-init filter, matching EkfOdomProxy ctor)."""
    f32 = jnp.float32
    P0 = jnp.diag(jnp.asarray(PRIOR_STD ** 2, f32))
    return (jnp.zeros(3, f32), P0, jnp.bool_(False), jnp.bool_(False),
            jnp.bool_(False), f32(-1.0), f32(0.0), f32(-1.0), f32(0.0),
            f32(0.0), f32(0.0))


@jax.jit
def ekf_replay_chunk(carry, tape: EkfTape):
    """Fuse one tape chunk, carrying the filter state across chunks — the
    incremental form of ``ekf_replay`` (same step function, so
    chunked-vs-whole results are bit-identical). Lets lio mode fuse the
    sensor stream lazily alongside the scan batches instead of paying an
    O(stream) serial head before the first scan (the reference's proxy
    streams with no head, EkfOdomProxy.cpp:185-248)."""
    carry, (states, emitted) = jax.lax.scan(
        _ekf_step, carry,
        (tape.stamps, tape.is_wheel, tape.wheel_xy, tape.wheel_yaw,
         tape.imu_yaw))
    return carry, EkfReplayResult(tape.stamps, states, emitted)


@jax.jit
def ekf_replay(tape: EkfTape) -> EkfReplayResult:
    """Fuse the whole tape in one scan (see ``_ekf_step`` for semantics)."""
    _, res = ekf_replay_chunk(ekf_carry0(), tape)
    return res


def replay_to_odometry(res: EkfReplayResult) -> list:
    """Convert emitted replay states to host Odometry entries (wheel rate)."""
    stamps = np.asarray(res.stamps, np.float64)
    states = np.asarray(res.states, np.float64)
    emitted = np.asarray(res.emitted)
    return [
        Odometry(float(stamps[i]), _pose2d(states[i, 0], states[i, 1], states[i, 2]))
        for i in np.nonzero(emitted)[0]
    ]
