"""Streamed executor: parity with the classic per-scan path (lo mode).

The streamed executor (pipeline/streamed.py) is the device-resident
odometry loop: device-resident pose chain, one host sync per batch. Its
trajectory must match the classic reference-faithful path's quality; its
keyframe/map bookkeeping must function with batch lag."""

import numpy as np
import pytest

from simpleslam_tpu.pipeline import app, simulate as sim
from simpleslam_tpu.pipeline.streamed import run_streamed
from simpleslam_tpu.utils.config import Params


def _run(mode_streamed: bool, n_scans: int = 45, backend: bool = False):
    Params.load({"mode": "lo",
                 "backend": {"enable": backend},
                 "frontend": {"pcr": "loam"},
                 "tpu": {"scan_capacity": 16384}})
    world = sim.make_world(seed=3)
    streams = sim.cache_streams(
        f"str{n_scans}s3",
        lambda: sim.simulate_sequence(world, n_scans=n_scans, seed=3))
    system = app.SlamSystem()
    if mode_streamed:
        result = run_streamed(system, streams, sync_every=8)
    else:
        result = app.run_offline(system, streams)
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    return result, ate


def test_streamed_matches_classic_quality():
    r_stream, ate_stream = _run(True)
    r_classic, ate_classic = _run(False)
    assert ate_stream < 0.25, ate_stream
    # batch-lagged keyframing may shift keyframe placement slightly but the
    # trajectory quality must stay in the same class
    assert ate_stream < max(2.5 * ate_classic, 0.15), (ate_stream, ate_classic)
    assert r_stream.keyframe_count >= r_classic.keyframe_count - 2
    assert r_stream.converged_frac > 0.9


def test_streamed_with_backend():
    r, ate = _run(True, backend=True)
    assert ate < 0.25, ate
    assert r.keyframe_count > 3


def test_streamed_lio():
    """lio mode rides the device chain: the whole EKF stream is fused up
    front (ekf_replay) and the odom2map loose coupling stays on device."""
    Params.load({"mode": "lio",
                 "backend": {"enable": False},
                 "frontend": {"pcr": "loam"},
                 "tpu": {"scan_capacity": 16384}})
    world = sim.make_world(seed=1)
    streams = sim.cache_streams(
        "str30s1", lambda: sim.simulate_sequence(world, n_scans=30, seed=1))
    system = app.SlamSystem()
    r = run_streamed(system, streams, sync_every=8)
    ate = sim.ate_rmse(streams.gt_poses, r.poses, align=False)
    assert ate < 0.3, ate
    assert r.converged_frac > 0.85
    assert r.keyframe_count > 2


def test_streamed_sync_backend_deterministic():
    """tpu.sync_backend services backend+LC inline at batch boundaries:
    the result must be reproducible bit-for-bit across runs (accuracy as a
    pure function of the data — the round-5 longrun stability mode) and in
    the same quality class as the async worker path."""
    def once():
        Params.load({"mode": "lo",
                     "backend": {"enable": True, "lc": {"enable": False}},
                     "frontend": {"pcr": "loam"},
                     "tpu": {"scan_capacity": 16384, "sync_backend": True}})
        world = sim.make_world(seed=3)
        streams = sim.cache_streams(
            "str30det3",
            lambda: sim.simulate_sequence(world, n_scans=30, seed=3))
        system = app.SlamSystem()
        r = run_streamed(system, streams, sync_every=8)
        return streams, r

    streams, r1 = once()
    _, r2 = once()
    np.testing.assert_array_equal(r1.poses, r2.poses)
    ate = sim.ate_rmse(streams.gt_poses, r1.poses, align=False)
    assert ate < 0.25, ate
    assert r1.keyframe_count > 3


def test_velocity_step_cap_bounds_runaway_chain():
    """The const-velocity extrapolator must never amplify a chain
    inconsistency without bound: seed the device chain with two poses
    disagreeing by 100 m and run a batch against an EMPTY-ish target (every
    scan starved, results rejected by the finiteness path or registration
    no-op) — the chain must advance at most STEP_CAP per scan, not
    compound."""
    import jax.numpy as jnp

    from simpleslam_tpu.pipeline.streamed import (_streamed_batch, STEP_CAP,
                                                  UPLOAD_PAD)
    from simpleslam_tpu.models.registration import make_register
    from simpleslam_tpu.ops import pointcloud as pcops

    Params.load({"mode": "lo", "backend": {"enable": False},
                 "frontend": {"pcr": "loam"}})
    reg = make_register()
    # tiny, far-away target: queries find nothing
    far = np.full((64, 3), 500.0, np.float32)
    target = reg.build_target(pcops.from_numpy(far, 128),
                              jnp.asarray(far[0]))
    rows = np.full((4, 256, 3), UPLOAD_PAD, np.int16)
    rows[:, :32] = 100  # a few valid points near 0.38 m
    eye = np.eye(4, dtype=np.float32)
    p_prev = eye.copy()
    p_prev2 = eye.copy()
    p_prev[:3, 3] = [100.0, 0, 0]   # 100 m disagreement with prev2
    (pN, pN1, _), packed = _streamed_batch(
        jnp.asarray(rows), jnp.asarray(np.tile(eye, (4, 1, 1))), target,
        jnp.asarray(p_prev), jnp.asarray(p_prev2), jnp.asarray(eye),
        kind="loam", mode="lo", clamp=True, degen=0.0, jump_cap=0.0)
    # without the cap the chain would be at 100*2^4-class magnitudes;
    # with it, growth is bounded by STEP_CAP per scan
    final = np.asarray(pN)[:3, 3]
    assert np.isfinite(final).all()
    assert np.linalg.norm(final) <= 100.0 + 4 * STEP_CAP + 1e-3
