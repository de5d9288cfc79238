"""Adversarial-geometry tests: tilted surfaces, outliers, slopes, degeneracy.

The standard simulator world is axis-aligned — the best case point-to-plane
LOAM can see. These tests break that kindness:
- a world whose plane normals span the sphere (tilted faces + slabs),
- spurious returns / dropout in the scan,
- a sloped world where z/roll/pitch carry real signal (planar clamp OFF),
- a corridor whose along-axis translation is unobservable — the degeneracy
  guard (ops/loam.py DEGEN_EIGEN_FLOOR, the reference's
  _removeDegeneratePart intent, PCR/src/LoamRegister.cpp:209-218) must keep
  the estimate pinned to its prediction instead of wandering.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from simpleslam_tpu.ops import loam
from simpleslam_tpu.ops import pointcloud as pcops
from simpleslam_tpu.ops import voxel as vox
from simpleslam_tpu.pipeline import simulate as sim


def build_dense_fixture(world, map_poses, rng, **scan_kw):
    clouds = []
    for mp in np.asarray(map_poses).reshape(-1, 4, 4):
        scan = sim.simulate_scan(world, sim.sensor_from_body(mp), rng=rng,
                                 **scan_kw)
        R, t = mp[:3, :3], mp[:3, 3]
        clouds.append((scan @ R.T + t).astype(np.float32))
    merged = pcops.from_numpy(np.concatenate(clouds), 98304)
    ds = pcops.compact(vox.voxel_downsample(merged, 0.5), 32768)
    center = jnp.asarray(np.asarray(map_poses).reshape(-1, 4, 4)[0][:3, 3]
                         .astype(np.float32))
    return vox.build_dense_voxel_map(ds, 2.0, center, dims=(48, 48, 12),
                                     slab_size=24)


def pose_error(T_est, T_gt):
    d = np.linalg.inv(np.asarray(T_gt)) @ np.asarray(T_est)
    trans = np.linalg.norm(d[:3, 3])
    rot = np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
    return trans, rot


def test_tilted_world_full_se3(rng):
    """Every surface tilted: registration must still recover full SE(3)."""
    world = sim.make_adversarial_world(seed=5)
    _, poses = sim.make_trajectory(40, 0.1, speed=1.5)
    map_poses = [poses[10], poses[17], poses[24]]
    T_b = poses[20]
    vm = build_dense_fixture(world, map_poses, rng)
    scan = sim.simulate_scan(world, sim.sensor_from_body(T_b), rng=rng)
    ds = pcops.compact(vox.voxel_downsample(
        pcops.from_numpy(scan, 32768), 0.5), 8192)
    guess = T_b.copy()
    guess[:3, 3] += [0.2, -0.15, 0.05]
    res = loam.scan2map(ds, vm, jnp.asarray(guess.astype(np.float32)))
    assert bool(res.converged)
    trans, rot = pose_error(res.pose, T_b)
    assert trans < 0.08, trans
    assert rot < 0.015, rot


def test_outliers_and_dropout(rng):
    """5% spurious returns + 10% dropout: the distance/plane gates + the
    weight s = 1 - 0.9|d|/sqrt(r) must keep registration on track."""
    world = sim.make_world(seed=4)
    _, poses = sim.make_trajectory(40, 0.1, speed=1.5)
    map_poses = [poses[10], poses[17], poses[24]]
    T_b = poses[20]
    vm = build_dense_fixture(world, map_poses, rng)
    scan = sim.simulate_scan(world, sim.sensor_from_body(T_b), rng=rng,
                             outlier_frac=0.05, dropout_frac=0.10)
    ds = pcops.compact(vox.voxel_downsample(
        pcops.from_numpy(scan, 32768), 0.5), 8192)
    guess = T_b.copy()
    guess[:3, 3] += [0.2, -0.15, 0.0]
    res = loam.scan2map(ds, vm, jnp.asarray(guess.astype(np.float32)))
    assert bool(res.converged)
    trans, rot = pose_error(res.pose, T_b)
    assert trans < 0.08, trans
    assert rot < 0.015, rot


def _sloped_poses(world, n, slope_deg):
    """Trajectory riding the sloped ground (z follows the incline)."""
    _, poses = sim.make_trajectory(n, 0.1, speed=1.5, radius=30.0)
    nrm = np.cross(world.patches[0].u, world.patches[0].v)
    for p in poses:
        p[2, 3] = -(nrm[0] * p[0, 3] + nrm[1] * p[1, 3]) / nrm[2]
    return poses


def test_sloped_world_registration_holds_attitude(rng):
    """On a 6-degree incline, z must come from registration (clamp off)."""
    world = sim.make_sloped_world(seed=6, slope_deg=6.0)
    poses = _sloped_poses(world, 40, 6.0)
    map_poses = [poses[10], poses[17], poses[24]]
    T_b = poses[20].copy()
    vm = build_dense_fixture(world, map_poses, rng)
    scan = sim.simulate_scan(world, sim.sensor_from_body(T_b), rng=rng)
    ds = pcops.compact(vox.voxel_downsample(
        pcops.from_numpy(scan, 32768), 0.5), 8192)
    guess = T_b.copy()
    guess[:3, 3] += [0.2, -0.15, 0.1]  # includes a z error to pull out
    res = loam.scan2map(ds, vm, jnp.asarray(guess.astype(np.float32)))
    assert bool(res.converged)
    trans, rot = pose_error(res.pose, T_b)
    assert trans < 0.1, trans
    assert abs(np.asarray(res.pose)[2, 3] - T_b[2, 3]) < 0.05


def test_sloped_world_pipeline_ate(rng):
    """End-to-end lo mapping on the slope with planar_clamp off: ATE < 0.1 m
    (the flat-world ATE claims must not ride the clamp defining z away)."""
    from simpleslam_tpu.pipeline import app
    from simpleslam_tpu.pipeline.streamed import run_streamed
    from simpleslam_tpu.utils.config import Params

    world = sim.make_sloped_world(seed=6, slope_deg=6.0)
    poses = _sloped_poses(world, 30, 6.0)
    stamps = np.arange(30) * 0.1
    scans = [sim.simulate_scan(world, sim.sensor_from_body(poses[i]), rng=rng)
             for i in range(30)]
    streams = sim.SensorStreams(
        stamps, scans, poses, np.zeros(0), np.zeros((0, 4, 4)),
        np.zeros(0), np.zeros((0, 4)))
    Params.load({"mode": "lo", "backend": {"enable": False},
                 "frontend": {"pcr": "loam", "planar_clamp": False}})
    system = app.SlamSystem()
    result = run_streamed(system, streams, sync_every=8)
    ate = sim.ate_rmse(poses, result.poses, align=False)
    assert ate < 0.1, ate
    # z must actually track the slope (not be defined away by a clamp)
    z_est = result.poses[:, 2, 3]
    z_gt = poses[:, 2, 3]
    assert np.ptp(z_gt) > 0.3
    assert np.max(np.abs(z_est - z_gt)) < 0.15


def test_corridor_degeneracy_guard(rng):
    """Long corridor: x-translation is unobservable. The eigenvalue floor
    must pin the x estimate to its prediction (init), not let it wander, and
    the observable directions must still converge."""
    world = sim.make_corridor_world()
    base = np.eye(4)
    base[0, 3] = 5.0
    map_poses = []
    for dx in (0.0, 2.0, 4.0):
        p = base.copy()
        p[0, 3] += dx
        map_poses.append(p)
    T_b = base.copy()
    T_b[0, 3] = 8.0
    vm = build_dense_fixture(world, map_poses, rng)
    scan = sim.simulate_scan(world, sim.sensor_from_body(T_b), rng=rng)
    ds = pcops.compact(vox.voxel_downsample(
        pcops.from_numpy(scan, 32768), 0.5), 8192)
    guess = T_b.copy()
    guess[:3, 3] += [0.5, 0.15, 0.08]  # x offset is unobservable here
    res = loam.scan2map(ds, vm, jnp.asarray(guess.astype(np.float32)),
                        degen_per_row=loam.DEGEN_EIGEN_PER_ROW)
    est = np.asarray(res.pose)
    # observable directions recovered
    assert abs(est[1, 3] - T_b[1, 3]) < 0.05, est[1, 3]
    assert abs(est[2, 3] - T_b[2, 3]) < 0.05, est[2, 3]
    # degenerate direction stays at the prediction (within a small drift),
    # i.e. the guard kept GN from inventing motion along the corridor
    assert abs(est[0, 3] - guess[0, 3]) < 0.2, (est[0, 3], guess[0, 3])
    # and it did not diverge
    assert np.linalg.norm(est[:3, 3] - T_b[:3, 3]) < 1.0
    # control: without the guard the x estimate wanders off its prediction
    res_ng = loam.scan2map(ds, vm, jnp.asarray(guess.astype(np.float32)))
    est_ng = np.asarray(res_ng.pose)
    assert abs(est_ng[0, 3] - guess[0, 3]) > abs(est[0, 3] - guess[0, 3])


def test_corridor_pipeline_does_not_diverge():
    """A straight corridor run, lio mode (wheel odometry supplies the
    unobservable x — the realistic degenerate deployment) with
    frontend.degeneracy_guard on: the constrained directions must track
    tightly and x must ride the wheel prediction (bounded by slip drift, no
    invented motion, no lateral/yaw corruption)."""
    from simpleslam_tpu.pipeline import app
    from simpleslam_tpu.pipeline.streamed import run_streamed
    from simpleslam_tpu.utils.config import Params

    world = sim.make_corridor_world()
    n = 30
    streams = sim.simulate_sequence(world, n_scans=n, speed=1.5, loop=False,
                                    seed=2)
    Params.load({"mode": "lio", "backend": {"enable": False},
                 "frontend": {"pcr": "loam", "degeneracy_guard": True}})
    system = app.SlamSystem()
    result = run_streamed(system, streams, sync_every=8)
    err = result.poses[:, :3, 3] - streams.gt_poses[:, :3, 3]
    assert np.max(np.abs(err[:, 1])) < 0.1, "lateral corrupted"
    assert np.max(np.abs(err[:, 2])) < 0.1, "vertical corrupted"
    # x bounded by wheel drift (~1% slip over 4.3 m + noise), not divergence
    assert np.max(np.abs(err[:, 0])) < 0.5, "along-corridor diverged"
    yaw_err = np.abs(
        np.arctan2(result.poses[:, 1, 0], result.poses[:, 0, 0])
        - np.arctan2(streams.gt_poses[:, 1, 0], streams.gt_poses[:, 0, 0]))
    assert np.max(yaw_err) < 0.03


def test_forest_world_with_dynamic_objects():
    """End-to-end lo mapping in the forest world (curved trunks +
    probabilistic vegetation scatter) with moving obstacles crossing the
    path: the non-planar, non-static regime planar box worlds never
    exercise (the anti-self-confirmation world)."""
    from simpleslam_tpu.pipeline import app
    from simpleslam_tpu.pipeline.streamed import run_streamed
    from simpleslam_tpu.utils.config import Params

    world = sim.make_forest_world(seed=3)
    assert len(world.cylinders) > 30 and len(world.blobs) > 50
    streams = sim.simulate_sequence(world, n_scans=40, seed=2, n_az=600,
                                    n_el=12, n_dynamic=4)
    Params.load({"mode": "lo", "backend": {"enable": False},
                 "frontend": {"pcr": "loam", "degeneracy_guard": True}})
    system = app.SlamSystem()
    result = run_streamed(system, streams, sync_every=8)
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    assert ate < 0.15, ate
    assert result.converged_frac > 0.9


def test_dynamic_objects_actually_appear_in_scans():
    """Moving boxes must change scan GEOMETRY over time (their hits occlude
    the static world behind them, so raw return counts stay ~equal — the
    guard measures displaced points instead)."""
    world = sim.make_world(seed=0, n_buildings=0)
    np.random.default_rng(5)
    # direct probe: one box in front of the sensor displaces returns
    extra = sim._box_patches(3.0, 0.0, 0.3, 0.5, 0.5, 1.8)
    s0 = sim.simulate_scan(world, sim.sensor_from_body(np.eye(4)), n_az=600,
                           n_el=8, noise=0.0, rng=np.random.default_rng(1))
    s1 = sim.simulate_scan(world, sim.sensor_from_body(np.eye(4)), n_az=600,
                           n_el=8, noise=0.0, rng=np.random.default_rng(1),
                           extra_patches=extra)
    near_box = np.sum(np.linalg.norm(s1[:, :2] - [3.0, 0.0], axis=1) < 0.6)
    assert near_box > 20, near_box  # box returns present
    assert len(s0) == len(s1)       # occlusion, not extra rays
    moved = np.sum(np.linalg.norm(s0 - s1, axis=1) > 0.5)
    assert moved > 20, moved        # static hits displaced by the box

    # sequence plumbing: dynamic scans differ from static, differently per scan
    st_static = sim.simulate_sequence(world, n_scans=6, seed=5, n_az=600,
                                      n_el=8, scan_noise=0.0)
    st_dyn = sim.simulate_sequence(world, n_scans=6, seed=5, n_az=600,
                                   n_el=8, scan_noise=0.0, n_dynamic=5)
    moved = []
    for s, d in zip(st_static.scans, st_dyn.scans):
        n = min(len(s), len(d))
        moved.append(int(np.sum(np.linalg.norm(s[:n] - d[:n], axis=1) > 0.5)))
    assert max(moved) > 20, moved
    assert len(set(moved)) > 1, moved  # clutter changes over time
