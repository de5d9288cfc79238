"""End-to-end loop closure: a full mapping run detects and corrects drift.

The ``test/lcm.cpp`` + live-slam analogue (SURVEY.md §4): replay a closed
loop long enough to trigger ``numExcludeRecent``-eligible revisits through
the streamed executor with the backend AND the LoopClosureManager enabled,
and assert the whole ScanContext → VGICP-verify → pose-graph chain ran:
a loop-closure factor entered the graph, the accepted between matches the
ground-truth relative pose, and the post-solve keyframe trajectory is no
worse than the raw odometry at the same stamps.

World: ``simulate.make_courtyard``, a ring of buildings around a small
circular loop — close-range structure keeps scan-to-map registration
converged on a loop small enough to close within test budget (the default
park world is empty near the origin, so small loops drift unrecoverably
there).
"""

import numpy as np
import pytest

from simpleslam_tpu.models.backend import LC_VAR
from simpleslam_tpu.pipeline import app, simulate as sim
from simpleslam_tpu.pipeline.streamed import run_streamed
from simpleslam_tpu.utils.config import Params

RADIUS = 8.0
SPEED = 3.0
N_SCANS = 200  # theta = SPEED*t/RADIUS = 7.5 rad > 2*pi: the loop closes


@pytest.fixture(scope="module")
def lc_run():
    Params.load({
        "mode": "lo",
        "frontend": {"pcr": "loam"},
        # the courtyard world spans +-40 m: the default +-96 m registration
        # window wastes 5x the voxel rows of CPU build work per rebuild.
        # sync_backend: offline replay services backend+LC inline, so the
        # closure funnel (and these assertions) are deterministic instead
        # of riding worker-thread timing
        "tpu": {"dense_grid_dims": [128, 128, 32], "sync_backend": True},
        "backend": {
            "enable": True,
            "lc": {"enable": True, "historySubmapRange": 2,
                   "fitnessThreshold": 0.3},
            "context": {"used": "scancontext",
                        "scancontext": {"numExcludeRecent": 15,
                                        "numCandidatesFromTree": 5,
                                        "scDistThres": 0.4,
                                        "buildTreeGap": 5,
                                        "searchRatio": 0.1}},
        },
    })
    world = sim.make_courtyard(RADIUS, seed=0)
    streams = sim.cache_streams(
        "lc_courtyard", lambda: sim.simulate_sequence(
            world, n_scans=N_SCANS, seed=2, radius=RADIUS, speed=SPEED,
            n_az=720, n_el=12, scan_noise=0.03))
    system = app.SlamSystem()
    result = run_streamed(system, streams)
    return streams, system, result


def _gt_pose_at(streams, stamp: float) -> np.ndarray:
    i = int(np.argmin(np.abs(streams.scan_stamps - stamp)))
    return streams.gt_poses[i]


def test_mapping_stays_converged(lc_run):
    streams, system, result = lc_run
    assert result.converged_frac > 0.9
    ate = sim.ate_rmse(streams.gt_poses, result.poses, align=False)
    assert ate < 0.1, ate


def test_lc_factor_entered_graph(lc_run):
    """The ScanContext->VGICP->backend chain accepted >= 1 revisit closure."""
    _, system, _ = lc_run
    assert system.backend.n_lc_edges >= 1
    # the factors are in the graph with the LC noise model
    lc_rows = [n for n, var in enumerate(system.backend.edge_var)
               if np.allclose(var, LC_VAR)]
    assert len(lc_rows) == system.backend.n_lc_edges


def test_lc_between_matches_ground_truth(lc_run):
    """Accepted LC betweens are geometrically correct (VGICP verification
    did its job): compare against the ground-truth relative pose of the two
    keyframes' stamps."""
    streams, system, _ = lc_run
    be = system.backend
    kfs = system.map_manager.kf_obj.keyframes
    checked = 0
    for n in range(len(be.edge_i)):
        if not np.allclose(be.edge_var[n], LC_VAR):
            continue
        i, j = be.edge_i[n], be.edge_j[n]
        gt_between = np.linalg.inv(_gt_pose_at(streams, kfs[i].stamp)) @ \
            _gt_pose_at(streams, kfs[j].stamp)
        err = np.linalg.inv(gt_between) @ be.edge_T[n]
        t_err = np.linalg.norm(err[:3, 3])
        r_err = np.arccos(np.clip((np.trace(err[:3, :3]) - 1) / 2, -1, 1))
        assert t_err < 0.3, (n, t_err)
        assert r_err < np.deg2rad(5.0), (n, np.rad2deg(r_err))
        checked += 1
    assert checked >= 1


def test_post_solve_keyframes_consistent(lc_run):
    """Post-closure keyframe poses match ground truth at least as well as
    the raw odometry estimates at the same stamps (the correction broadcast
    must never make the map worse; with drift present it improves it)."""
    streams, system, result = lc_run
    kfs = system.map_manager.kf_obj.keyframes
    stamps = np.array([kf.stamp for kf in kfs])
    idx = np.array([int(np.argmin(np.abs(streams.scan_stamps - s)))
                    for s in stamps])
    gt = streams.gt_poses[idx][:, :3, 3]
    post = np.stack([kf.pose for kf in kfs])[:, :3, 3]
    raw = result.poses[idx][:, :3, 3]
    ate_post = float(np.sqrt(np.mean(np.sum((gt - post) ** 2, axis=1))))
    ate_raw = float(np.sqrt(np.mean(np.sum((gt - raw) ** 2, axis=1))))
    assert ate_post <= ate_raw + 0.02, (ate_post, ate_raw)
    assert ate_post < 0.1, ate_post
