"""Multi-lap loop-closure pipeline (sustained revisit density).

Split from test_pipeline_lc.py so the two module-scoped pipeline fixtures
land on different xdist workers (each is the file's dominant cost).
"""

import numpy as np
import pytest

from simpleslam_tpu.models.backend import LC_VAR
from simpleslam_tpu.pipeline import app, simulate as sim
from simpleslam_tpu.pipeline.streamed import run_streamed
from simpleslam_tpu.utils.config import Params

from test_pipeline_lc import RADIUS, _gt_pose_at


@pytest.fixture(scope="module")
def multi_loop_run():
    """~3 spiral laps of the courtyard: real revisit density (every lap
    passes every map region ~1.8 m to the side, so the LC worker sees a
    sustained candidate stream — the regime where the r2 review flagged
    unbounded lag and silent queue overflow)."""
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
    # 400 scans = ~2.3 spiral laps: same sustained revisit density, ~30 %
    # less inline backend service time than the original 540
    streams = sim.cache_streams(
        "lc_spiral400", lambda: sim.spiral_sequence(
            world, n_scans=400, r0=7.0, step=0.33, n_az=720, n_el=12,
            noise=0.03, seed=2))
    system = app.SlamSystem()
    # 32-scan batches: halves per-batch host overhead on this long fixture
    # (the bench's production setting; assertions are batch-size-agnostic)
    result = run_streamed(system, streams, sync_every=32)
    return streams, system, result


@pytest.mark.slow
def test_multi_loop_closures_accepted(multi_loop_run):
    """>= 3 closures accepted over 3 laps, none dropped on queue overflow."""
    _, system, result = multi_loop_run
    assert system.backend.n_lc_edges >= 3, system.backend.n_lc_edges
    assert system.loop_closure.dropped_closures == 0
    assert result.converged_frac > 0.9


@pytest.mark.slow
def test_multi_loop_betweens_correct(multi_loop_run):
    """Every accepted closure's between is geometrically right (amortized
    target caching must not serve stale geometry)."""
    streams, system, _ = multi_loop_run
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
        assert np.linalg.norm(err[:3, 3]) < 0.3, n
        checked += 1
    assert checked >= 3


@pytest.mark.slow
def test_multi_loop_map_consistent(multi_loop_run):
    """Post-solve keyframe map stays metrically consistent over 3 laps:
    no worse than the raw odometry at the same stamps, and bounded
    absolutely (~0.1% of the 215 m trajectory)."""
    streams, system, result = multi_loop_run
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
    assert ate_post < 0.3, ate_post
