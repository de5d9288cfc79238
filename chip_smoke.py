"""Smoke run of the streamed SLAM pipeline on the GPU.

    python chip_smoke.py          # one card: phases a-f below
    python chip_smoke.py --four   # four cards: the mesh path and its reference

One process drives the card(s). Each phase prints one JSON object; a phase
that fails prints its error and the run continues, so one call reports every
fault. The line before the last is the card's name and power limit from
nvidia-smi; the last line is ``{"ok": ..., "device": {...}}``. The exit code
is 0 only if every phase passed. With no GPU the run stops at the device
check with a non-zero exit code: there is no CPU fallback.

Phases (one card):
  a. device: platform guard, card, JAX version, compile cache, native lib
  b. mapping: the served path (``SlamSystem`` + ``run_streamed``, backend
     and loop closure on) at production capacities, VLP-16-class sensor
     (16 x 1800 rays at 10 Hz), ~2.1 laps of the courtyard until loops
     close; run twice (cold, then warm and timed) and compared bit for bit
  c. cli: ``pipeline.app.main --synthetic --streamed`` writes its artifacts
  d. kernels: short streamed runs with NDT, VGICP and lio mode
  e. parity: ``run_offline`` (reference-faithful per-scan path) against
     ``run_streamed`` on the same prefix
  f. numerics: one streamed registration batch and the dense and PCG
     pose-graph solves, GPU against CPU in this process, plus GPU repeats

Phases (--four):
  mesh: phase b's workload with ``tpu.mesh_devices: 4`` against card 0 alone
  sharded_solve: ``parallel.dist_posegraph.sharded_solve`` in its three
     modes at K = 2048 against the single-device solve
"""

import os

# phase f compares against the CPU backend in this process: keep it
# available when the environment names the platforms explicitly
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ["JAX_PLATFORMS"]:
    os.environ["JAX_PLATFORMS"] += ",cpu"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

from simpleslam_tpu.utils.device import nvidia_smi, require_gpu  # noqa: E402

# Workload sizes. Capacities are the utils/config.py defaults throughout.
SIZES = {
    "n_az": 1800, "n_el": 16,    # VLP-16 class: 16 rings x 1800 azimuths
    "map_scans": 400,            # courtyard spiral: 120 m, ~2.1 laps
    "cli_scans": 120,
    "kernel_scans": 64,
    "parity_scans": 48,
    "batch_scans": 32,           # one streamed registration batch
    "degen_scans": 8,            # the eigh (degeneracy guard) batch variant
    "solve_ks": (512, 2048),     # dense branch, PCG branch
}

# ATE bounds (m), each from the CPU test of the same path
ATE_MAP = 0.25     # tests/test_streamed.py (streamed executor, backend on)
ATE_KERNEL = 0.3   # tests/test_ndt_vgicp.py (ndt/vgicp swap), test_streamed lio
# GPU-vs-CPU tolerances, each set between the differences of sound runs and
# those of a control run with float32 matmuls on TF32 (H100 80GB HBM3):
# - registration batch (max over scans): sound 5 µm - 0.67 mm, TF32 and
#   bf16 controls 1.7 - 2.8 mm. GN stops once its step is below 5 mm
#   (ops/loam.py POS_CONVERGE), so sums in another order move the stopping
#   point by up to a millimetre and the window is narrow: 1.5 mm.
# - pose-graph solves: sound 7 - 21 µm, TF32 45 - 93 mm: 1 mm.
# - PCG solve cost (K = 2048, chi2 ~34): sound within 3.4e-6 relative,
#   TF32 3.4e-2: 1e-4. The dense solve converges to chi2 ~1e-7 from ~2e4,
#   the float32 rounding floor of its residual sum, where sound GPU and
#   CPU costs differ by up to 36 %: its cost is printed, not compared.
TOL_BATCH_M = 1.5e-3
TOL_SOLVE_M = 1e-3
TOL_SOLVE_COST_REL = 1e-4
# shard_cg exits PCG on the previous iteration's residual, so at K = 2048,
# where 64 CG iterations stop far short of the optimum, it stops at another
# point: 8.2 mm and 1.6e-3 relative cost from the single-device solve, on
# the GPU as on the CPU. The other two modes run the single solve's
# iteration and meet TOL_SOLVE_M.
TOL_SHARD_CG_M = 0.02
TOL_SHARD_CG_COST_REL = 0.01
# Mesh parity. Point-sharded registration sums its normal equations in
# another order, so each GN stops at a slightly different point inside the
# 5 mm step threshold; over hundreds of scans these equally valid estimates
# random-walk apart (on 4 virtual CPU devices: 1e-6 m after 48 scans,
# 6.6 mm by scan 100, 27 mm by scan 250 with closures, both runs at ~10 mm
# ATE). So absolute parity at __graft_entry__.dryrun_multichip's 5 mm bound
# is checked over the first PARITY_SCANS scans, and over the whole run the
# two trajectories must be equally accurate (ATEs within 5 mm) and stay
# within TOL_MESH_WHOLE_M of each other. Two whole runs of this workload on
# ONE card already end 1.5-15.5 mm apart (scatter-add order, see phase f);
# the mesh adds the point-sharded sums and the sharded PCG backend solve,
# so the bound is about three times that largest single-card spread — and
# still a fifth of the ATE bound.
TOL_MESH_M = 5e-3
TOL_MESH_WHOLE_M = 0.05


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def mapping_config():
    """Phase b's configuration: the courtyard deployment of
    tests/test_pipeline_lc.py (closure thresholds and ScanContext settings)
    at production capacities, backend serviced inline so the closure
    funnel is deterministic."""
    cfg = {
        "mode": "lo", "frontend": {"pcr": "loam"}, "saveMapDir": "",
        "tpu": {"sync_backend": True},
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
    }
    return cfg


def courtyard_streams(n_scans):
    """Outward spiral through the courtyard (tests/test_pipeline_lc_multi.py):
    every lap passes the previous one ~1.8 m to the side, so keyframes keep
    being admitted and loop closure sees a sustained revisit stream. An
    exact retrace of the circle admits no keyframe after lap one, which
    leaves two closure chances in the whole run."""
    from simpleslam_tpu.pipeline import simulate as sim

    world = sim.make_courtyard(8.0, seed=0)
    return sim.spiral_sequence(world, n_scans, r0=7.0, step=0.3,
                               n_az=SIZES["n_az"], n_el=SIZES["n_el"],
                               noise=0.03, seed=2)


def world_streams(seed, n_scans):
    from simpleslam_tpu.pipeline import simulate as sim

    return sim.simulate_sequence(sim.make_world(seed=seed), n_scans=n_scans,
                                 seed=seed, n_az=SIZES["n_az"],
                                 n_el=SIZES["n_el"])


def lidar_prefix(streams, n):
    """The first ``n`` scans of a stream, without wheel or IMU data."""
    from simpleslam_tpu.pipeline import simulate as sim

    return sim.SensorStreams(streams.scan_stamps[:n], streams.scans[:n],
                             streams.gt_poses[:n], streams.wheel_stamps[:0],
                             streams.wheel_poses[:0], streams.imu_stamps[:0],
                             streams.imu_quats[:0])


def peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def run_map(cfg, streams, prewarm=True):
    """One streamed mapping run on a fresh system; returns (system, result,
    seconds)."""
    from simpleslam_tpu.pipeline import app
    from simpleslam_tpu.pipeline.streamed import run_streamed
    from simpleslam_tpu.utils.config import Params

    Params.load(cfg)
    system = app.SlamSystem()
    if prewarm:
        system.prewarm()
    t0 = time.perf_counter()
    result = run_streamed(system, streams)
    return system, result, time.perf_counter() - t0


def ates(streams, result):
    from simpleslam_tpu.pipeline import simulate as sim

    return (sim.ate_rmse(streams.gt_poses, result.poses, align=False),
            sim.kf_ate_rmse(streams, result.extras["kf_stamps"],
                            result.extras["kf_poses"]))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(ctx, want_count):
    import jax

    from simpleslam_tpu import native

    devs = require_gpu()
    check(len(devs) >= want_count,
          f"need {want_count} GPUs, JAX sees {len(devs)}")
    smi = nvidia_smi()
    ctx["smi"] = smi
    ok_native = native.available()
    check(ok_native, "native host library did not build or load "
          "(the host downsample would fall back to numpy)")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "nvidia_smi": smi,
            "jax": jax.__version__,
            "compile_cache": jax.config.jax_compilation_cache_dir,
            "matmul_precision": jax.config.jax_default_matmul_precision,
            "native_available": ok_native}


def phase_mapping(ctx):
    import jax

    streams = courtyard_streams(SIZES["map_scans"])
    ctx["courtyard"] = streams
    system, r1, t_cold = run_map(mapping_config(), streams)
    ate, ate_kf = ates(streams, r1)
    n_lc = system.backend.n_lc_edges
    lcm = system.loop_closure
    # second run on a fresh system: every program is compiled now, so this
    # one is the timed number; sync_backend makes it comparable bit for bit
    _, r2, t_warm = run_map(mapping_config(), streams)
    out = {
        "scans": len(streams.scan_stamps),
        "scan_capacity": r1.extras["scan_capacity"],
        "converged_frac": r1.converged_frac,
        "keyframes": r1.keyframe_count,
        "lc_edges": n_lc,
        "lc_funnel": {"queries": lcm.n_queries,
                      "candidates": lcm.n_candidates,
                      "verify_converged": lcm.n_verify_converged,
                      "rejected_correction": lcm.n_rejected_correction},
        "ate_m": ate, "ate_kf_m": ate_kf, "ate_bound_m": ATE_MAP,
        "scans_per_sec_cold": len(streams.scan_stamps) / t_cold,
        "scans_per_sec_warm": len(streams.scan_stamps) / t_warm,
        "rerun_bit_identical": bool(np.array_equal(r1.poses, r2.poses)),
        "rerun_max_dt_m": float(np.max(np.linalg.norm(
            r1.poses[:, :3, 3] - r2.poses[:, :3, 3], axis=1))),
        "peak_bytes_in_use": peak_bytes(jax.devices()[0]),
        "card": ctx["smi"],
        "stage_means_ms": {k: 1e3 * r2.timers.mean(k)
                           for k in r2.timers.total},
    }
    print(json.dumps({"phase": "mapping.detail", **out}), flush=True)
    check(r1.converged_frac > 0.9, f"converged_frac {r1.converged_frac}")
    check(n_lc >= 1, "no loop closure accepted")
    check(ate < ATE_MAP and ate_kf < ATE_MAP,
          f"ATE {ate:.4f} / keyframe ATE {ate_kf:.4f} over {ATE_MAP}")
    return {k: out[k] for k in ("converged_frac", "lc_edges", "ate_m",
                                "ate_kf_m", "scans_per_sec_warm",
                                "rerun_bit_identical", "peak_bytes_in_use")}


def phase_cli(ctx):
    from simpleslam_tpu.pipeline import app
    from simpleslam_tpu.utils.config import Params

    with tempfile.TemporaryDirectory() as out:
        rc = app.main(["--synthetic", "--streamed",
                       "--scans", str(SIZES["cli_scans"]), "--out", out])
        files = sorted(os.listdir(out))
        Params.reset()
        check(rc == 0, f"exit code {rc}")
        for f in ("tum.txt", "0.pcd", "fg.g2o"):
            check(f in files, f"{f} not written ({files})")
    return {"exit_code": rc, "n_files": len(files)}


def phase_kernels(ctx):
    n = SIZES["kernel_scans"]
    out = {}
    runs = [
        ("ndt", 5, {"mode": "lo", "frontend": {"pcr": "ndt"},
                    "backend": {"enable": False}}),
        ("vgicp", 5, {"mode": "lo", "frontend": {"pcr": "vgicp"},
                      "backend": {"enable": False}}),
        # lio with the resident backend worker thread (sync_backend off)
        ("lio", 1, {"mode": "lio", "frontend": {"pcr": "loam"},
                    "backend": {"enable": True, "lc": {"enable": False}},
                    "tpu": {"sync_backend": False}}),
    ]
    errors = []
    for name, seed, cfg in runs:
        streams = world_streams(seed, n)
        _, r, dt = run_map({"saveMapDir": "", **cfg}, streams, prewarm=False)
        ate, _ = ates(streams, r)
        out[name] = {"ate_m": ate, "converged_frac": r.converged_frac,
                     "keyframes": r.keyframe_count,
                     "scans_per_sec_cold": n / dt}
        if not (ate < ATE_KERNEL and r.converged_frac > 0.85):
            errors.append(f"{name}: ATE {ate:.4f}, conv {r.converged_frac}")
    out["ate_bound_m"] = ATE_KERNEL
    print(json.dumps({"phase": "kernels.detail", **out}), flush=True)
    check(not errors, "; ".join(errors))
    return out


def phase_parity(ctx):
    from simpleslam_tpu.pipeline import app, simulate as sim
    from simpleslam_tpu.pipeline.streamed import run_streamed
    from simpleslam_tpu.utils.config import Params

    n = SIZES["parity_scans"]
    streams = lidar_prefix(ctx.get("courtyard") or courtyard_streams(n), n)
    res = {}
    for name in ("streamed", "offline"):
        Params.load({"mode": "lo", "frontend": {"pcr": "loam"},
                     "backend": {"enable": False}, "saveMapDir": ""})
        system = app.SlamSystem()
        r = (run_streamed(system, streams) if name == "streamed"
             else app.run_offline(system, streams))
        res[name] = r
    a_s = sim.ate_rmse(streams.gt_poses, res["streamed"].poses, align=False)
    a_o = sim.ate_rmse(streams.gt_poses, res["offline"].poses, align=False)
    out = {"ate_streamed_m": a_s, "ate_offline_m": a_o,
           "kf_streamed": res["streamed"].keyframe_count,
           "kf_offline": res["offline"].keyframe_count,
           "converged_streamed": res["streamed"].converged_frac}
    # the bounds of tests/test_streamed.py::test_streamed_matches_classic_quality
    check(a_s < 0.25, f"streamed ATE {a_s}")
    check(a_s < max(2.5 * a_o, 0.15), f"streamed {a_s} vs offline {a_o}")
    check(out["kf_streamed"] >= out["kf_offline"] - 2, "keyframe count")
    check(out["converged_streamed"] > 0.9, "streamed convergence")
    return out


def _cost_rel(c, ref):
    return abs(float(c) - float(ref)) / max(abs(float(ref)), 1e-30)


def _pose_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.linalg.norm(a[..., :3, 3] - b[..., :3, 3],
                                       axis=-1)))


def phase_numerics(ctx):
    import jax

    from simpleslam_tpu import native
    from simpleslam_tpu.ops import loam
    from simpleslam_tpu.ops import posegraph as pgo
    from simpleslam_tpu.parallel.dist_posegraph import _ring_graph
    from simpleslam_tpu.pipeline import app
    from simpleslam_tpu.pipeline.streamed import (UPLOAD_SCALE,
                                                  _streamed_batch,
                                                  run_streamed)
    from simpleslam_tpu.utils.config import Params

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    out = {"matmul_precision": jax.config.jax_default_matmul_precision,
           "tolerances": {"batch_m": TOL_BATCH_M, "solve_m": TOL_SOLVE_M,
                          "pcg_cost_rel": TOL_SOLVE_COST_REL}}
    errors = []

    # -- one streamed registration batch at the latched scan capacity ------
    k = SIZES["batch_scans"]
    n_map = 8
    full = ctx.get("courtyard") or courtyard_streams(n_map + k)
    head = lidar_prefix(full, n_map)
    Params.load({"mode": "lo", "frontend": {"pcr": "loam"},
                 "backend": {"enable": False}, "saveMapDir": ""})
    system = app.SlamSystem()
    r = run_streamed(system, head)  # builds the map, latches the capacity
    dsc = system._streamed_scan_capacity
    target = jax.device_get(system.map_manager.get_target())
    rows, _ = native.voxel_downsample_sort_quant_batch(
        [np.asarray(s, np.float32) for s in full.scans[n_map:n_map + k]],
        float(system.lidar_odometry.grid_size), dsc,
        float(system.register.TARGET_GRID), UPLOAD_SCALE)
    eye = np.eye(4, dtype=np.float32)
    args = (rows, np.tile(eye, (k, 1, 1)), target,
            r.poses[-1].astype(np.float32), r.poses[-2].astype(np.float32),
            eye)

    def batch(dev, n, degen=0.0):
        a = jax.device_put((args[0][:n], args[1][:n]) + args[2:], dev)
        (_, _, _), packed = _streamed_batch(*a, kind="loam", mode="lo",
                                            degen=degen)
        return np.asarray(packed)

    g1, c1 = batch(gpu, k), batch(cpu, k)
    g2 = batch(gpu, k)
    d = _pose_diff(g1[:, :16].reshape(-1, 4, 4), c1[:, :16].reshape(-1, 4, 4))
    out["batch"] = {"scans": k, "scan_capacity": dsc, "max_dt_m": d,
                    "converged_gpu": int(g1[:, 16].sum()),
                    "converged_cpu": int(c1[:, 16].sum()),
                    "gpu_repeat_bit_identical": bool(np.array_equal(g1, g2))}
    if d > TOL_BATCH_M:
        errors.append(f"batch GPU vs CPU {d:.5f} m")
    nd = SIZES["degen_scans"]
    gd, cd = (batch(dev, nd, loam.DEGEN_EIGEN_PER_ROW) for dev in (gpu, cpu))
    d = _pose_diff(gd[:, :16].reshape(-1, 4, 4), cd[:, :16].reshape(-1, 4, 4))
    out["batch_degen_eigh"] = {"scans": nd, "max_dt_m": d}
    if d > TOL_BATCH_M:
        errors.append(f"eigh batch GPU vs CPU {d:.5f} m")

    # -- pose-graph solves: dense branch and PCG branch --------------------
    for kk in SIZES["solve_ks"]:
        g = jax.device_get(_ring_graph(k=kk - kk // 16, k_cap=kk,
                                       e_cap=2 * kk, n_lc=kk // 16,
                                       drift=0.05, seed=1))
        res = {}
        for name, dev in (("gpu", gpu), ("cpu", cpu), ("gpu2", gpu)):
            s = pgo.solve(jax.device_put(g, dev))
            res[name] = jax.device_get(s)
        m = np.asarray(g.kf_mask)
        d = _pose_diff(res["gpu"].poses[m], res["cpu"].poses[m])
        cg, cc = float(res["gpu"].cost), float(res["cpu"].cost)
        rel = _cost_rel(cg, cc)
        branch = "dense" if kk <= pgo.DENSE_SOLVE_MAX_K else "pcg"
        out[f"solve_k{kk}"] = {
            "branch": branch,
            "cost0": float(res["cpu"].cost0), "cost_gpu": cg,
            "cost_cpu": cc, "cost_rel_diff": rel, "max_dt_m": d,
            "iters_gpu": int(res["gpu"].iters),
            "iters_cpu": int(res["cpu"].iters),
            "gpu_repeat_bit_identical": bool(np.array_equal(
                res["gpu"].poses, res["gpu2"].poses))}
        if d > TOL_SOLVE_M or (branch == "pcg" and rel > TOL_SOLVE_COST_REL):
            errors.append(f"solve K={kk}: {d:.5f} m, cost rel {rel:.2e}")
    print(json.dumps({"phase": "numerics.detail", **out}), flush=True)
    check(not errors, "; ".join(errors))
    return {"batch_max_dt_m": out["batch"]["max_dt_m"],
            "batch_repeat_bit_identical":
                out["batch"]["gpu_repeat_bit_identical"]}


def phase_mesh(ctx):
    import jax

    import __graft_entry__ as graft

    streams = courtyard_streams(SIZES["map_scans"])
    t0 = time.perf_counter()
    single, meshed = graft.multichip_pipeline_parity(
        4, sync_every=16, config=mapping_config(), streams=streams)
    n_par = SIZES["parity_scans"]
    err = _pose_diff(single.poses[:n_par], meshed.poses[:n_par])
    err_whole = _pose_diff(single.poses, meshed.poses)
    ate_s, _ = ates(streams, single)
    ate_m, ate_kf_m = ates(streams, meshed)
    out = {"scans": len(streams.scan_stamps), "parity_scans": n_par,
           "max_dt_m": err, "bound_m": TOL_MESH_M,
           "max_dt_whole_run_m": err_whole,
           "bound_whole_run_m": TOL_MESH_WHOLE_M,
           "ate_single_m": ate_s, "ate_mesh_m": ate_m,
           "ate_kf_mesh_m": ate_kf_m,
           "keyframes": [single.keyframe_count, meshed.keyframe_count],
           "converged_mesh": meshed.converged_frac,
           "peak_bytes_in_use": [peak_bytes(d) for d in jax.devices()[:4]],
           "seconds_both": time.perf_counter() - t0}
    print(json.dumps({"phase": "mesh.detail", **out}), flush=True)
    check(err < TOL_MESH_M, f"mesh vs single {err:.5f} m over {n_par} scans")
    check(err_whole < TOL_MESH_WHOLE_M,
          f"mesh vs single {err_whole:.5f} m over the whole run")
    check(abs(ate_m - ate_s) < TOL_MESH_M and ate_m < ATE_MAP,
          f"mesh ATE {ate_m:.4f} vs single {ate_s:.4f}")
    check(meshed.converged_frac > 0.9, "mesh convergence")
    # every card must have held part of the work, not only card 0
    check(all((p or 0) > 0 for p in out["peak_bytes_in_use"]),
          "a mesh device was never used")
    return out


def phase_sharded_solve(ctx):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from simpleslam_tpu.ops import posegraph as pgo
    from simpleslam_tpu.parallel.dist_posegraph import (_ring_graph,
                                                        sharded_solve)
    from simpleslam_tpu.parallel.mesh import make_mesh

    kk = 2048
    g = jax.device_get(_ring_graph(k=kk - 128, k_cap=kk, e_cap=2 * kk,
                                   n_lc=128, drift=0.05, seed=1))
    mesh = make_mesh(4, ("kf",))
    rep, edge = NamedSharding(mesh, P()), NamedSharding(mesh, P("kf"))
    g_sh = pgo.PoseGraph(*[
        jax.device_put(a, edge if f.startswith("edge_") else rep)
        for f, a in zip(pgo.PoseGraph._fields, g)])

    def timed(fn, x):
        jax.block_until_ready(fn(x))  # compile
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn(x))
        return jax.device_get(res), time.perf_counter() - t0

    ref, t_ref = timed(pgo.solve, jax.device_put(g, jax.devices()[0]))
    m = np.asarray(g.kf_mask)
    out = {"K": kk, "single": {"seconds": t_ref, "cost": float(ref.cost)}}
    errors = []
    for name, kw, tol_m, tol_rel in (
            ("replicated", {}, TOL_SOLVE_M, TOL_SOLVE_COST_REL),
            ("shard_cg", {"shard_cg": True}, TOL_SHARD_CG_M,
             TOL_SHARD_CG_COST_REL),
            ("shard_lin", {"shard_lin": True}, TOL_SOLVE_M,
             TOL_SOLVE_COST_REL)):
        fn = sharded_solve(mesh, axis="kf", **kw)
        res, t = timed(fn, g_sh)
        d = _pose_diff(res.poses[m], ref.poses[m])
        rel = _cost_rel(res.cost, ref.cost)
        out[name] = {"seconds": t, "cost": float(res.cost), "max_dt_m": d,
                     "cost_rel_diff": rel, "bound_m": tol_m}
        if d > tol_m or rel > tol_rel:
            errors.append(f"{name}: {d:.5f} m, cost rel {rel:.2e}")
    print(json.dumps({"phase": "sharded_solve.detail", **out}), flush=True)
    check(not errors, "; ".join(errors))
    return {k: v["seconds"] for k, v in out.items() if isinstance(v, dict)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path and its reference")
    args = ap.parse_args(argv)

    from simpleslam_tpu.utils.logging import Logger
    import logging

    Logger.get_instance().set_level(logging.ERROR)
    n_cards = 4 if args.four else 1
    ctx = {}
    t_all = time.perf_counter()
    # the device phase runs outside the failure collector: without a GPU
    # nothing else may run and no result line is printed
    dev = phase_device(ctx, n_cards)
    print(json.dumps({"phase": "device", "ok": True, **dev}), flush=True)
    phases = ([("mesh", phase_mesh), ("sharded_solve", phase_sharded_solve)]
              if args.four else
              [("mapping", phase_mapping), ("cli", phase_cli),
               ("kernels", phase_kernels), ("parity", phase_parity),
               ("numerics", phase_numerics)])
    all_ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res, ok = fn(ctx), True
        except Exception as e:  # report every failing phase, then fail
            traceback.print_exc()
            res, ok = {"error": repr(e)[:500]}, False
        all_ok &= ok
        print(json.dumps({"phase": name, "ok": ok,
                          "seconds": time.perf_counter() - t0, **res}),
              flush=True)
    print(json.dumps({"total_seconds": time.perf_counter() - t_all}))
    print("; ".join(ctx["smi"]))
    print(json.dumps({"ok": all_ok, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
