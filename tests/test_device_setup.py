"""Process setup shared by every entry point: compile cache, peaks, device
guard.

The guard and the peaks table are what keep CPU numbers from being reported
as GPU numbers; the cache location decides whether a second process finds
the first one's compiled programs.
"""

import os
import shutil
import subprocess
import sys

import pytest

from simpleslam_tpu.ops import roofline
from simpleslam_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_update=None, drop=(), cwd=REPO):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in drop:
        env.pop(k, None)
    env.update(env_update or {})
    args = (code_or_args if isinstance(code_or_args, list)
            else ["-c", code_or_args])
    return subprocess.run([sys.executable] + args, env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


_PRINT_CACHE = ("import simpleslam_tpu, jax; "
                "print(jax.config.jax_compilation_cache_dir)")


def test_cache_dir_env_is_honoured(tmp_path):
    want = str(tmp_path / "cache")
    r = _run(_PRINT_CACHE, {"JAX_COMPILATION_CACHE_DIR": want})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == want


def test_cache_dir_defaults_inside_checkout():
    r = _run(_PRINT_CACHE, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == os.path.join(REPO,
                                                             ".jax_cache")


def test_peaks_table_has_h100():
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert pk["fp32_flops"] == 67e12
    assert pk["tf32_flops"] > pk["fp32_flops"]
    assert pk["bf16_flops"] > pk["tf32_flops"]


def test_peaks_table_refuses_unknown_kind():
    with pytest.raises(KeyError, match="no published peaks"):
        roofline.peaks("cpu")
    with pytest.raises(KeyError):
        roofline.utilization({"flops": 1.0, "hbm_bytes": 1.0}, 1e-3,
                             "Unlisted Accelerator")


def test_utilization_divides_by_fp32_and_memory_peaks():
    kind = "NVIDIA H100 80GB HBM3"
    # 3.35 GB in 1 ms is exactly the memory bound; the flops are 1 % of the
    # fp32 bound over the same millisecond
    u = roofline.utilization({"flops": 0.01 * 67e9, "hbm_bytes": 3.35e9},
                             1e-3, kind)
    assert u["hbm_share"] == pytest.approx(1.0)
    assert u["fp32_flop_share"] == pytest.approx(0.01)
    assert u["sol_frac"] == pytest.approx(1.0)
    assert u["bound"] == "memory"


def test_loam_batch_cost_counts_row_bytes():
    c = roofline.loam_batch_cost(n_queries=8192, slab_rows=1,
                                 row_bytes=8 * 24 * 3 * 2, slab_pts=24,
                                 n_scans=32, mean_iters=3.0,
                                 mean_gathers=1.0)
    assert c["hbm_bytes"] == 32 * 8192 * 8 * 24 * 3 * 2
    assert c["cand_pts_per_query"] == 8 * 24


def test_device_guard_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()
    with pytest.raises(RuntimeError, match="no GPU"):
        device.device_info()


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_points_fail_without_gpu(script):
    r = _run([script])
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout


def test_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], cwd=str(tmp_path))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
