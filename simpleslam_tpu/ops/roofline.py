"""Analytic roofline model for the registration hot kernel.

The reference's per-stage tictoc discipline (common/time/tictoc.hpp:29-62)
told its authors where CPU time went; on an accelerator the question is also
whether the device time is anywhere near the hardware's speed of light. This
module provides the FLOP/byte counts for the LOAM batch step and the card's
published peaks, so the bench can report how far a measured device time is
from the memory and compute bounds.

Cost structure: per candidate GATHER (~once per scan) each of the N query
points reads ONE pre-merged slab row of W values (voxel.MergedDenseVoxelMap)
and the 5-NN/plane-fit chain does ~45 flops per candidate ONCE; each GN
ITERATION then costs only ~300 per-query flops against the frozen planes
(loam.fit_planes / plane_normal_equations). There is no matrix-unit work:
the model exists to locate the kernel against the memory bound.
"""

from __future__ import annotations

from typing import Dict

# Published peaks keyed by the exact ``device_kind`` JAX reports. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates (no
# sparsity) at the 700 W power limit. The program runs float32 matmuls at
# "highest" precision (simpleslam_tpu/__init__.py), i.e. outside the tensor
# cores, so utilization divides by ``fp32_flops``; the tensor-core rates are
# listed beside it for reference.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "fp32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_kind: str) -> Dict[str, float]:
    """Peaks of one card; an unknown ``device_kind`` is an error, not a
    default (a wrong peak makes every share in the report wrong)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add the "
            f"card's data-sheet values to roofline.PEAKS") from None

# flops per (query, candidate) pair of the normal-equation chain:
# d2 (8: sub+mul+add x3 fused) + 5 argmin rounds (~5x4: min, cmp, cumsum,
# select) + centroid/scatter/eigen accumulation (~15) + masked
# residual/einsum contributions (~2). Order-of-magnitude deliberate: the
# conclusion (memory-bound by >100x) is insensitive to +-2x here.
_FLOPS_PER_CAND = 45
# per-query flops independent of candidates: point transform, 3x3 symeig,
# J row, 6x6 outer products (~250)
_FLOPS_PER_QUERY = 250


def loam_batch_cost(n_queries: int, slab_rows: int, row_bytes: int,
                    slab_pts: int, n_scans: int, mean_iters: float,
                    mean_gathers: float) -> Dict[str, float]:
    """FLOPs and device-memory bytes of one streamed registration batch.

    n_queries: padded query points per scan (the scan-row capacity)
    slab_rows: rows gathered per query (1 for the merged gather)
    row_bytes: bytes per gathered row (8 * slab_pts * 3 int16 merged)
    slab_pts: points stored per VOXEL (tpu.loam_slab_size)
    mean_iters / mean_gathers: measured per-scan GN iterations and gather
    refreshes. The candidate-axis flops are paid per GATHER (fit_planes);
    iterations pay only the per-query frozen-plane work.
    """
    cand_pts = 8 * slab_pts
    gather_bytes = (n_scans * mean_gathers * n_queries
                    * slab_rows * float(row_bytes))
    flops = n_scans * n_queries * (
        mean_gathers * cand_pts * _FLOPS_PER_CAND
        + mean_iters * _FLOPS_PER_QUERY)
    return {"flops": flops, "hbm_bytes": gather_bytes,
            "cand_pts_per_query": float(cand_pts)}


def utilization(cost: Dict[str, float], device_s: float,
                device_kind: str) -> Dict[str, float]:
    """FP32 FLOP share / memory-bandwidth share / speed-of-light fraction of
    a measured device time, against ``device_kind``'s published peaks."""
    pk = peaks(device_kind)
    if device_s <= 0:
        return {"fp32_flop_share": 0.0, "hbm_share": 0.0, "sol_frac": 0.0}
    flop_t = cost["flops"] / pk["fp32_flops"]
    mem_t = cost["hbm_bytes"] / pk["hbm_bytes_per_s"]
    return {
        "fp32_flop_share": flop_t / device_s,
        "hbm_share": mem_t / device_s,
        "sol_frac": max(flop_t, mem_t) / device_s,
        "bound": "memory" if mem_t >= flop_t else "compute",
    }
