"""Native (C++) host-runtime kernels with transparent numpy fallback.

Role parity: the reference's host runtime is C++ (``common/pcp/pcp.hpp``
voxel filters and OpenMP cloud transforms, PCD IO). Here the device path is
JAX/XLA; these kernels serve the host-only hot loops around it. The shared
library is compiled on first import with g++ (cached next to the source);
if no toolchain is available every entry point falls back to numpy with
identical semantics, so the package never hard-depends on a compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hostops.cpp")
_LIB = os.path.join(_DIR, "libhostops.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", _SRC, "-o", _LIB]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        return r.returncode == 0 and os.path.isfile(_LIB)
    except (OSError, subprocess.TimeoutExpired):
        return False


def _bind(lib: ctypes.CDLL) -> None:
    """Declare every exported symbol's signature (raises AttributeError on a
    stale library missing a newer symbol — callers rebuild once)."""
    i64, f32p, u8p, i64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                            ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_int64))
    lib.voxel_downsample_first.restype = i64
    lib.voxel_downsample_first.argtypes = [f32p, i64, ctypes.c_float, f32p]
    lib.pad_cloud.restype = i64
    lib.pad_cloud.argtypes = [f32p, i64, i64, ctypes.c_float, f32p, u8p]
    lib.voxel_downsample_centroid_pad.restype = i64
    lib.voxel_downsample_centroid_pad.argtypes = [
        f32p, i64, ctypes.c_float, i64, i64, ctypes.c_float, f32p]
    lib.voxel_downsample_centroid_pad_batch.restype = None
    lib.voxel_downsample_centroid_pad_batch.argtypes = [
        f32p, i64p, i64, ctypes.c_float, i64, i64, ctypes.c_float, f32p,
        i64p, i64]
    i16p = ctypes.POINTER(ctypes.c_int16)
    lib.voxel_downsample_sort_quant_batch.restype = None
    lib.voxel_downsample_sort_quant_batch.argtypes = [
        f32p, i64p, i64, ctypes.c_float, i64, i64, ctypes.c_float,
        ctypes.c_float, i16p, i64p, i64]
    lib.transform_concat.restype = i64
    lib.transform_concat.argtypes = [f32p, i64p, f32p, i64, f32p]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.isfile(_LIB) or (
            os.path.isfile(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(_LIB)
        ):
            if not _build():
                return None
        for attempt in range(2):
            try:
                lib = ctypes.CDLL(_LIB)
                _bind(lib)
            except OSError:
                return None
            except AttributeError:
                # stale libhostops.so from an older source revision: rebuild
                # once; if the fresh build still lacks the symbol, fall back
                # to numpy rather than breaking every entry point
                if attempt == 1 or not _build():
                    return None
                continue
            _lib = lib
            return _lib
        return None


def available() -> bool:
    return _load() is not None


def _f32c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def voxel_downsample_first(xyz: np.ndarray, grid: float) -> np.ndarray:
    """First-point-per-voxel downsample (keyframe storage semantics)."""
    xyz = _f32c(xyz.reshape(-1, 3))
    lib = _load()
    if lib is None or len(xyz) == 0:
        if len(xyz) == 0:
            return xyz
        keys = np.floor(xyz / grid).astype(np.int64)
        _, first = np.unique(keys, axis=0, return_index=True)
        return xyz[np.sort(first)]
    out = np.empty_like(xyz)
    m = lib.voxel_downsample_first(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(xyz),
        ctypes.c_float(grid), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out[:m].copy()


def voxel_downsample_centroid_pad(xyz: np.ndarray, grid: float, capacity: int,
                                  pad_coord: float, max_pts: int = 20):
    """Centroid-per-voxel downsample into the padded device layout.

    Returns (padded (capacity, 3) float32, valid count). Semantics match the
    device ``ops.voxel.voxel_downsample`` (centroid of up to ``max_pts``
    points per voxel, origin 0) with first-seen voxel output order; overflow
    beyond ``capacity`` is stride-subsampled. This is the host half of the
    streamed executor's hot path: downsampling before upload cuts the
    host->device transfer ~4x (see pipeline/streamed.py).
    """
    xyz = _f32c(xyz.reshape(-1, 3))
    lib = _load()
    if lib is None:
        finite = np.isfinite(xyz).all(axis=1)
        v = xyz[finite]
        keys = np.floor(v / grid).astype(np.int64)
        uq, first, inv, cnt = np.unique(
            keys, axis=0, return_index=True, return_inverse=True,
            return_counts=True)
        # centroid over up to max_pts points per voxel, in input order
        order = np.argsort(inv, kind="stable")
        v_s = v[order]
        inv_s = inv[order]
        starts = np.searchsorted(inv_s, np.arange(len(uq)))
        sums = np.zeros((len(uq), 3), np.float64)
        counts = np.zeros(len(uq), np.int64)
        pos_in_seg = np.arange(len(v_s)) - starts[inv_s]
        take = pos_in_seg < max_pts
        np.add.at(sums, inv_s[take], v_s[take])
        np.add.at(counts, inv_s[take], 1)
        cents = (sums / np.maximum(counts, 1)[:, None]).astype(np.float32)
        cents = cents[np.argsort(first, kind="stable")]  # first-seen order
        m = len(cents)
        if m > capacity:
            sel = (np.arange(capacity) * m // capacity)
            cents = cents[sel]
            m = capacity
        out = np.full((capacity, 3), pad_coord, np.float32)
        out[:m] = cents
        return out, m
    out = np.empty((capacity, 3), np.float32)
    m = lib.voxel_downsample_centroid_pad(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(xyz),
        ctypes.c_float(grid), max_pts, capacity, ctypes.c_float(pad_coord),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out, int(m)


def voxel_downsample_centroid_pad_batch(scans, grid: float, capacity: int,
                                        pad_coord: float, max_pts: int = 20):
    """Batch of independent scans downsampled in ONE ctypes call.

    The GIL is released for the whole batch and the C++ side parallelizes
    over scans with OpenMP — this beats Python-thread parallelism over
    single-scan calls (pipeline/streamed.py producer). OpenMP width is
    capped at nproc-1 so one core stays free for the dispatching thread. Returns
    ((B, capacity, 3) f32, (B,) counts). Semantics per scan identical to
    voxel_downsample_centroid_pad.
    """
    lib = _load()
    b = len(scans)
    threads = max(1, (os.cpu_count() or 2) - 1)
    if lib is None:
        out = np.empty((b, capacity, 3), np.float32)
        cnts = np.empty(b, np.int64)
        for i, s in enumerate(scans):
            out[i], cnts[i] = voxel_downsample_centroid_pad(
                s, grid, capacity, pad_coord, max_pts)
        return out, cnts
    flat = [_f32c(np.asarray(s).reshape(-1, 3)) for s in scans]
    concat = (np.concatenate(flat, axis=0) if flat
              else np.zeros((0, 3), np.float32))
    counts = np.asarray([len(f) for f in flat], np.int64)
    out = np.empty((b, capacity, 3), np.float32)
    out_counts = np.empty(b, np.int64)
    lib.voxel_downsample_centroid_pad_batch(
        concat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), b,
        ctypes.c_float(grid), max_pts, capacity, ctypes.c_float(pad_coord),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), threads)
    return out, out_counts


def voxel_downsample_sort_quant_batch(scans, grid: float, capacity: int,
                                      sort_grid: float, quant_scale: float,
                                      max_pts: int = 20):
    """Full streamed-producer prep: downsample + spatial sort + int16
    quantization in ONE GIL-released call (see hostops.cpp rationale).

    Returns ((B, capacity, 3) int16 with 32767 pad sentinel, (B,) counts).
    """
    b = len(scans)
    lib = _load()
    if lib is None:
        rows, cnts = voxel_downsample_centroid_pad_batch(
            scans, grid, capacity, 0.0, max_pts)
        out = np.full((b, capacity, 3), np.int16(32767), np.int16)
        cnts = np.asarray(cnts).copy()
        for k in range(b):
            c = int(cnts[k])
            pts = rows[k][:c]
            if sort_grid > 0 and c > 1:
                v = np.floor(pts / sort_grid).astype(np.int64) + (1 << 20)
                key = (v[:, 0] << 42) + (v[:, 1] << 21) + v[:, 2]
                pts = pts[np.argsort(key)]
            q = np.rint(pts / quant_scale)
            # drop (don't clamp) returns outside the quantization range —
            # clamping created phantom points pinned to the +-125 m box
            keep = np.all(np.abs(q) <= 32766, axis=1)
            q = q[keep]
            out[k][: len(q)] = q.astype(np.int16)
            cnts[k] = len(q)
        return out, cnts
    flat = [_f32c(np.asarray(s).reshape(-1, 3)) for s in scans]
    concat = (np.concatenate(flat, axis=0) if flat
              else np.zeros((0, 3), np.float32))
    counts = np.asarray([len(f) for f in flat], np.int64)
    out = np.empty((b, capacity, 3), np.int16)
    out_counts = np.empty(b, np.int64)
    threads = max(1, (os.cpu_count() or 2) - 1)
    lib.voxel_downsample_sort_quant_batch(
        concat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), b,
        ctypes.c_float(grid), max_pts, capacity, ctypes.c_float(sort_grid),
        ctypes.c_float(quant_scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), threads)
    return out, out_counts


def pad_cloud(xyz: np.ndarray, capacity: int, pad_coord: float):
    """NaN-strip + pad to (capacity, 3); returns (padded, mask(bool), count)."""
    xyz = _f32c(xyz.reshape(-1, 3))
    lib = _load()
    if lib is None:
        finite = np.isfinite(xyz).all(axis=1)
        v = xyz[finite][:capacity]
        out = np.full((capacity, 3), pad_coord, np.float32)
        out[: len(v)] = v
        mask = np.zeros(capacity, bool)
        mask[: len(v)] = True
        return out, mask, len(v)
    out = np.empty((capacity, 3), np.float32)
    mask = np.empty(capacity, np.uint8)
    m = lib.pad_cloud(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(xyz),
        capacity, ctypes.c_float(pad_coord),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out, mask.astype(bool), int(m)


def transform_concat(clouds: list, poses: np.ndarray) -> np.ndarray:
    """Transform each cloud by its (4,4) pose and concatenate (submap gather)."""
    if not clouds:
        return np.zeros((0, 3), np.float32)
    lib = _load()
    if lib is None:
        return np.concatenate([
            c.astype(np.float32) @ p[:3, :3].T.astype(np.float32)
            + p[:3, 3].astype(np.float32)
            for c, p in zip(clouds, poses)
        ])
    counts = np.array([len(c) for c in clouds], np.int64)
    flat = np.concatenate([_f32c(c) for c in clouds]) if len(clouds) > 1 \
        else _f32c(clouds[0])
    flat = _f32c(flat)
    pose_arr = _f32c(np.asarray(poses, np.float32).reshape(len(clouds), 16))
    out = np.empty_like(flat)
    lib.transform_concat(
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pose_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(clouds), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out
