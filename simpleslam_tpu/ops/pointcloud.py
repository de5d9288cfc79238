"""Fixed-capacity padded point clouds — the device-side container.

XLA wants static shapes, so clouds are (capacity, 3) float32 arrays plus a
validity mask; padding lanes carry a far sentinel so they can never win a
nearest-neighbor race. This replaces the reference's dynamic PCL containers
(``common/types/PCLTypes.hpp``) with static shapes: capacity is a compile-time
constant per pipeline stage, masking does the rest.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import geometry as geo

# Sentinel coordinate for padding lanes: far from any plausible scan content
# but small enough that squared distances stay finite in f32.
PAD_COORD = 1.0e6


class PointCloud(NamedTuple):
    """Padded cloud: xyz (N, 3) f32, intensity (N,) f32, mask (N,) bool."""

    xyz: jax.Array
    intensity: jax.Array
    mask: jax.Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> jax.Array:
        return jnp.sum(self.mask)


def from_numpy(xyz: np.ndarray, capacity: int,
               intensity: Optional[np.ndarray] = None) -> PointCloud:
    """Pad/truncate a host (n, 3) array to a device PointCloud of ``capacity``.

    NaN rows are dropped (the reference strips NaNs on ingest,
    ``dataproxy/src/LidarDataProxy.cpp`` via pcp::removeNaNFromPointCloud).
    The strip+pad pass runs in the native host runtime when available.
    """
    from .. import native

    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    if intensity is None:
        out, mask, _ = native.pad_cloud(xyz, capacity, PAD_COORD)
        inten = np.zeros((capacity,), dtype=np.float32)
        return PointCloud(jnp.asarray(out), jnp.asarray(inten), jnp.asarray(mask))
    intensity = np.asarray(intensity, dtype=np.float32).reshape(-1)
    finite = np.isfinite(xyz).all(axis=1)
    xyz, intensity = xyz[finite], intensity[finite]
    n = min(xyz.shape[0], capacity)
    out = np.full((capacity, 3), PAD_COORD, dtype=np.float32)
    out[:n] = xyz[:n]
    inten = np.zeros((capacity,), dtype=np.float32)
    inten[:n] = intensity[:n]
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return PointCloud(jnp.asarray(out), jnp.asarray(inten), jnp.asarray(mask))


def to_numpy(pc: PointCloud) -> np.ndarray:
    """Extract the valid points as a host (n, 3) array."""
    xyz = np.asarray(pc.xyz)
    mask = np.asarray(pc.mask)
    return xyz[mask]


def empty(capacity: int) -> PointCloud:
    return PointCloud(
        jnp.full((capacity, 3), PAD_COORD, dtype=jnp.float32),
        jnp.zeros((capacity,), dtype=jnp.float32),
        jnp.zeros((capacity,), dtype=bool),
    )


def transform(pc: PointCloud, pose: jax.Array) -> PointCloud:
    """Rigid transform of the valid points (pcp::transformPointCloud role).

    Padding lanes are re-pinned to the sentinel so a rotated sentinel can't
    drift near real data.
    """
    moved = geo.transform_points(pose, pc.xyz)
    xyz = jnp.where(pc.mask[:, None], moved, PAD_COORD)
    return PointCloud(xyz, pc.intensity, pc.mask)


def compact(pc: PointCloud, out_capacity: Optional[int] = None) -> PointCloud:
    """Stable-move valid points to the front; optionally shrink capacity.

    Implemented as a stable sort on the inverted mask — a static-shape
    stream compaction.
    """
    out_capacity = out_capacity or pc.capacity
    order = jnp.argsort(jnp.logical_not(pc.mask), stable=True)
    xyz = pc.xyz[order][:out_capacity]
    inten = pc.intensity[order][:out_capacity]
    mask = pc.mask[order][:out_capacity]
    xyz = jnp.where(mask[:, None], xyz, PAD_COORD)
    return PointCloud(xyz, inten, mask)


def concat(a: PointCloud, b: PointCloud, out_capacity: Optional[int] = None) -> PointCloud:
    """Concatenate two padded clouds, compacting valid points to the front."""
    merged = PointCloud(
        jnp.concatenate([a.xyz, b.xyz]),
        jnp.concatenate([a.intensity, b.intensity]),
        jnp.concatenate([a.mask, b.mask]),
    )
    return compact(merged, out_capacity or (a.capacity + b.capacity))


def crop_range(pc: PointCloud, center: jax.Array, max_range: float) -> PointCloud:
    """Invalidate points farther than ``max_range`` from ``center``."""
    d2 = jnp.sum((pc.xyz - center) ** 2, axis=-1)
    mask = pc.mask & (d2 <= max_range * max_range)
    xyz = jnp.where(mask[:, None], pc.xyz, PAD_COORD)
    return PointCloud(xyz, pc.intensity, mask)
