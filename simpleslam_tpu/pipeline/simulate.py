"""Synthetic LiDAR world + sensor simulation (deterministic test/bench data).

The reference benchmarks on two private rosbags (BASELINE.md) that are not
redistributable, so the framework ships a simulator producing the same kind
of workload: a park/street-scale world of planar structures, a planar robot
trajectory, a spinning multi-beam LiDAR (Velodyne-16-like), and wheel + IMU
streams with realistic noise. Everything is seeded numpy on the host — the
simulator is a data source, never on the device path.

Conventions (matched to the reference pipeline):
- The SLAM body frame is the lidar frame with z clamped to 0 by the planar
  constraint (trans::SixDof2Mobile applied per scan); the sensor rides
  ``lidar_height`` (config tf.lidar_height = 2.0) above ground, so ground
  points appear near z = -lidar_height in scans — exactly the geometry
  ScanContext compensates with its +LIDAR_HEIGHT shift (ScanContext.cpp:163).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import os

import numpy as np

from ..ops import geometry as geo


@dataclass
class Rect:
    """Axis-aligned rectangular plane patch.

    axis: normal axis (0=x, 1=y, 2=z); offset: plane coordinate along axis;
    bounds: (umin, umax, vmin, vmax) over the two remaining axes in order.
    """

    axis: int
    offset: float
    bounds: Tuple[float, float, float, float]


@dataclass
class Patch:
    """Arbitrarily-oriented rectangular plane patch (the general primitive;
    axis-aligned ``Rect``s are converted to patches for ray casting).

    center: (3,) patch center; u, v: (3,) orthonormal in-plane axes;
    half: (hu, hv) half extents along u and v.
    """

    center: np.ndarray
    u: np.ndarray
    v: np.ndarray
    half: Tuple[float, float]


def _rect_to_patch(r: Rect) -> Patch:
    ua, va = _OTHER_AXES[r.axis]
    umin, umax, vmin, vmax = r.bounds
    center = np.zeros(3)
    center[r.axis] = r.offset
    center[ua] = (umin + umax) / 2
    center[va] = (vmin + vmax) / 2
    u = np.zeros(3)
    u[ua] = 1.0
    v = np.zeros(3)
    v[va] = 1.0
    return Patch(center, u, v, ((umax - umin) / 2, (vmax - vmin) / 2))


@dataclass
class Cylinder:
    """Vertical cylinder (tree trunk, pole, curved tank wall).

    A CURVED surface: point-to-plane registration only ever sees its local
    tangent planes, so plane fits across a trunk's width are genuinely
    non-planar — the self-confirmation breaker the planar worlds lack."""

    cx: float
    cy: float
    radius: float
    z0: float
    z1: float


@dataclass
class Blob:
    """Vegetation-like scatterer: a sphere that returns a hit with
    probability ``hit_prob`` at a range jittered by ``jitter`` (leaf
    penetration) — produces the fuzzy, non-surface point clutter real
    foliage gives a LiDAR, which plane fitting must reject as outliers."""

    center: np.ndarray      # (3,)
    radius: float
    hit_prob: float = 0.35
    jitter: float = 0.4


@dataclass
class World:
    rects: List[Rect] = field(default_factory=list)
    patches: List[Patch] = field(default_factory=list)
    cylinders: List[Cylinder] = field(default_factory=list)
    blobs: List[Blob] = field(default_factory=list)

    def all_patches(self) -> List[Patch]:
        return [_rect_to_patch(r) for r in self.rects] + self.patches

    def as_patch_arrays(self, extra_patches: Optional[List[Patch]] = None):
        ps = self.all_patches() + (extra_patches or [])
        center = np.stack([p.center for p in ps]).astype(np.float64)
        u = np.stack([p.u for p in ps]).astype(np.float64)
        v = np.stack([p.v for p in ps]).astype(np.float64)
        half = np.array([p.half for p in ps], np.float64)
        normal = np.cross(u, v)
        return center, u, v, half, normal


def make_world(seed: int = 0, extent: float = 120.0, n_buildings: int = 24) -> World:
    """Ground plane + randomly placed box 'buildings' + boundary walls."""
    rng = np.random.default_rng(seed)
    w = World()
    e = extent
    w.rects.append(Rect(2, 0.0, (-e, e, -e, e)))  # ground z=0
    # boundary walls, 6 m tall
    w.rects.append(Rect(0, -e, (-e, e, 0.0, 6.0)))
    w.rects.append(Rect(0, e, (-e, e, 0.0, 6.0)))
    w.rects.append(Rect(1, -e, (-e, e, 0.0, 6.0)))
    w.rects.append(Rect(1, e, (-e, e, 0.0, 6.0)))
    for _ in range(n_buildings):
        cx, cy = rng.uniform(-e * 0.8, e * 0.8, size=2)
        if abs(cx) < 12 and abs(cy) < 12:
            continue  # keep the start area clear
        sx, sy = rng.uniform(4, 14, size=2)
        h = rng.uniform(3, 12)
        x0, x1 = cx - sx / 2, cx + sx / 2
        y0, y1 = cy - sy / 2, cy + sy / 2
        # four vertical faces (u-axis is the lower remaining axis: for axis=0
        # faces, u=y, v=z; for axis=1 faces, u=x, v=z)
        w.rects.append(Rect(0, x0, (y0, y1, 0.0, h)))
        w.rects.append(Rect(0, x1, (y0, y1, 0.0, h)))
        w.rects.append(Rect(1, y0, (x0, x1, 0.0, h)))
        w.rects.append(Rect(1, y1, (x0, x1, 0.0, h)))
        w.rects.append(Rect(2, h, (x0, x1, y0, y1)))  # roof
    return w


def make_courtyard(radius: float, seed: int = 0,
                   ring_frac: float = 1.0) -> World:
    """Ring of 10 buildings around a circular loop of ``radius`` centered at
    (0, radius) — the trajectory circle of ``make_trajectory`` — so
    close-range structure is visible from every point of the loop and a
    small loop closes with registration converged. ``ring_frac`` < 1 leaves
    an open 'plaza' sector with no nearby structure, where registration is
    weakly constrained and genuine odometric drift accumulates."""
    rng = np.random.default_rng(seed)
    w = World()
    cx0, cy0 = 0.0, radius  # trajectory circle center
    e = 40.0
    w.rects.append(Rect(2, 0.0, (-e, e, -e, e)))  # ground
    for k in (0, 1):
        for off in (-e, e):
            w.rects.append(Rect(k, off, (-e, e, 0.0, 6.0)))
    for ang in np.linspace(0, 2 * np.pi * ring_frac, 10, endpoint=False):
        rr = radius + 8.0 + rng.uniform(0, 4)
        cx = cx0 + rr * np.cos(ang + rng.uniform(-0.1, 0.1))
        cy = cy0 + rr * np.sin(ang + rng.uniform(-0.1, 0.1))
        sx, sy = rng.uniform(4, 8, size=2)
        h = rng.uniform(4, 10)
        x0, x1 = cx - sx / 2, cx + sx / 2
        y0, y1 = cy - sy / 2, cy + sy / 2
        w.rects.append(Rect(0, x0, (y0, y1, 0.0, h)))
        w.rects.append(Rect(0, x1, (y0, y1, 0.0, h)))
        w.rects.append(Rect(1, y0, (x0, x1, 0.0, h)))
        w.rects.append(Rect(1, y1, (x0, x1, 0.0, h)))
        w.rects.append(Rect(2, h, (x0, x1, y0, y1)))
    return w


def make_loop_world(seed: int = 0, radius: float = 40.0,
                    extent: float = 80.0, n_buildings: int = 64,
                    corridor: float = 9.0) -> World:
    """Loop-trajectory world: like ``make_world`` but with the building
    placement rejection-sampled to keep a clear ``corridor`` around the
    circular path ``make_trajectory(radius=radius)`` drives (circle of that
    radius centered at (0, radius)). ``make_world`` only clears the start
    square, so long loop runs eventually drive THROUGH a random building —
    the scan collapses to a few hundred occluded interior points and
    registration starves (measured in the round-4 long-run bench). Real
    deployments drive on roads; this generator is the simulator's road.
    """
    rng = np.random.default_rng(seed)
    w = World()
    e = extent
    w.rects.append(Rect(2, 0.0, (-e, e + 2 * radius, -e, e)))  # ground
    w.rects.append(Rect(0, -e, (-e, e + 2 * radius, 0.0, 6.0)))
    w.rects.append(Rect(0, e, (-e, e + 2 * radius, 0.0, 6.0)))
    w.rects.append(Rect(1, -e, (-e, e, 0.0, 6.0)))
    w.rects.append(Rect(1, e + 2 * radius, (-e, e, 0.0, 6.0)))
    cx0, cy0 = 0.0, radius
    placed = 0
    for _ in range(n_buildings * 8):
        if placed >= n_buildings:
            break
        cx = rng.uniform(-e * 0.9, e * 0.9)
        cy = rng.uniform(-e * 0.9 + radius, e * 0.9 + radius)
        sx, sy = rng.uniform(4, 12, size=2)
        half_diag = float(np.hypot(sx, sy)) / 2.0
        ring_d = abs(np.hypot(cx - cx0, cy - cy0) - radius)
        if ring_d < corridor / 2.0 + half_diag:
            continue  # would intrude into the drive corridor
        h = rng.uniform(3, 12)
        x0, x1 = cx - sx / 2, cx + sx / 2
        y0, y1 = cy - sy / 2, cy + sy / 2
        w.rects.append(Rect(0, x0, (y0, y1, 0.0, h)))
        w.rects.append(Rect(0, x1, (y0, y1, 0.0, h)))
        w.rects.append(Rect(1, y0, (x0, x1, 0.0, h)))
        w.rects.append(Rect(1, y1, (x0, x1, 0.0, h)))
        w.rects.append(Rect(2, h, (x0, x1, y0, y1)))
        placed += 1
    return w


_OTHER_AXES = {0: (1, 2), 1: (0, 2), 2: (0, 1)}


def _rot_patch(p: Patch, axis: np.ndarray, angle: float,
               about: Optional[np.ndarray] = None) -> Patch:
    """Rotate a patch by ``angle`` about ``axis`` (through ``about``)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)
    c = p.center if about is None else about + R @ (p.center - about)
    return Patch(c, R @ p.u, R @ p.v, p.half)


def make_adversarial_world(seed: int = 0, extent: float = 120.0,
                           n_buildings: int = 24,
                           max_tilt_deg: float = 25.0) -> World:
    """The standard world with every surface randomly tilted.

    Breaks the axis-aligned kindness of ``make_world`` (every plane there is
    the best case point-to-plane LOAM can see): building faces and roofs are
    rotated by up to ``max_tilt_deg`` about a random horizontal axis, and
    free-standing tilted slabs are scattered between buildings, so plane
    normals span the sphere instead of {x, y, z}.
    """
    rng = np.random.default_rng(seed)
    base = make_world(seed=seed, extent=extent, n_buildings=n_buildings)
    w = World()
    w.rects = base.rects[:5]  # ground + boundary walls stay (drivable floor)
    for r in base.rects[5:]:
        p = _rect_to_patch(r)
        ang = np.deg2rad(rng.uniform(-max_tilt_deg, max_tilt_deg))
        ax = np.array([np.cos(rng.uniform(0, 2 * np.pi)),
                       np.sin(rng.uniform(0, 2 * np.pi)), 0.0])
        w.patches.append(_rot_patch(p, ax, ang, about=p.center))
    for _ in range(n_buildings // 2):  # tilted free-standing slabs
        cx, cy = rng.uniform(-extent * 0.7, extent * 0.7, size=2)
        if abs(cx) < 14 and abs(cy) < 14:
            continue
        c = np.array([cx, cy, rng.uniform(1.0, 3.0)])
        yaw = rng.uniform(0, 2 * np.pi)
        u = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        v0 = np.array([-np.sin(yaw), np.cos(yaw), 0.0])
        tilt = np.deg2rad(rng.uniform(10, 60))
        v = np.cos(tilt) * np.array([0.0, 0.0, 1.0]) + np.sin(tilt) * v0
        w.patches.append(Patch(c, u, v, (rng.uniform(2, 6),
                                         rng.uniform(1.5, 4))))
    return w


def make_sloped_world(seed: int = 0, extent: float = 60.0,
                      slope_deg: float = 6.0, n_buildings: int = 10) -> World:
    """Inclined ground plane (rotated about y) + tilted structures: exposes
    whether registration itself holds attitude rather than the planar clamp
    defining z/roll/pitch away."""
    rng = np.random.default_rng(seed)
    w = World()
    ground = Patch(np.zeros(3), np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
                   (extent, extent))
    w.patches.append(_rot_patch(ground, np.array([0, 1.0, 0]),
                                np.deg2rad(slope_deg)))
    slope_n = w.patches[0]
    nrm = np.cross(slope_n.u, slope_n.v)
    for _ in range(n_buildings):
        cx, cy = rng.uniform(-extent * 0.8, extent * 0.8, size=2)
        if abs(cx) < 10 and abs(cy) < 10:
            continue
        # ground height at (cx, cy) on the slope: z = -(n_x x + n_y y)/n_z
        gz = -(nrm[0] * cx + nrm[1] * cy) / nrm[2]
        sx, sy = rng.uniform(4, 10, size=2)
        h = rng.uniform(3, 9)
        for face in (Rect(0, cx - sx / 2, (cy - sy / 2, cy + sy / 2, gz, gz + h)),
                     Rect(0, cx + sx / 2, (cy - sy / 2, cy + sy / 2, gz, gz + h)),
                     Rect(1, cy - sy / 2, (cx - sx / 2, cx + sx / 2, gz, gz + h)),
                     Rect(1, cy + sy / 2, (cx - sx / 2, cx + sx / 2, gz, gz + h))):
            p = _rect_to_patch(face)
            ang = np.deg2rad(rng.uniform(-15, 15))
            ax = np.array([np.cos(rng.uniform(0, 2 * np.pi)),
                           np.sin(rng.uniform(0, 2 * np.pi)), 0.0])
            w.patches.append(_rot_patch(p, ax, ang, about=p.center))
    return w


def make_forest_world(seed: int = 0, extent: float = 100.0,
                      n_trees: int = 90, n_buildings: int = 6) -> World:
    """Park/forest world: tree trunks (CURVED surfaces) with vegetation
    canopies (probabilistic scatter), sparse buildings, ground + walls.

    The anti-self-confirmation world: planar rectangles are
    exactly what a point-to-plane pipeline is best at; real park recordings
    (the reference's Zhengzhou/Binhai bags are parks) are dominated by
    trunks and foliage where local plane fits are curved or fuzzy."""
    rng = np.random.default_rng(seed)
    w = make_world(seed=seed, extent=extent, n_buildings=n_buildings)
    for _ in range(n_trees):
        cx, cy = rng.uniform(-extent * 0.85, extent * 0.85, size=2)
        if abs(cx) < 10 and abs(cy) < 10:
            continue  # keep the start area clear
        r = rng.uniform(0.15, 0.5)
        h = rng.uniform(3.0, 8.0)
        w.cylinders.append(Cylinder(cx, cy, r, 0.0, h))
        # canopy: 1-3 blobs around the trunk top
        for _ in range(rng.integers(1, 4)):
            off = rng.normal(0, 1.0, size=2)
            cz = h + rng.uniform(-0.5, 1.5)
            w.blobs.append(Blob(
                np.array([cx + off[0], cy + off[1], cz]),
                radius=rng.uniform(1.0, 2.5),
                hit_prob=rng.uniform(0.25, 0.5),
                jitter=rng.uniform(0.2, 0.6)))
    # ground-level shrubs
    for _ in range(n_trees // 3):
        cx, cy = rng.uniform(-extent * 0.85, extent * 0.85, size=2)
        if abs(cx) < 10 and abs(cy) < 10:
            continue
        w.blobs.append(Blob(np.array([cx, cy, rng.uniform(0.3, 0.8)]),
                            radius=rng.uniform(0.5, 1.2),
                            hit_prob=rng.uniform(0.3, 0.6),
                            jitter=rng.uniform(0.1, 0.3)))
    return w


def _box_patches(cx: float, cy: float, yaw: float, sx: float, sy: float,
                 h: float) -> List[Patch]:
    """Yaw-oriented box: 4 vertical faces + top (a moving obstacle)."""
    c, s = np.cos(yaw), np.sin(yaw)
    u = np.array([c, s, 0.0])       # along sx
    v = np.array([-s, c, 0.0])      # along sy
    z = np.array([0.0, 0.0, 1.0])
    ctr = np.array([cx, cy, h / 2])
    return [
        Patch(ctr + u * sx / 2, v, z, (sy / 2, h / 2)),
        Patch(ctr - u * sx / 2, v, z, (sy / 2, h / 2)),
        Patch(ctr + v * sy / 2, u, z, (sx / 2, h / 2)),
        Patch(ctr - v * sy / 2, u, z, (sx / 2, h / 2)),
        Patch(np.array([cx, cy, h]), u, v, (sx / 2, sy / 2)),
    ]


def make_corridor_world(length: float = 200.0, width: float = 6.0,
                        height: float = 4.0) -> World:
    """A long featureless corridor: translation along x is unobservable by
    point-to-plane registration (every normal is ±y or ±z) — the degeneracy
    case the reference's ``_removeDegeneratePart`` scaffold targets
    (PCR/src/LoamRegister.cpp:209-218)."""
    w = World()
    w.rects.append(Rect(2, 0.0, (-10.0, length, -width / 2, width / 2)))
    w.rects.append(Rect(1, -width / 2, (-10.0, length, 0.0, height)))
    w.rects.append(Rect(1, width / 2, (-10.0, length, 0.0, height)))
    w.rects.append(Rect(2, height, (-10.0, length, -width / 2, width / 2)))
    return w


def simulate_scan(world: World, sensor_pose: np.ndarray, n_az: int = 900,
                  n_el: int = 16, min_range: float = 0.8, max_range: float = 80.0,
                  noise: float = 0.01, rng: Optional[np.random.Generator] = None,
                  outlier_frac: float = 0.0,
                  dropout_frac: float = 0.0,
                  extra_patches: Optional[List[Patch]] = None) -> np.ndarray:
    """Ray-cast one spinning-LiDAR scan. Returns (n, 3) points in sensor frame.

    sensor_pose: (4, 4) world-from-sensor. Elevation fan -15..+15 deg
    (VLP-16-like); rays hitting nothing in [min_range, max_range] are dropped.
    Supports arbitrarily-oriented ``Patch`` surfaces (ray-plane intersection
    + in-plane bounds test), vertical ``Cylinder``s (curved surfaces) and
    probabilistic ``Blob`` scatterers (vegetation clutter). ``outlier_frac``
    replaces that fraction of returns with a random range along the same ray
    (spurious returns: rain, multipath); ``dropout_frac`` drops returns at
    random (reflectance misses). ``extra_patches`` are per-scan transient
    surfaces — the dynamic-object hook (``simulate_sequence`` passes moving
    obstacles through it).
    """
    az = np.linspace(0, 2 * np.pi, n_az, endpoint=False)
    el = np.deg2rad(np.linspace(-15.0, 15.0, n_el))
    azg, elg = np.meshgrid(az, el, indexing="ij")
    d_sensor = np.stack(
        [np.cos(elg) * np.cos(azg), np.cos(elg) * np.sin(azg), np.sin(elg)], axis=-1
    ).reshape(-1, 3)

    R = sensor_pose[:3, :3]
    o = sensor_pose[:3, 3]
    d_world = (d_sensor @ R.T).astype(np.float32)  # (Nr, 3)

    center, u_ax, v_ax, half, normal = world.as_patch_arrays(extra_patches)
    center = center.astype(np.float32)
    u_ax = u_ax.astype(np.float32)
    v_ax = v_ax.astype(np.float32)
    half = half.astype(np.float32)
    normal = normal.astype(np.float32)
    o32 = o.astype(np.float32)
    # t for each ray/patch: ((o + t d) - c) . n = 0. The in-plane bounds
    # test runs on SCALARS per (ray, patch): a = (o-c).u + t (d.u) — never
    # materializing the (Nr, Np, 3) hit-point tensor (the previous form
    # moved ~0.5 GB of f64 intermediates per scan; this one is ~6x faster
    # at identical output, f32 ray math adds <1 mm at the 80 m range, well
    # under the 1 cm sensor noise).
    oc = o32[None, :] - center                                # (Np, 3)
    dn = d_world @ normal.T                                   # (Nr, Np)
    on = -np.einsum("pi,pi->p", oc, normal)                   # (Np,)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = on[None, :] / dn
    t = np.where(np.abs(dn) < 1e-9, np.inf, t)
    t = np.where((t >= min_range) & (t <= max_range), t, np.inf)
    t_fin = np.where(np.isfinite(t), t, 0.0).astype(np.float32)
    oc_u = np.einsum("pi,pi->p", oc, u_ax)                    # (Np,)
    oc_v = np.einsum("pi,pi->p", oc, v_ax)
    a = oc_u[None, :] + t_fin * (d_world @ u_ax.T)
    b = oc_v[None, :] + t_fin * (d_world @ v_ax.T)
    ok = (np.isfinite(t)
          & (np.abs(a) <= half[None, :, 0]) & (np.abs(b) <= half[None, :, 1]))
    t = np.where(ok, t, np.inf)
    tmin = t.min(axis=1)
    rng = rng or np.random.default_rng(0)

    # vertical cylinders: |o_xy + t d_xy - c_xy|^2 = r^2, nearest positive
    # root with z in [z0, z1]
    if world.cylinders:
        ccx = np.array([c.cx for c in world.cylinders], np.float32)
        ccy = np.array([c.cy for c in world.cylinders], np.float32)
        cr = np.array([c.radius for c in world.cylinders], np.float32)
        cz0 = np.array([c.z0 for c in world.cylinders], np.float32)
        cz1 = np.array([c.z1 for c in world.cylinders], np.float32)
        dx, dy, dz = d_world[:, 0:1], d_world[:, 1:2], d_world[:, 2:3]
        ox = o32[0] - ccx[None, :]                       # (Nr, Nc)
        oy = o32[1] - ccy[None, :]
        a2 = dx * dx + dy * dy                           # (Nr, 1)
        bb = ox * dx + oy * dy
        cc = ox * ox + oy * oy - cr[None, :] ** 2
        with np.errstate(invalid="ignore", divide="ignore"):
            disc = bb * bb - a2 * cc
            sq = np.sqrt(np.maximum(disc, 0.0))
            tc = (-bb - sq) / np.maximum(a2, 1e-12)      # near root
        zc = o32[2] + tc * dz
        okc = ((disc > 0) & (tc >= min_range) & (tc <= max_range)
               & (zc >= cz0[None, :]) & (zc <= cz1[None, :]))
        tc = np.where(okc, tc, np.inf).min(axis=1)
        tmin = np.minimum(tmin, tc)

    # vegetation blobs: ray-sphere hit accepted with hit_prob, range
    # jittered inward (leaf penetration) — occludes like a soft surface
    if world.blobs:
        bc = np.stack([b.center for b in world.blobs]).astype(np.float32)
        br = np.array([b.radius for b in world.blobs], np.float32)
        bp = np.array([b.hit_prob for b in world.blobs], np.float32)
        bj = np.array([b.jitter for b in world.blobs], np.float32)
        ob = o32[None, :] - bc                           # (Nb, 3)
        b_lin = d_world @ ob.T                           # (Nr, Nb)
        c_lin = np.einsum("bi,bi->b", ob, ob)[None, :] - br[None, :] ** 2
        with np.errstate(invalid="ignore"):
            disc = b_lin * b_lin - c_lin
            sq = np.sqrt(np.maximum(disc, 0.0))
            tb = -b_lin - sq
        hit = ((disc > 0) & (tb >= min_range) & (tb <= max_range)
               & (rng.random(tb.shape) < bp[None, :]))
        tb = tb + rng.random(tb.shape).astype(np.float32) * (
            2.0 * sq) * (bj[None, :] / np.maximum(br[None, :], 1e-6)).clip(0, 1)
        tb = np.where(hit, tb, np.inf).min(axis=1)
        tmin = np.minimum(tmin, tb)

    valid = np.isfinite(tmin)
    tv = tmin[valid]
    dv = d_world[valid]
    if outlier_frac > 0:
        out = rng.random(len(tv)) < outlier_frac
        tv = np.where(out, rng.uniform(min_range, max_range, len(tv)), tv)
    if dropout_frac > 0:
        keep = rng.random(len(tv)) >= dropout_frac
        tv, dv = tv[keep], dv[keep]
    pts_world = o[None, :] + tv[:, None] * dv
    pts_sensor = (pts_world - o) @ R
    if noise > 0:
        pts_sensor = pts_sensor + rng.normal(size=pts_sensor.shape) * noise
    return pts_sensor.astype(np.float32)


def make_trajectory(n_scans: int = 200, dt: float = 0.1, speed: float = 1.5,
                    radius: float = 40.0, loop: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Planar circular(ish) trajectory: returns (stamps (n,), poses (n, 4, 4)).

    Poses are body poses on the ground plane (z = 0), yaw tangent to the
    path — the geometry the reference's planar clamp assumes.
    """
    stamps = np.arange(n_scans) * dt
    arc = speed * stamps
    if loop:
        theta = arc / radius
        x = radius * np.sin(theta)
        y = radius * (1 - np.cos(theta))
        yaw = theta
    else:
        x = arc
        y = np.zeros_like(arc)
        yaw = np.zeros_like(arc)
    poses = np.tile(np.eye(4, dtype=np.float64), (n_scans, 1, 1))
    c, s = np.cos(yaw), np.sin(yaw)
    poses[:, 0, 0] = c
    poses[:, 0, 1] = -s
    poses[:, 1, 0] = s
    poses[:, 1, 1] = c
    poses[:, 0, 3] = x
    poses[:, 1, 3] = y
    return stamps, poses


def sensor_from_body(body_pose: np.ndarray, lidar_height: float = 2.0) -> np.ndarray:
    """World-from-sensor pose: body pose lifted by the lidar mast height."""
    sp = body_pose.copy()
    sp[2, 3] += lidar_height
    return sp


@dataclass
class SensorStreams:
    """Simulated sensor bundle for one sequence (the 'rosbag')."""

    scan_stamps: np.ndarray          # (S,)
    scans: List[np.ndarray]          # S x (n_i, 3) sensor-frame points
    gt_poses: np.ndarray             # (S, 4, 4) body ground truth
    wheel_stamps: np.ndarray         # (W,)
    wheel_poses: np.ndarray          # (W, 4, 4) wheel-integrated odometry (drifty)
    imu_stamps: np.ndarray           # (I,)
    imu_quats: np.ndarray            # (I, 4) (w, x, y, z) orientation (drifty yaw)


def simulate_sequence(world: World, n_scans: int = 200, dt: float = 0.1,
                      speed: float = 1.5, radius: float = 40.0,
                      lidar_height: float = 2.0, seed: int = 0,
                      wheel_rate: float = 20.0, imu_rate: float = 100.0,
                      scan_noise: float = 0.01,
                      n_az: int = 900, n_el: int = 16,
                      loop: bool = True,
                      n_dynamic: int = 0) -> SensorStreams:
    """Simulate one sequence. ``n_dynamic`` > 0 adds moving obstacles
    (pedestrian/vehicle-scale boxes) that CROSS the robot's path: they
    appear in scans but not in the map's static structure, so registration
    and keyframe maps must absorb them as dynamic clutter — the moving-world
    failure mode planar static sims never exercise."""
    rng = np.random.default_rng(seed)
    stamps, poses = make_trajectory(n_scans, dt, speed, radius, loop=loop)
    movers = []
    if n_dynamic > 0:
        duration = n_scans * dt
        for _ in range(n_dynamic):
            # spawn near a random future path point, walk across it
            ti = rng.uniform(0.1, 0.9) * duration
            k = min(int(ti / dt), n_scans - 1)
            px, py = poses[k, 0, 3], poses[k, 1, 3]
            heading = rng.uniform(0, 2 * np.pi)
            spd = rng.uniform(0.8, 4.0)       # walker .. slow vehicle
            start = np.array([px, py]) - np.array(
                [np.cos(heading), np.sin(heading)]) * spd * (ti - 0.0)
            if rng.random() < 0.5:
                dims = (0.5, 0.5, 1.8)        # pedestrian
            else:
                dims = (4.0, 1.8, 1.6)        # vehicle
            movers.append((start, heading, spd, dims))
    scans = []
    for i in range(n_scans):
        extra = []
        for start, heading, spd, dims in movers:
            t = stamps[i]
            cx = start[0] + np.cos(heading) * spd * t
            cy = start[1] + np.sin(heading) * spd * t
            extra.extend(_box_patches(cx, cy, heading, *dims))
        scans.append(
            simulate_scan(world, sensor_from_body(poses[i], lidar_height),
                          n_az=n_az, n_el=n_el, noise=scan_noise, rng=rng,
                          extra_patches=extra or None))

    duration = stamps[-1] + dt
    # wheel odometry: integrate gt planar motion with multiplicative slip noise
    wn = int(duration * wheel_rate)
    w_stamps = np.arange(wn) / wheel_rate
    gt_xyyaw = _interp_planar(stamps, poses, w_stamps)
    wheel_xyyaw = gt_xyyaw.copy()
    d = np.diff(gt_xyyaw, axis=0, prepend=gt_xyyaw[:1])
    slip = 1.0 + rng.normal(0, 0.01, size=(wn, 1))
    noise_yaw = rng.normal(0, 0.002, size=wn)
    wheel_xyyaw = np.cumsum(d * np.concatenate([slip, slip, np.ones((wn, 1))], 1), axis=0)
    wheel_xyyaw[:, 2] += np.cumsum(noise_yaw) * 0.02 + gt_xyyaw[0, 2]
    wheel_xyyaw[:, :2] += gt_xyyaw[0, :2]
    wheel_poses = _planar_to_pose(wheel_xyyaw)

    # imu: orientation with slow yaw drift + noise
    inn = int(duration * imu_rate)
    i_stamps = np.arange(inn) / imu_rate
    gt_i = _interp_planar(stamps, poses, i_stamps)
    yaw = gt_i[:, 2] + np.cumsum(rng.normal(0, 1e-4, size=inn)) + rng.normal(0, 5e-4, size=inn)
    quats = np.stack(
        [np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)], axis=1
    )
    return SensorStreams(stamps, scans, poses, w_stamps, wheel_poses, i_stamps, quats)


def spiral_sequence(world: World, n_scans: int, r0: float,
                    lap_gap: float = 1.8, step: float = 0.3,
                    n_az: int = 900, n_el: int = 16, noise: float = 0.01,
                    seed: int = 0) -> SensorStreams:
    """Outward spiral r = r0 + lap_gap * theta / 2pi around (0, r0), scans
    ``step`` meters apart, lidar only. Every lap revisits the previous one's
    structures ~lap_gap to the side, so keyframes KEEP being admitted past
    the 1 m nearest-keyframe gate and loop closure sees a sustained revisit
    stream (an exact retrace of a circle stops producing keyframes, and so
    closure candidates, after lap one)."""
    rng = np.random.default_rng(seed)
    c = lap_gap / (2 * np.pi)
    # angle table covering the arc length n_scans * step: the arc is at
    # least r0 * th + c * th^2 / 2, so this th_max (plus 1 %) reaches it
    arc = n_scans * step
    th_max = (np.sqrt(r0 ** 2 + 2 * c * arc) - r0) / c
    th_fine = np.linspace(0, 1.01 * th_max, 40000)
    r_fine = r0 + c * th_fine
    s_fine = np.concatenate([[0.0], np.cumsum(
        np.sqrt(r_fine[:-1] ** 2 + c ** 2) * np.diff(th_fine))])
    th = np.interp(np.arange(n_scans) * step, s_fine, th_fine)
    r = r0 + c * th
    x = r * np.sin(th)
    y = r0 - r * np.cos(th)
    yaw = np.unwrap(np.arctan2(np.gradient(y), np.gradient(x)))
    poses = np.tile(np.eye(4), (n_scans, 1, 1))
    poses[:, 0, 0] = np.cos(yaw)
    poses[:, 0, 1] = -np.sin(yaw)
    poses[:, 1, 0] = np.sin(yaw)
    poses[:, 1, 1] = np.cos(yaw)
    poses[:, 0, 3] = x
    poses[:, 1, 3] = y
    stamps = np.arange(n_scans) * 0.1
    scans = [simulate_scan(world, sensor_from_body(poses[i]), n_az=n_az,
                           n_el=n_el, noise=noise, rng=rng)
             for i in range(n_scans)]
    # ground truth in the map frame the SLAM run builds (its first body
    # pose): the spiral starts with yaw -atan(c / r0), not 0, and scoring
    # world-frame poses would charge that rotation to the estimate
    gt = np.einsum("ab,nbc->nac", np.linalg.inv(poses[0]), poses)
    return SensorStreams(stamps, scans, gt, np.zeros(0),
                         np.zeros((0, 4, 4)), np.zeros(0), np.zeros((0, 4)))


def _interp_planar(stamps: np.ndarray, poses: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Interpolate (x, y, yaw) of body poses at times t (yaw unwrapped)."""
    x = np.interp(t, stamps, poses[:, 0, 3])
    y = np.interp(t, stamps, poses[:, 1, 3])
    yaw_src = np.unwrap(np.arctan2(poses[:, 1, 0], poses[:, 0, 0]))
    yaw = np.interp(t, stamps, yaw_src)
    return np.stack([x, y, yaw], axis=1)


def _planar_to_pose(xyyaw: np.ndarray) -> np.ndarray:
    n = xyyaw.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    c, s = np.cos(xyyaw[:, 2]), np.sin(xyyaw[:, 2])
    poses[:, 0, 0] = c
    poses[:, 0, 1] = -s
    poses[:, 1, 0] = s
    poses[:, 1, 1] = c
    poses[:, 0, 3] = xyyaw[:, 0]
    poses[:, 1, 3] = xyyaw[:, 1]
    return poses


def cache_streams(tag: str, builder):
    """Deterministic disk cache for simulated sensor streams (test/bench
    fixtures). Enabled by the ``SIMPLESLAM_SIM_CACHE`` env var (a directory;
    tests/conftest.py sets it): ray-casting a multi-hundred-scan fixture
    costs tens of seconds of pure numpy per suite run while being fully
    deterministic. The cache key hashes THIS module's source AND the
    caller's file, so any change to the simulator or to the fixture builder
    invalidates automatically — a stale fixture can never mask a behavior
    change.
    """
    import hashlib
    import inspect
    import pickle
    import re

    cache_dir = os.environ.get("SIMPLESLAM_SIM_CACHE", "")
    if not cache_dir:
        return builder()
    h = hashlib.sha256()
    h.update(open(__file__, "rb").read())
    try:
        caller = inspect.stack()[1].filename
        h.update(open(caller, "rb").read())
    except OSError:
        pass
    h.update(tag.encode())
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", tag)[:80]
    fn = os.path.join(cache_dir, f"streams_{safe}_{h.hexdigest()[:20]}.pkl")
    if os.path.isfile(fn):
        with open(fn, "rb") as f:
            return pickle.load(f)
    out = builder()
    os.makedirs(cache_dir, exist_ok=True)
    tmp = fn + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, fn)
    return out


# ---------------------------------------------------------------------------
# trajectory metrics (evo-style APE/RPE, the reference's evaluation protocol)
# ---------------------------------------------------------------------------

def ate_rmse(gt: np.ndarray, est: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over translations (optionally SE(3)
    aligned by Umeyama without scale — evo's default APE protocol)."""
    g = gt[:, :3, 3]
    e = est[:, :3, 3]
    if align and len(g) >= 3:
        e = _umeyama_align(e, g)
    return float(np.sqrt(np.mean(np.sum((g - e) ** 2, axis=1))))


def kf_ate_rmse(streams: SensorStreams, kf_stamps: np.ndarray,
                kf_poses: np.ndarray) -> float:
    """ATE over the OPTIMIZED KEYFRAME trajectory — the reference's actual
    evaluation artifact (the keyframe TUM written at shutdown,
    /root/reference/backend/src/Backend.cpp:349-358). Keyframes are scans,
    so ground truth is looked up by nearest stamp in the full stream."""
    if kf_stamps is None or len(kf_stamps) < 2:
        return float("nan")
    st = streams.scan_stamps
    idx = np.clip(np.searchsorted(st, kf_stamps), 0, len(st) - 1)
    idx = np.where(
        (idx > 0) & (np.abs(st[idx - 1] - kf_stamps)
                     < np.abs(st[idx] - kf_stamps)), idx - 1, idx)
    return ate_rmse(streams.gt_poses[idx], kf_poses, align=False)


def rpe_rmse(gt: np.ndarray, est: np.ndarray, delta: int = 1) -> float:
    """Relative pose error RMSE over translation of per-delta increments."""
    errs = []
    for i in range(len(gt) - delta):
        g_rel = np.linalg.inv(gt[i]) @ gt[i + delta]
        e_rel = np.linalg.inv(est[i]) @ est[i + delta]
        d = np.linalg.inv(g_rel) @ e_rel
        errs.append(np.sum(d[:3, 3] ** 2))
    return float(np.sqrt(np.mean(errs))) if errs else 0.0


def _umeyama_align(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    mu_s, mu_d = src.mean(0), dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return (src - mu_s) @ R.T + mu_d
