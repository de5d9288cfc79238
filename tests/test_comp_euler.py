"""Prior-art comparison: LIO-SAM-style Euler-angle scan2map vs Lie-group GN.

The reference ships a re-implemented liorf/LIO-SAM scan2map run on the SAME
scan/submap/init-pose fixtures to show its Lie-group (SE(3) exp) update is at
least as good as the original LOAM Euler-angle update
(``/root/reference/test/comp/liorf_scan2map.cpp:92-96``, README.md:33). This
is the equivalent head-to-head: both optimizers share the same
candidate gather, plane fits, weights, and thresholds (ops/loam.py); they
differ ONLY in the update parametrization —

- Lie group:  pose <- exp(dx) * pose, J = n^T [I | -skew(p)]  (ours)
- Euler:      (r, p, y, x, y, z) += dx, J = [n^T dR/d(rpy) p_body | n^T]
  (LIO-SAM's LMOptimization parametrization, jacobians by autodiff)

so differences in convergence measure the *parametrization*, not the
pipeline.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simpleslam_tpu.ops import geometry as geo
from simpleslam_tpu.ops import loam
from simpleslam_tpu.ops import pointcloud as pcops
from simpleslam_tpu.ops import voxel as vox


def _rpy_matrix(rpy: jax.Array) -> jax.Array:
    """ZYX convention: R = Rz(yaw) Ry(pitch) Rx(roll) (LIO-SAM's frame)."""
    r, p, y = rpy[0], rpy[1], rpy[2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    Rz = jnp.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = jnp.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = jnp.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


def _rpy_from_matrix(R: np.ndarray) -> np.ndarray:
    return np.array([
        np.arctan2(R[2, 1], R[2, 2]),
        -np.arcsin(np.clip(R[2, 0], -1, 1)),
        np.arctan2(R[1, 0], R[0, 0]),
    ])


@partial(jax.jit, static_argnames=("max_iters",))
def euler_scan2map(src: pcops.PointCloud, vm, init_rpy: jax.Array,
                   init_t: jax.Array, max_iters: int = 30):
    """LIO-SAM-style GN on (roll, pitch, yaw, tx, ty, tz).

    Per iteration: transform by the current Euler pose, reuse the shared
    plane-fit machinery (loam.build_normal_equations) by linearizing the
    residual wrt the 6 Euler params via jacfwd of the pose map, then the same
    solve/convergence gates as the Lie path (liorf_scan2map.cpp role).
    """

    def params_to_pose(params):
        R = _rpy_matrix(params[:3])
        return jnp.eye(4, dtype=jnp.float32).at[:3, :3].set(R).at[:3, 3].set(
            params[3:])

    def body(carry):
        params, it, conv, failed, _ = carry

        def half_chi(params):
            pose = params_to_pose(params)
            JtJ, JtE, n_valid = loam.build_normal_equations(src, vm, pose)
            return JtJ, JtE, n_valid

        # Gauss-Newton in the Euler chart: pull the Lie-frame normal
        # equations back through d(exp-chart)/d(euler) — dx_lie = A dx_euler
        # where A = d(se3_log(pose(params+d) pose(params)^-1))/dd at d=0.
        pose = params_to_pose(params)

        def lie_of(d):
            pose_d = params_to_pose(params + d)
            return geo.se3_log(geo.pose_compose(pose_d, geo.pose_inverse(pose)))

        A = jax.jacfwd(lie_of)(jnp.zeros(6, jnp.float32))  # (6lie, 6euler)
        JtJ, JtE, n_valid = half_chi(params)
        # normal equations in the euler chart: (A^T JtJ A) dx = -A^T JtE
        H = A.T @ JtJ @ A
        g = A.T @ JtE
        enough = n_valid >= loam.MIN_VALID_ROWS
        H_safe = H + jnp.eye(6, dtype=H.dtype) * jnp.where(enough, 1e-6, 1.0)
        dx = jnp.linalg.solve(H_safe, -g)
        conv_now = (jnp.linalg.norm(dx[3:]) <= loam.POS_CONVERGE) & (
            jnp.linalg.norm(dx[:3]) <= loam.ROT_CONVERGE)
        new_params = jnp.where(conv_now | ~enough, params, params + dx)
        return (new_params, it + 1, conv_now & enough, ~enough, n_valid)

    def cond(carry):
        _, it, conv, failed, _ = carry
        return (it < max_iters) & (~conv) & (~failed)

    params0 = jnp.concatenate([init_rpy, init_t]).astype(jnp.float32)
    params, iters, conv, _, n_valid = jax.lax.while_loop(
        cond, body, (params0, jnp.int32(0), jnp.array(False),
                     jnp.array(False), jnp.int32(0)))
    return params_to_pose(params), conv, iters


@pytest.fixture(scope="module")
def fixture():
    """Shared scan/submap/init fixture (the DATA_DIR submap1/scan1 role)."""
    rng = np.random.default_rng(7)
    n_map = 4096
    g = rng.uniform(-12, 12, size=(n_map, 2)).astype(np.float32)
    ground = np.stack([g[:, 0], g[:, 1], np.zeros(n_map, np.float32)], 1)
    w1 = np.stack([g[:, 0], np.full(n_map, 12.0, np.float32),
                   np.abs(g[:, 1]) * 0.25 + 1], 1)
    w2 = np.stack([np.full(n_map, -12.0, np.float32), g[:, 0],
                   np.abs(g[:, 1]) * 0.25 + 1], 1)
    map_xyz = (np.concatenate([ground, w1, w2])
               + rng.normal(size=(3 * n_map, 3)).astype(np.float32) * 0.01)
    map_pc = pcops.from_numpy(map_xyz, 16384)
    vm = vox.build_dense_voxel_map(
        map_pc, 2.0, jnp.zeros(3, jnp.float32), dims=(24, 24, 8),
        slab_size=24)
    src_idx = rng.choice(len(map_xyz), size=2048, replace=False)
    src = pcops.from_numpy(map_xyz[src_idx], 2048)
    return src, vm


def _run_both(fixture, gt_offset_twist):
    src, vm = fixture
    T_err = np.asarray(geo.se3_exp(jnp.asarray(gt_offset_twist, jnp.float32)))
    init = T_err  # ground truth is identity; init starts offset by T_err

    lie = loam.scan2map(src, vm, jnp.asarray(init, jnp.float32))
    lie_pose = np.asarray(lie.pose, np.float64)

    rpy = _rpy_from_matrix(init[:3, :3])
    e_pose, e_conv, e_iters = euler_scan2map(
        src, vm, jnp.asarray(rpy, jnp.float32),
        jnp.asarray(init[:3, 3], jnp.float32), max_iters=loam.MAX_ITERS)
    e_pose = np.asarray(e_pose, np.float64)

    def err(T):
        return (np.linalg.norm(T[:3, 3]),
                np.linalg.norm(T[:3, :3] - np.eye(3)))

    return (err(lie_pose), bool(lie.converged), int(lie.iters),
            err(e_pose), bool(e_conv), int(e_iters))


def test_small_offset_parity(fixture):
    """Both parametrizations recover a small offset; ours at least as well."""
    (lt, lr), lconv, liters, (et, er), econv, eiters = _run_both(
        fixture, [0.2, -0.15, 0.05, 0.02, 0.01, 0.06])
    assert lconv
    assert lt < 0.03 and lr < 0.02
    # Euler should also converge here; the Lie pose must be no worse
    assert lt <= et + 0.02 and lr <= er + 0.02
    assert liters <= eiters + 1


def test_large_rotation_lie_advantage(fixture):
    """At a large yaw offset the Lie update must stay at least as accurate.

    (The reference's motivating claim for its Lie-group LoamRegister,
    README.md:33: equal-or-better convergence than the Euler-angle original.)
    """
    (lt, lr), lconv, _, (et, er), _, _ = _run_both(
        fixture, [0.3, 0.3, 0.0, 0.0, 0.0, 0.35])  # 20 deg yaw + 0.42 m
    assert lconv
    assert lt < 0.05 and lr < 0.03
    assert lt <= et + 1e-3 and lr <= er + 1e-3
