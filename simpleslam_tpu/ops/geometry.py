"""SE(3)/SO(3) manifold ops and rotation conversions (pure JAX, vmappable).

Behavioral parity targets (reference: /root/reference/common/geometry/):
- ``so3_exp`` / ``se3_exp``: Rodrigues + V-matrix closed forms with the same
  small-angle cutoff semantics as ``manifolds.hpp:16-58`` (t < 1e-6 -> identity
  rotation), but implemented branch-free with ``jnp.where`` so they trace once.
- ``j_se3``: the 3x6 point Jacobian [I | -skew(p)] of ``manifolds.hpp:61-67``.
- ``quat_to_ypr`` / ``ypr_to_quat``: static-axis ZYX conventions of
  ``trans.hpp:24-50`` including the gimbal-singularity branch.
- ``reorthonormalize``: rotation cleanup via quaternion round-trip, the role of
  ``trans::T2SE3`` (``trans.hpp:62-67``).
- ``six_dof_to_mobile``: planar clamp of ``trans::SixDof2Mobile``
  (``trans.hpp:69-86``) — keep (x, y, yaw) only, and only keep yaw when the
  rotation axis is within ~18 deg of +/-Z (|axis.z| > 0.95).
- ``correct_angles``: wrap to +/-pi about a reference (``Math.hpp:24-29``).

Everything is float32-first; all functions accept batched inputs
via vmap. Poses are 4x4 homogeneous matrices ("pose" below).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-6


def skew(w: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def _safe_norm(w: jax.Array):
    """norm with a NaN-free gradient at 0: returns (small_mask, safe_norm).

    The double-where trick: sqrt only ever sees values bounded away from 0, so
    reverse-mode AD stays finite; callers must select the small-angle result
    with a final ``jnp.where(small, ...)``.
    """
    sq = jnp.sum(w * w, axis=-1, keepdims=True)
    small = sq < _EPS * _EPS
    t_safe = jnp.sqrt(jnp.where(small, 1.0, sq))
    return small, t_safe


def so3_exp(w: jax.Array) -> jax.Array:
    """Rodrigues formula, (..., 3) -> (..., 3, 3).

    Small-angle branch uses the 2nd-order Taylor form (I + [w]x + [w]x²/2) so
    both the value and the gradient are exact to machine precision at w -> 0
    (the reference's identity-snap at t < 1e-6, manifolds.hpp:19-22, has a
    zero derivative there — ours is the AD-correct generalization).
    """
    small, t_safe = _safe_norm(w)
    t = jnp.where(small, 0.0, t_safe)
    a = w / t_safe
    ct = jnp.cos(t)[..., None]
    st = jnp.sin(t)[..., None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), w.shape[:-1] + (3, 3))
    aa = a[..., :, None] * a[..., None, :]
    R = ct * eye + (1.0 - ct) * aa + st * skew(a)
    W = skew(w)
    R_taylor = eye + W + 0.5 * (W @ W)
    return jnp.where(small[..., None], R_taylor, R)


def so3_log(R: jax.Array) -> jax.Array:
    """(..., 3, 3) -> (..., 3) rotation-vector log map (stable near 0 and pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    t = jnp.arccos(cos_t)
    # Antisymmetric part / (2 sin t) — stable for t away from 0 and pi.
    w_hat = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    sin_t = jnp.sin(t)
    near_zero = t < 1e-4
    near_pi = jnp.pi - t < 1e-3
    scale = jnp.where(near_zero, 0.5, t / jnp.where(sin_t == 0, 1.0, 2.0 * sin_t))
    w_generic = w_hat * scale[..., None]
    # Near pi: w = t * axis, axis from the symmetric part (largest diagonal).
    B = (R + jnp.swapaxes(R, -1, -2)) * 0.5  # = I + (1 - cos t) (aa^T - I)/... -> use diag
    diag = jnp.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], axis=-1)
    axis_sq = jnp.clip((diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + 1e-12), 0.0, 1.0)
    axis_abs = jnp.sqrt(axis_sq)
    # Fix signs from off-diagonal products relative to the dominant axis.
    k = jnp.argmax(axis_abs, axis=-1)

    def _signed_axis(Rm, axis_abs_m, km):
        off = jnp.stack(
            [
                jnp.stack([axis_abs_m[0], Rm[0, 1] + Rm[1, 0], Rm[0, 2] + Rm[2, 0]]),
                jnp.stack([Rm[0, 1] + Rm[1, 0], axis_abs_m[1], Rm[1, 2] + Rm[2, 1]]),
                jnp.stack([Rm[0, 2] + Rm[2, 0], Rm[1, 2] + Rm[2, 1], axis_abs_m[2]]),
            ]
        )
        row = off[km]
        signs = jnp.where(row >= 0, 1.0, -1.0)
        signs = signs.at[km].set(1.0)
        return signs * axis_abs_m

    if R.ndim == 2:
        axis_signed = _signed_axis(R, axis_abs, k)
    else:
        flatR = R.reshape((-1, 3, 3))
        axis_signed = jax.vmap(_signed_axis)(
            flatR, axis_abs.reshape((-1, 3)), k.reshape((-1,))
        ).reshape(axis_abs.shape)
    w_pi = axis_signed * t[..., None]
    w = jnp.where(near_pi[..., None], w_pi, w_generic)
    return jnp.where(near_zero[..., None], w_hat * 0.5, w)


def _so3_left_jacobian(w: jax.Array) -> jax.Array:
    """V matrix of the SE(3) exp map: V = st/t I + (1-st/t) aa^T + ((1-ct)/t) [a]x."""
    small, t_safe = _safe_norm(w)
    t = jnp.where(small, 0.0, t_safe)
    a = w / t_safe
    st_over_t = jnp.sin(t)[..., None] / t_safe[..., None]
    one_m_ct_over_t = (1.0 - jnp.cos(t))[..., None] / t_safe[..., None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), w.shape[:-1] + (3, 3))
    aa = a[..., :, None] * a[..., None, :]
    V = st_over_t * eye + (1.0 - st_over_t) * aa + one_m_ct_over_t * skew(a)
    W = skew(w)
    V_taylor = eye + 0.5 * W + (W @ W) / 6.0  # 2nd-order Taylor, AD-exact at 0
    return jnp.where(small[..., None], V_taylor, V)


def se3_exp(k: jax.Array) -> jax.Array:
    """SE(3) exp: (..., 6) twist [rho, w] -> (..., 4, 4).

    Twist ordering matches the reference solver state: translation first,
    rotation last (``manifolds.hpp:33-35``: p = head<3>, w = tail<3>).
    """
    p = k[..., :3]
    w = k[..., 3:]
    R = so3_exp(w)
    V = _so3_left_jacobian(w)
    t = jnp.einsum("...ij,...j->...i", V, p)
    return make_pose(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """SE(3) log: (..., 4, 4) -> (..., 6) twist [rho, w] (inverse of se3_exp)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    V = _so3_left_jacobian(w)
    rho = jnp.linalg.solve(V, t[..., None])[..., 0]
    return jnp.concatenate([rho, w], axis=-1)


def j_se3(p: jax.Array) -> jax.Array:
    """Point Jacobian d(exp(x) p)/dx at x=0: (..., 3) -> (..., 3, 6) = [I | -skew(p)]."""
    eye = jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), p.shape[:-1] + (3, 3))
    return jnp.concatenate([eye, -skew(p)], axis=-1)


# ---------------------------------------------------------------------------
# pose (4x4) helpers
# ---------------------------------------------------------------------------

def make_pose(R: jax.Array, t: jax.Array) -> jax.Array:
    """(..., 3, 3) + (..., 3) -> (..., 4, 4)."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (4,)
    )
    return jnp.concatenate([top, bottom[..., None, :]], axis=-2)


def pose_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.eye(4, dtype=dtype)


def pose_inverse(T: jax.Array) -> jax.Array:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return make_pose(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def pose_compose(A: jax.Array, B: jax.Array) -> jax.Array:
    return jnp.einsum("...ij,...jk->...ik", A, B)


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply (4, 4) pose to (..., 3) points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


# ---------------------------------------------------------------------------
# quaternion / euler conversions (static-axis ZYX, reference trans.hpp)
# ---------------------------------------------------------------------------

def rot_to_quat(R: jax.Array) -> jax.Array:
    """(..., 3, 3) -> (..., 4) quaternion (w, x, y, z), normalized, w >= 0 free.

    Branch-free Shepperd's method (selects the numerically best of 4 forms).
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw0 = jnp.sqrt(jnp.clip(1.0 + tr, 1e-12, None)) * 0.5
    q0 = jnp.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], axis=-1)

    qx1 = jnp.sqrt(jnp.clip(1.0 + m00 - m11 - m22, 1e-12, None)) * 0.5
    q1 = jnp.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)], axis=-1)

    qy2 = jnp.sqrt(jnp.clip(1.0 - m00 + m11 - m22, 1e-12, None)) * 0.5
    q2 = jnp.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)], axis=-1)

    qz3 = jnp.sqrt(jnp.clip(1.0 - m00 - m11 + m22, 1e-12, None)) * 0.5
    q3 = jnp.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3], axis=-1)

    cases = jnp.stack([tr, m00, m11, m22], axis=-1)
    best = jnp.argmax(cases, axis=-1)
    use_tr = tr > 0
    sel = jnp.where(use_tr, 0, best + 0)
    qs = jnp.stack([q0, q1, q2, q3], axis=-2)
    q = jnp.take_along_axis(qs, sel[..., None, None].astype(jnp.int32), axis=-2)[..., 0, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_rot(q: jax.Array) -> jax.Array:
    """(..., 4) (w, x, y, z) -> (..., 3, 3). Normalizes first."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1),
        ],
        axis=-2,
    )


def rot_to_ypr(R: jax.Array) -> jax.Array:
    """(..., 3, 3) -> (yaw, pitch, roll) static-axis ZYX, incl. singular branch.

    Parity with ``trans::q2ypr`` (trans.hpp:24-43).
    """
    r20 = R[..., 2, 0]
    singular = jnp.abs(r20) >= 1.0
    yaw = jnp.where(singular, 0.0, jnp.arctan2(R[..., 1, 0], R[..., 0, 0]))
    pitch = jnp.where(
        singular,
        jnp.sign(-r20) * (jnp.pi / 2),
        -jnp.arcsin(jnp.clip(r20, -1.0, 1.0)),
    )
    roll = jnp.where(
        singular,
        jnp.arctan2(R[..., 0, 1], R[..., 0, 2]),
        jnp.arctan2(R[..., 2, 1], R[..., 2, 2]),
    )
    return jnp.stack([yaw, pitch, roll], axis=-1)


def quat_to_ypr(q: jax.Array) -> jax.Array:
    return rot_to_ypr(quat_to_rot(q))


def ypr_to_rot(ypr: jax.Array) -> jax.Array:
    """(yaw, pitch, roll) -> R = Rz(yaw) Ry(pitch) Rx(roll) (trans.hpp:45-50)."""
    y, p, r = ypr[..., 0], ypr[..., 1], ypr[..., 2]
    cy, sy = jnp.cos(y), jnp.sin(y)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cr, sr = jnp.cos(r), jnp.sin(r)
    return jnp.stack(
        [
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
            jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
            jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def ypr_to_quat(ypr: jax.Array) -> jax.Array:
    return rot_to_quat(ypr_to_rot(ypr))


def reorthonormalize(T: jax.Array) -> jax.Array:
    """Snap the rotation block back onto SO(3) via quaternion round-trip.

    Role of ``trans::T2SE3`` (trans.hpp:62-67) — applied after GN pose updates.
    """
    R = quat_to_rot(rot_to_quat(T[..., :3, :3]))
    return make_pose(R, T[..., :3, 3])


def six_dof_to_mobile(T: jax.Array) -> jax.Array:
    """Planar clamp: keep (x, y) and, when the rotation axis is near +/-Z,
    re-express the rotation as a pure yaw of the same angle (trans.hpp:69-86).

    When the axis is NOT near Z (|axis.z| <= 0.95) the rotation becomes the
    identity — faithful to the reference, which only sets a rotation inside
    the axis check.
    """
    R = T[..., :3, :3]
    w = so3_log(R)  # angle * axis
    angle = jnp.linalg.norm(w, axis=-1)
    safe = jnp.where(angle < _EPS, 1.0, angle)
    axis_z = w[..., 2] / safe
    near_z = jnp.abs(axis_z) > 0.95
    yaw_angle = jnp.where(near_z, angle * jnp.sign(axis_z), 0.0)
    cz, sz = jnp.cos(yaw_angle), jnp.sin(yaw_angle)
    zero = jnp.zeros_like(cz)
    one = jnp.ones_like(cz)
    Rz = jnp.stack(
        [
            jnp.stack([cz, -sz, zero], axis=-1),
            jnp.stack([sz, cz, zero], axis=-1),
            jnp.stack([zero, zero, one], axis=-1),
        ],
        axis=-2,
    )
    t = T[..., :3, 3]
    t = jnp.stack([t[..., 0], t[..., 1], jnp.zeros_like(t[..., 2])], axis=-1)
    return make_pose(Rz, t)


def correct_angles(a: jax.Array, ref: jax.Array) -> jax.Array:
    """Wrap ``a`` into (ref - pi, ref + pi] (Math.hpp:24-29), branch-free."""
    return a - 2.0 * jnp.pi * jnp.round((a - ref) / (2.0 * jnp.pi))
