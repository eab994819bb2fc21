"""Quaternions and animated transforms (keyframe motion).

Functional equivalents of the reference's Quaternion
(/root/reference/core/Quaternion.{h,cpp}) and AnimatedTransform
(/root/reference/core/Transform.h:397, core/Transform.cpp:1089-1260):

  * quaternions are (..., 4) jnp arrays, (x, y, z, w) layout like the
    reference's `v` + `w` fields, fully batched / differentiable;
  * `decompose` splits a 4x4 into translate * rotate * scale by polar
    iteration (Transform.cpp:1089 AnimatedTransform::Decompose);
  * `AnimatedTransform.interpolate(t)` lerps T and S and slerps R
    (Transform.cpp:1130), batched over per-lane times so motion blur is
    one fused elementwise op over the ray wavefront;
  * `motion_bounds` returns a conservative box for animated geometry by
    unioning the transformed bounds over a dense time sweep — a
    vectorized replacement for the reference's closed-form derivative
    bound (Transform.cpp:1201 MotionBounds); with enough samples plus
    padding it is conservative for the rigid T*R*S motions both systems
    support.

All reference scenes use identity motion (ui/RenderThread.cpp:65-67); this
module completes the component inventory and supports motion-blur scenes.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .math import HIGHEST


# ---------------------------------------------------------------------------
# Quaternion: (..., 4) arrays, layout (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_identity():
    return jnp.asarray([0.0, 0.0, 0.0, 1.0], jnp.float32)


def quat_dot(a, b):
    """Dot(q1, q2) (Quaternion.h:90)."""
    return jnp.sum(a * b, axis=-1)


def quat_normalize(q):
    return q / jnp.sqrt(jnp.maximum(quat_dot(q, q), 1e-30))[..., None]


def quat_mul(a, b):
    """Hamilton product (component form of Quaternion operator*)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def slerp(t, q1, q2):
    """Spherical linear interpolation (Quaternion.cpp Slerp): falls back to
    normalized lerp when the quaternions are nearly parallel, exactly like
    the reference's cosTheta > .9995 branch — expressed with where-masks."""
    cos_theta = quat_dot(q1, q2)
    near = cos_theta > 0.9995
    # lerp branch
    q_lerp = quat_normalize(q1 + t[..., None] * (q2 - q1))
    # slerp branch
    theta = jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))
    theta_p = theta * t
    qperp = quat_normalize(q2 - q1 * cos_theta[..., None])
    q_slerp = q1 * jnp.cos(theta_p)[..., None] + qperp * jnp.sin(theta_p)[..., None]
    return jnp.where(near[..., None], q_lerp, q_slerp)


def quat_from_matrix(m):
    """Quaternion from a 3x3/4x4 rotation (Quaternion.cpp Quaternion(Transform&)
    — Shepperd's method with the same trace branches, branchless here)."""
    m = jnp.asarray(m)
    r = m[..., :3, :3]
    t00, t11, t22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    trace = t00 + t11 + t22

    # branch 0: trace > 0
    s0 = jnp.sqrt(jnp.maximum(trace + 1.0, 1e-12))
    w0 = s0 / 2.0
    s0i = 0.5 / s0
    q0 = jnp.stack(
        [
            (r[..., 2, 1] - r[..., 1, 2]) * s0i,
            (r[..., 0, 2] - r[..., 2, 0]) * s0i,
            (r[..., 1, 0] - r[..., 0, 1]) * s0i,
            w0,
        ],
        axis=-1,
    )

    def axis_case(i, j, k):
        s = jnp.sqrt(
            jnp.maximum(r[..., i, i] - (r[..., j, j] + r[..., k, k]) + 1.0, 1e-12)
        )
        qi = s * 0.5
        si = 0.5 / s
        qj = (r[..., j, i] + r[..., i, j]) * si
        qk = (r[..., k, i] + r[..., i, k]) * si
        w = (r[..., k, j] - r[..., j, k]) * si
        out = [None, None, None]
        out[i], out[j], out[k] = qi, qj, qk
        return jnp.stack(out + [w], axis=-1)

    q_x = axis_case(0, 1, 2)
    q_y = axis_case(1, 2, 0)
    q_z = axis_case(2, 0, 1)

    use_x = (t00 > t11) & (t00 > t22)
    use_y = ~use_x & (t11 > t22)
    q_neg = jnp.where(
        use_x[..., None], q_x, jnp.where(use_y[..., None], q_y, q_z)
    )
    return quat_normalize(jnp.where((trace > 0.0)[..., None], q0, q_neg))


def quat_to_matrix(q):
    """Quaternion::ToTransform (Quaternion.cpp) -> (..., 4, 4)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    rows = [
        jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy), zero], -1),
        jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx), zero], -1),
        jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy), zero], -1),
        jnp.stack([zero, zero, zero, one], -1),
    ]
    return jnp.stack(rows, axis=-2)


# ---------------------------------------------------------------------------
# Decompose + AnimatedTransform
# ---------------------------------------------------------------------------

def decompose(m):
    """M = T * R * S (AnimatedTransform::Decompose, Transform.cpp:1089).

    Host-side numpy (decomposition happens once at scene build). Returns
    (t (3,), r quat (4,), s (4,4)). Rotation extracted by the same polar
    iteration M_{i+1} = (M_i + (M_i^-T)) / 2 the reference runs (up to 100
    iterations, 1e-4 norm cutoff).
    """
    m = np.asarray(m, np.float64)
    t = m[:3, 3].copy()
    rot = m.copy()
    rot[:3, 3] = 0.0
    rot[3, :] = [0, 0, 0, 1]
    r = rot.copy()
    for _ in range(100):
        r_next = 0.5 * (r + np.linalg.inv(r.T))
        norm = np.abs(r_next[:3, :3] - r[:3, :3]).sum(axis=1).max()
        r = r_next
        if norm < 1e-4:
            break
    s = np.linalg.inv(r) @ rot
    q = np.asarray(quat_from_matrix(jnp.asarray(r, jnp.float32)))
    return t.astype(np.float32), q.astype(np.float32), s.astype(np.float32)


class AnimatedTransform(NamedTuple):
    """Two-keyframe rigid+scale motion. All fields are device arrays so a
    batch of per-ray times interpolates in one fused op."""
    start_time: jnp.ndarray     # ()
    end_time: jnp.ndarray       # ()
    t0: jnp.ndarray             # (3,) translations
    t1: jnp.ndarray
    r0: jnp.ndarray             # (4,) rotations
    r1: jnp.ndarray
    s0: jnp.ndarray             # (4,4) scale/shear parts
    s1: jnp.ndarray
    actually_animated: jnp.ndarray  # () bool


def make_animated_transform(m_start, m_end, t_start=0.0, t_end=1.0):
    t0, r0, s0 = decompose(m_start)
    t1, r1, s1 = decompose(m_end)
    # pick the shorter rotation arc (Transform.cpp:1124 flip)
    if float(np.sum(r0 * r1)) < 0.0:
        r1 = -r1
    animated = not np.allclose(np.asarray(m_start), np.asarray(m_end))
    return AnimatedTransform(
        start_time=jnp.asarray(t_start, jnp.float32),
        end_time=jnp.asarray(t_end, jnp.float32),
        t0=jnp.asarray(t0), t1=jnp.asarray(t1),
        r0=jnp.asarray(r0), r1=jnp.asarray(r1),
        s0=jnp.asarray(s0), s1=jnp.asarray(s1),
        actually_animated=jnp.asarray(animated),
    )


def interpolate(at: AnimatedTransform, time):
    """AnimatedTransform::Interpolate (Transform.cpp:1130) batched over a
    (...,) time array -> (..., 4, 4) matrices."""
    time = jnp.asarray(time, jnp.float32)
    dt = jnp.where(
        at.end_time > at.start_time,
        (time - at.start_time) / jnp.maximum(at.end_time - at.start_time, 1e-12),
        jnp.zeros_like(time),
    )
    dt = jnp.clip(dt, 0.0, 1.0)
    trans = (1.0 - dt)[..., None] * at.t0 + dt[..., None] * at.t1
    rot = slerp(dt, jnp.broadcast_to(at.r0, dt.shape + (4,)),
                jnp.broadcast_to(at.r1, dt.shape + (4,)))
    scale = (1.0 - dt)[..., None, None] * at.s0 + dt[..., None, None] * at.s1
    m = jnp.matmul(quat_to_matrix(rot), scale, precision=HIGHEST)
    m = m.at[..., :3, 3].add(trans)
    return m


def xform_point(m, p):
    """(..., 4, 4) x (..., 3) -> (..., 3) with perspective divide."""
    ph = jnp.einsum("...ij,...j->...i", m[..., :3, :3], p,
                    precision=HIGHEST) + m[..., :3, 3]
    w = jnp.einsum("...j,...j->...", m[..., 3, :3], p,
                   precision=HIGHEST) + m[..., 3, 3]
    return ph / w[..., None]


def xform_vector(m, v):
    return jnp.einsum("...ij,...j->...i", m[..., :3, :3], v,
                      precision=HIGHEST)


def motion_bounds(at: AnimatedTransform, lo, hi, n_samples=64, pad=1e-3):
    """Conservative bounds of a box swept over [start, end]
    (AnimatedTransform::MotionBounds, Transform.cpp:1201). The reference
    bounds the motion derivative in closed form; here we union the
    transformed corners over a dense time sweep and pad — conservative for
    the smooth T*R*S motions both implementations support, and one fused
    batched op instead of 3x bisection recursions."""
    lo = jnp.asarray(lo, jnp.float32)
    hi = jnp.asarray(hi, jnp.float32)
    corners = jnp.stack(
        [
            jnp.stack(
                [
                    jnp.where(jnp.asarray(bool(i & 1)), hi[0], lo[0]),
                    jnp.where(jnp.asarray(bool(i & 2)), hi[1], lo[1]),
                    jnp.where(jnp.asarray(bool(i & 4)), hi[2], lo[2]),
                ]
            )
            for i in range(8)
        ]
    )  # (8, 3)
    times = jnp.linspace(at.start_time, at.end_time, n_samples)
    mats = interpolate(at, times)  # (S, 4, 4)
    pts = xform_point(mats[:, None], corners[None, :])  # (S, 8, 3)
    diag = jnp.max(hi - lo)
    out_lo = jnp.min(pts, axis=(0, 1)) - pad * diag
    out_hi = jnp.max(pts, axis=(0, 1)) + pad * diag
    return out_lo, out_hi
