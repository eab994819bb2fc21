"""Quaternion / AnimatedTransform tests (reference core/Quaternion.{h,cpp},
core/Transform.cpp:1089-1260)."""

import numpy as np
import pytest

from gnxraytracer.utils import transform as tf

import jax.numpy as jnp


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    m = np.eye(4)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = [x, y, z]
    return m


class TestQuaternion:
    def test_roundtrip_matrix(self):
        for a in [0.1, 1.0, 2.5, 3.0]:
            m = rot_x(a) @ rot_z(a * 0.7)
            q = tf.quat_from_matrix(jnp.asarray(m, jnp.float32))
            m2 = np.asarray(tf.quat_to_matrix(q))
            np.testing.assert_allclose(m2, m, atol=1e-5)

    def test_trace_negative_branch(self):
        # 180-degree rotations exercise the non-trace branches
        for m in [np.diag([1.0, -1, -1, 1]), np.diag([-1.0, 1, -1, 1]),
                  np.diag([-1.0, -1, 1, 1])]:
            q = tf.quat_from_matrix(jnp.asarray(m, jnp.float32))
            np.testing.assert_allclose(
                np.asarray(tf.quat_to_matrix(q)), m, atol=1e-5
            )

    def test_mul_composes_rotations(self):
        ma, mb = rot_x(0.4), rot_z(1.1)
        qa = tf.quat_from_matrix(jnp.asarray(ma, jnp.float32))
        qb = tf.quat_from_matrix(jnp.asarray(mb, jnp.float32))
        np.testing.assert_allclose(
            np.asarray(tf.quat_to_matrix(tf.quat_mul(qa, qb))), ma @ mb, atol=1e-5
        )

    def test_slerp_endpoints_and_midpoint(self):
        qa = tf.quat_from_matrix(jnp.asarray(np.eye(4), jnp.float32))
        qb = tf.quat_from_matrix(jnp.asarray(rot_x(1.0), jnp.float32))
        t = jnp.asarray([0.0, 0.5, 1.0])
        out = tf.slerp(t, jnp.broadcast_to(qa, (3, 4)), jnp.broadcast_to(qb, (3, 4)))
        np.testing.assert_allclose(np.asarray(out[0]), np.asarray(qa), atol=1e-5)
        np.testing.assert_allclose(np.asarray(out[2]), np.asarray(qb), atol=1e-5)
        # midpoint of a 1-rad rotation about x is the 0.5-rad rotation
        mid = tf.quat_from_matrix(jnp.asarray(rot_x(0.5), jnp.float32))
        np.testing.assert_allclose(np.asarray(out[1]), np.asarray(mid), atol=1e-4)

    def test_slerp_near_parallel_uses_lerp(self):
        qa = tf.quat_from_matrix(jnp.asarray(np.eye(4), jnp.float32))
        qb = tf.quat_from_matrix(jnp.asarray(rot_x(1e-4), jnp.float32))
        out = tf.slerp(jnp.asarray([0.5]), qa[None], qb[None])
        assert np.isfinite(np.asarray(out)).all()
        np.testing.assert_allclose(
            float(tf.quat_dot(out[0], out[0])), 1.0, atol=1e-5
        )


class TestAnimatedTransform:
    def test_decompose_trs(self):
        m = translate(1, 2, 3) @ rot_z(0.7) @ np.diag([2.0, 2.0, 2.0, 1.0])
        t, r, s = tf.decompose(m)
        np.testing.assert_allclose(t, [1, 2, 3], atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(tf.quat_to_matrix(jnp.asarray(r)))[:3, :3],
            rot_z(0.7)[:3, :3], atol=1e-4,
        )
        np.testing.assert_allclose(s[:3, :3], np.diag([2.0, 2, 2]), atol=1e-4)

    def test_interpolate_endpoints(self):
        m0 = translate(0, 0, 0)
        m1 = translate(4, 0, 0) @ rot_x(1.2)
        at = tf.make_animated_transform(m0, m1)
        got0 = np.asarray(tf.interpolate(at, 0.0))
        got1 = np.asarray(tf.interpolate(at, 1.0))
        np.testing.assert_allclose(got0, m0, atol=1e-5)
        np.testing.assert_allclose(got1, m1, atol=1e-4)

    def test_interpolate_batched_times(self):
        at = tf.make_animated_transform(translate(0, 0, 0), translate(2, 0, 0))
        times = jnp.asarray([0.0, 0.25, 0.5, 1.0])
        mats = np.asarray(tf.interpolate(at, times))
        np.testing.assert_allclose(mats[:, 0, 3], [0, 0.5, 1.0, 2.0], atol=1e-5)

    def test_identity_not_animated(self):
        at = tf.make_animated_transform(np.eye(4), np.eye(4))
        assert not bool(at.actually_animated)

    def test_motion_bounds_contains_endpoints(self):
        m0 = np.eye(4)
        m1 = translate(3, 0, 0) @ rot_z(np.pi / 2)
        at = tf.make_animated_transform(m0, m1)
        lo, hi = tf.motion_bounds(at, [-1, -1, -1], [1, 1, 1])
        lo, hi = np.asarray(lo), np.asarray(hi)
        # start box [-1,1]^3 and end box (rotated, translated) both inside
        assert (lo <= -1 + 1e-4).all()
        assert hi[0] >= 4 - 1e-3
        # and the sweep stays finite / sane
        assert (hi - lo < 10).all()

    def test_point_vector_xform(self):
        m = jnp.asarray(translate(1, 0, 0) @ rot_z(np.pi / 2), jnp.float32)
        p = tf.xform_point(m, jnp.asarray([1.0, 0.0, 0.0]))
        v = tf.xform_vector(m, jnp.asarray([1.0, 0.0, 0.0]))
        np.testing.assert_allclose(np.asarray(p), [1, 1, 0], atol=1e-6)
        np.testing.assert_allclose(np.asarray(v), [0, 1, 0], atol=1e-6)
