"""Unit tests for warps, MIS heuristics and CDF distributions against
float64 numpy oracles (the reference ships no tests — SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gnxraytracer.ops import sampling
from gnxraytracer.utils import math as vmath


def rand2(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.rand(n, 2).astype(np.float32)


class TestWarps:
    def test_concentric_disk_in_unit_disk(self):
        u = rand2(4096)
        p = np.asarray(sampling.concentric_sample_disk(u))
        r = np.hypot(p[:, 0], p[:, 1])
        assert np.all(r <= 1.0 + 1e-6)

    def test_concentric_disk_oracle(self):
        # float64 oracle of the Shirley-Chiu warp
        u = rand2(512)
        uo = 2.0 * u.astype(np.float64) - 1.0
        expect = np.zeros_like(uo)
        for i, (x, y) in enumerate(uo):
            if x == 0 and y == 0:
                continue
            if abs(x) > abs(y):
                r, theta = x, (np.pi / 4) * (y / x)
            else:
                r, theta = y, np.pi / 2 - (np.pi / 4) * (x / y)
            expect[i] = [r * np.cos(theta), r * np.sin(theta)]
        got = np.asarray(sampling.concentric_sample_disk(u))
        np.testing.assert_allclose(got, expect, atol=1e-5)

    def test_cosine_hemisphere_distribution(self):
        u = rand2(200000, seed=1)
        w = np.asarray(sampling.cosine_sample_hemisphere(u))
        assert np.all(w[:, 2] >= 0)
        # E[cos theta] under pdf cos/pi is 2/3
        assert abs(w[:, 2].mean() - 2.0 / 3.0) < 5e-3

    def test_uniform_sphere_mean_zero(self):
        u = rand2(200000, seed=2)
        w = np.asarray(sampling.uniform_sample_sphere(u))
        np.testing.assert_allclose(np.linalg.norm(w, axis=1), 1.0, atol=1e-5)
        assert np.all(np.abs(w.mean(axis=0)) < 5e-3)

    def test_uniform_triangle_barycentric(self):
        u = rand2(10000, seed=3)
        b = np.asarray(sampling.uniform_sample_triangle(u))
        assert np.all(b >= 0) and np.all(b.sum(axis=1) <= 1 + 1e-6)


class TestMIS:
    def test_power_heuristic_values(self):
        w = sampling.power_heuristic(1.0, jnp.float32(2.0), 1.0, jnp.float32(1.0))
        np.testing.assert_allclose(float(w), 4.0 / 5.0, rtol=1e-6)

    def test_power_heuristic_zero(self):
        w = sampling.power_heuristic(1.0, jnp.float32(0.0), 1.0, jnp.float32(0.0))
        assert float(w) == 0.0


class TestDistribution1D:
    def test_discrete_matches_pmf(self):
        f = jnp.asarray([1.0, 3.0, 0.0, 4.0])
        d = sampling.make_distribution1d(f)
        u = jnp.asarray(np.linspace(0, 0.999, 100000, dtype=np.float32))
        idx, pmf, _ = sampling.sample_discrete_1d(d, u)
        idx = np.asarray(idx)
        counts = np.bincount(idx, minlength=4) / len(idx)
        np.testing.assert_allclose(counts, [1 / 8, 3 / 8, 0, 4 / 8], atol=2e-3)
        # pmf values
        np.testing.assert_allclose(
            np.asarray(pmf)[idx == 0], 1 / 8, rtol=1e-5
        )

    def test_continuous_pdf_integrates(self):
        f = jnp.asarray([2.0, 0.5, 1.5, 1.0, 0.0, 3.0])
        d = sampling.make_distribution1d(f)
        u = jnp.asarray(np.random.RandomState(0).rand(100000).astype(np.float32))
        x, pdf, _ = sampling.sample_continuous_1d(d, u)
        # MC estimate of integral of (f/func_int) via importance sampling = 1
        est = np.mean(1.0)  # pdf cancels by construction; check histogram instead
        hist, _ = np.histogram(np.asarray(x), bins=6, range=(0, 1), density=True)
        np.testing.assert_allclose(hist, np.asarray(f) / np.mean(np.asarray(f)), atol=5e-2)

    def test_zero_function_uniform(self):
        d = sampling.make_distribution1d(jnp.zeros(4))
        x, pdf, _ = sampling.sample_continuous_1d(d, jnp.asarray([0.1, 0.6]))
        np.testing.assert_allclose(np.asarray(x), [0.1, 0.6], atol=1e-6)


class TestDistribution2D:
    def test_sampling_histogram(self):
        func = np.zeros((4, 8), np.float32)
        func[1, 2] = 4.0
        func[3, 5] = 12.0
        d = sampling.make_distribution2d(jnp.asarray(func))
        u = jnp.asarray(np.random.RandomState(0).rand(100000, 2).astype(np.float32))
        p, pdf = sampling.sample_continuous_2d(d, u)
        p = np.asarray(p)
        iu = np.clip((p[:, 0] * 8).astype(int), 0, 7)
        iv = np.clip((p[:, 1] * 4).astype(int), 0, 3)
        frac_hot = np.mean((iu == 5) & (iv == 3))
        np.testing.assert_allclose(frac_hot, 12.0 / 16.0, atol=5e-3)
        # pdf at sampled point matches func/integral * (W*H)
        integral = func.mean()
        np.testing.assert_allclose(
            np.asarray(pdf)[(iu == 5) & (iv == 3)], 12.0 / integral, rtol=1e-4
        )

    def test_pdf_2d_lookup(self):
        func = np.abs(np.random.RandomState(1).rand(8, 16)).astype(np.float32)
        d = sampling.make_distribution2d(jnp.asarray(func))
        p = jnp.asarray([[0.5, 0.5]])
        pdf = sampling.pdf_2d(d, p)
        np.testing.assert_allclose(float(pdf[0]), func[4, 8] / func.mean(), rtol=1e-5)


class TestVecMath:
    def test_coordinate_system_orthonormal(self):
        rs = np.random.RandomState(0)
        v = rs.randn(1000, 3).astype(np.float32)
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        v1 = jnp.asarray(v)
        v2, v3 = vmath.coordinate_system(v1)
        np.testing.assert_allclose(np.asarray(vmath.dot(v1, v2)), 0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(vmath.dot(v1, v3)), 0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(vmath.length(v2)), 1, atol=1e-5)
        np.testing.assert_allclose(np.asarray(vmath.length(v3)), 1, atol=1e-5)

    def test_reflect(self):
        wo = jnp.asarray([[0.0, 0.0, 1.0]])
        n = jnp.asarray([[0.0, 0.0, 1.0]])
        r = vmath.reflect(wo, n)
        np.testing.assert_allclose(np.asarray(r), [[0, 0, 1]], atol=1e-6)

    def test_refract_tir(self):
        # Glancing ray from dense medium: total internal reflection
        wi = vmath.normalize(jnp.asarray([[0.9, 0.0, 0.1]]))
        n = jnp.asarray([[0.0, 0.0, 1.0]])
        ok, _ = vmath.refract(wi, n, jnp.asarray([1.5]))
        assert not bool(ok[0])
