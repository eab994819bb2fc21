"""Catmull-Rom / Fourier interpolation tests
(reference core/Interpolation.cpp:21-393)."""

import numpy as np

import jax.numpy as jnp

from gnxraytracer.ops import interpolation as interp


def _nodes_values():
    x = jnp.asarray([0.0, 0.5, 1.2, 2.0, 3.5, 5.0], jnp.float32)
    f = jnp.asarray([1.0, 2.0, 1.5, 3.0, 0.5, 1.0], jnp.float32)
    return x, f


class TestCatmullRomEval:
    def test_exact_at_nodes(self):
        x, f = _nodes_values()
        got = np.asarray(interp.catmull_rom_eval(x, f, x))
        np.testing.assert_allclose(got, np.asarray(f), atol=1e-5)

    def test_zero_outside_range(self):
        x, f = _nodes_values()
        got = np.asarray(
            interp.catmull_rom_eval(x, f, jnp.asarray([-1.0, 6.0]))
        )
        np.testing.assert_allclose(got, 0.0)

    def test_smooth_between_nodes(self):
        x, f = _nodes_values()
        q = jnp.linspace(0.0, 5.0, 101)
        v = np.asarray(interp.catmull_rom_eval(x, f, q))
        assert np.isfinite(v).all()
        assert (np.abs(np.diff(v)) < 1.0).all()  # no jumps


class TestIntegrateSample:
    def test_integral_matches_quadrature(self):
        x, f = _nodes_values()
        cdf, total = interp.integrate_catmull_rom(x, f)
        q = jnp.linspace(0.0, 5.0, 20001)
        v = np.asarray(interp.catmull_rom_eval(x, f, q))
        quad = np.trapezoid(v, np.asarray(q))
        np.testing.assert_allclose(float(total), quad, rtol=1e-3)
        # cdf at interior nodes matches partial quadrature
        for i in [1, 3]:
            xi = float(x[i])
            m = np.asarray(q) <= xi
            np.testing.assert_allclose(
                float(cdf[i]), np.trapezoid(v[m], np.asarray(q)[m]), rtol=5e-3,
                atol=1e-3,
            )

    def test_sample_distribution(self):
        x, f = _nodes_values()
        cdf, total = interp.integrate_catmull_rom(x, f)
        n = 200000
        u = jnp.asarray(np.random.default_rng(0).uniform(size=n), jnp.float32)
        xs, fval, pdf = interp.sample_catmull_rom(x, f, cdf, u)
        xs = np.asarray(xs)
        assert (xs >= 0).all() and (xs <= 5.0).all()
        # histogram ratio test: empirical density / pdf ~ 1
        hist, edges = np.histogram(xs, bins=25, range=(0, 5), density=True)
        centers = 0.5 * (edges[:-1] + edges[1:])
        want = np.asarray(
            interp.catmull_rom_eval(x, f, jnp.asarray(centers, jnp.float32))
        ) / float(total)
        np.testing.assert_allclose(hist, want, rtol=0.12, atol=0.01)
        # returned pdf equals f(x)/total
        want_pdf = np.asarray(
            interp.catmull_rom_eval(x, f, jnp.asarray(xs[:100], jnp.float32))
        ) / float(total)
        np.testing.assert_allclose(np.asarray(pdf)[:100], want_pdf, rtol=2e-2,
                                   atol=1e-3)

    def test_sample_2d_matches_1d_at_node_row(self):
        x, f = _nodes_values()
        rho = jnp.asarray([0.0, 0.5, 1.0], jnp.float32)
        values = jnp.stack([f * 0.5, f, f * 2.0])  # (3, K)
        cdfs = []
        for i in range(3):
            c, _ = interp.integrate_catmull_rom(x, values[i])
            cdfs.append(c)
        cdf2 = jnp.stack(cdfs)
        u = jnp.asarray(np.random.default_rng(1).uniform(size=512), jnp.float32)
        alpha = jnp.full((512,), 0.5)
        xs2, fv2, pdf2 = interp.sample_catmull_rom_2d(rho, x, values, cdf2,
                                                      alpha, u)
        xs1, fv1, pdf1 = interp.sample_catmull_rom(x, f, cdfs[1], u)
        np.testing.assert_allclose(np.asarray(xs2), np.asarray(xs1), atol=1e-3)
        np.testing.assert_allclose(np.asarray(pdf2), np.asarray(pdf1),
                                   rtol=1e-2, atol=1e-4)

    def test_invert_roundtrip(self):
        x = jnp.asarray([0.0, 1.0, 2.0, 3.0, 4.0], jnp.float32)
        vals = jnp.asarray([0.0, 0.3, 1.0, 2.5, 4.0], jnp.float32)  # monotone
        q = jnp.linspace(0.05, 3.95, 41)
        y = interp.catmull_rom_eval(x, vals, q)
        x_back = np.asarray(interp.invert_catmull_rom(x, vals, y))
        np.testing.assert_allclose(x_back, np.asarray(q), atol=2e-3)

    def test_invert_clamps_out_of_range(self):
        x = jnp.asarray([0.0, 1.0, 2.0], jnp.float32)
        vals = jnp.asarray([0.0, 1.0, 2.0], jnp.float32)
        got = np.asarray(
            interp.invert_catmull_rom(x, vals, jnp.asarray([-1.0, 5.0]))
        )
        np.testing.assert_allclose(got, [0.0, 2.0])


class TestFourier:
    def test_eval_matches_direct_sum(self):
        rng = np.random.default_rng(2)
        a = jnp.asarray(rng.uniform(-0.2, 1.0, (8,)), jnp.float32)
        phi = rng.uniform(0, 2 * np.pi, 64)
        got = np.asarray(interp.fourier_eval(a, jnp.asarray(np.cos(phi),
                                                            jnp.float32)))
        want = sum(float(a[k]) * np.cos(k * phi) for k in range(8))
        np.testing.assert_allclose(got, want, atol=1e-4)

    def test_sample_fourier_histogram(self):
        # non-negative density: a0 + a1 cos(phi), a0 > a1
        a = jnp.asarray([1.0, 0.6, 0.0, 0.1], jnp.float32)
        n = 200000
        u = jnp.asarray(np.random.default_rng(3).uniform(size=n), jnp.float32)
        phi, pdf_val, pdf = interp.sample_fourier(
            jnp.broadcast_to(a, (n, 4)), u
        )
        phi = np.asarray(phi)
        assert (phi >= 0).all() and (phi <= 2 * np.pi + 1e-5).all()
        hist, edges = np.histogram(phi, bins=24, range=(0, 2 * np.pi),
                                   density=True)
        centers = 0.5 * (edges[:-1] + edges[1:])
        dens = sum(float(a[k]) * np.cos(k * centers) for k in range(4))
        dens = dens / (2 * np.pi * float(a[0]))  # normalize
        np.testing.assert_allclose(hist, dens, rtol=0.1, atol=0.01)
