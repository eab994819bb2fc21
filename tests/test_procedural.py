"""Perlin noise / FBm / Turbulence / mapping tests vs. a scalar float64
oracle implementing the reference semantics (core/Texture.cpp:57-150)."""

import numpy as np

import jax.numpy as jnp

from gnxraytracer.ops import procedural as proc

_PERM = np.asarray(proc._NOISE_PERM)


def _grad_scalar(x, y, z, dx, dy, dz):
    h = _PERM[_PERM[_PERM[x] + y] + z] & 15
    u = dx if (h < 8 or h == 12 or h == 13) else dy
    v = dy if (h < 4 or h == 12 or h == 13) else dz
    return (-u if (h & 1) else u) + (-v if (h & 2) else v)


def _noise_scalar(x, y, z):
    ix, iy, iz = int(np.floor(x)), int(np.floor(y)), int(np.floor(z))
    dx, dy, dz = x - ix, y - iy, z - iz
    ix &= 255
    iy &= 255
    iz &= 255
    w = {}
    for (a, b, c) in [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
                      (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]:
        w[(a, b, c)] = _grad_scalar(ix + a, iy + b, iz + c,
                                    dx - a, dy - b, dz - c)

    def fade(t):
        return 6 * t ** 5 - 15 * t ** 4 + 10 * t ** 3

    wx, wy, wz = fade(dx), fade(dy), fade(dz)

    def lerp(t, a, b):
        return a + t * (b - a)

    x00 = lerp(wx, w[(0, 0, 0)], w[(1, 0, 0)])
    x10 = lerp(wx, w[(0, 1, 0)], w[(1, 1, 0)])
    x01 = lerp(wx, w[(0, 0, 1)], w[(1, 0, 1)])
    x11 = lerp(wx, w[(0, 1, 1)], w[(1, 1, 1)])
    return lerp(wz, lerp(wy, x00, x10), lerp(wy, x01, x11))


class TestNoise:
    def test_matches_scalar_oracle(self):
        rng = np.random.default_rng(7)
        pts = rng.uniform(-20, 20, (64, 3))
        got = np.asarray(proc.noise(jnp.asarray(pts, jnp.float32)))
        want = np.array([_noise_scalar(*p) for p in pts])
        np.testing.assert_allclose(got, want, atol=2e-4)

    def test_zero_at_lattice(self):
        pts = np.asarray([[0, 0, 0], [1, 2, 3], [-4, 5, -6]], np.float32)
        got = np.asarray(proc.noise(jnp.asarray(pts)))
        np.testing.assert_allclose(got, 0.0, atol=1e-6)

    def test_range_bounded(self):
        rng = np.random.default_rng(1)
        pts = rng.uniform(-50, 50, (4096, 3)).astype(np.float32)
        got = np.asarray(proc.noise(jnp.asarray(pts)))
        assert np.abs(got).max() <= 1.5  # classic Perlin stays within ~±1

    def test_differentiable(self):
        import jax

        g = jax.grad(lambda p: proc.noise(p).sum())(
            jnp.asarray([[0.3, 0.4, 0.5]], jnp.float32)
        )
        assert np.isfinite(np.asarray(g)).all()


class TestFBmTurbulence:
    def test_fbm_finite_and_multiscale(self):
        pts = jnp.asarray(np.random.default_rng(2).uniform(-5, 5, (128, 3)),
                          jnp.float32)
        out = np.asarray(proc.fbm(pts, omega=0.5, max_octaves=6))
        assert np.isfinite(out).all()
        assert out.std() > 0.05  # non-degenerate field

    def test_fbm_octave_clamp_by_footprint(self):
        # huge footprint -> 0 octaves -> only the partial-fade term (~0)
        p = jnp.asarray([[1.3, 2.2, 0.7]], jnp.float32)
        wide = proc.fbm(p, dpdx=jnp.asarray([[10.0, 0, 0]]),
                        dpdy=jnp.asarray([[0.0, 10, 0]]))
        assert abs(float(wide[0])) < 1e-6

    def test_turbulence_positive_mean(self):
        pts = jnp.asarray(np.random.default_rng(3).uniform(-5, 5, (512, 3)),
                          jnp.float32)
        out = np.asarray(proc.turbulence(pts, max_octaves=6))
        assert np.isfinite(out).all()
        assert out.mean() > 0.1  # |noise| accumulates positive


class TestMappings:
    def test_uv_mapping_scale_offset(self):
        uv = jnp.asarray([[0.5, 0.25]])
        st = np.asarray(proc.uv_mapping(uv, su=2.0, sv=4.0, du=1.0, dv=-1.0))
        np.testing.assert_allclose(st, [[2.0, 0.0]], atol=1e-6)

    def test_spherical_mapping_poles_equator(self):
        p = jnp.asarray([[0, 0, 1.0], [0, 0, -1.0], [1.0, 0, 0]])
        st = np.asarray(proc.spherical_mapping(p))
        np.testing.assert_allclose(st[:, 0], [0.0, 1.0, 0.5], atol=1e-6)
        np.testing.assert_allclose(st[2, 1], 0.0, atol=1e-6)

    def test_cylindrical_mapping(self):
        p = jnp.asarray([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
        st = np.asarray(proc.cylindrical_mapping(p))
        np.testing.assert_allclose(st[0], [0.0, 0.0], atol=1e-6)
        np.testing.assert_allclose(st[1, 0], 0.25, atol=1e-6)

    def test_planar_mapping(self):
        p = jnp.asarray([[3.0, 5.0, 9.0]])
        st = np.asarray(proc.planar_mapping(p, ds=1.0, dt=2.0))
        np.testing.assert_allclose(st, [[4.0, 7.0]], atol=1e-6)

    def test_transform_mapping_identity(self):
        p = jnp.asarray([[1.0, 2.0, 3.0]])
        np.testing.assert_allclose(
            np.asarray(proc.transform_mapping_3d(p)), [[1, 2, 3]], atol=1e-6
        )

    def test_marble_windy_finite(self):
        pts = jnp.asarray(np.random.default_rng(5).uniform(-2, 2, (32, 3)),
                          jnp.float32)
        m = np.asarray(proc.marble_texture(pts))
        w = np.asarray(proc.windy_texture(pts))
        assert np.isfinite(m).all() and (m >= 0).all()
        assert np.isfinite(w).all()
