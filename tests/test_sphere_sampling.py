"""Sphere area/cone sampling tests (complete-sphere semantics the reference
stub omits, shape/Sphere.h:28-56; pbrt Shape::Sample contract
core/Shape.h:22-38)."""

import numpy as np

import jax.numpy as jnp

from gnxraytracer.models import sphere_sampling as sph


def _u2(n, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(1e-6, 1 - 1e-6, (n, 2)), jnp.float32)


CENTER = jnp.asarray([1.0, 2.0, 3.0])
RADIUS = jnp.asarray(0.5)


class TestUniformSample:
    def test_on_surface_uniform(self):
        n = 50000
        c = jnp.broadcast_to(CENTER, (n, 3))
        r = jnp.broadcast_to(RADIUS, (n,))
        s = sph.sample_uniform(c, r, _u2(n, 0))
        p = np.asarray(s.p)
        d = np.linalg.norm(p - np.asarray(CENTER), axis=-1)
        np.testing.assert_allclose(d, 0.5, atol=1e-5)
        # uniform: mean position = center, each octant ~ 1/8
        np.testing.assert_allclose(p.mean(0), np.asarray(CENTER), atol=0.01)
        octant = ((p - np.asarray(CENTER)) > 0).astype(int)
        counts = np.bincount(octant @ np.asarray([1, 2, 4]), minlength=8) / n
        np.testing.assert_allclose(counts, 1 / 8, atol=0.01)
        np.testing.assert_allclose(
            np.asarray(s.pdf), 1.0 / (4 * np.pi * 0.25), rtol=1e-6
        )

    def test_normal_outward(self):
        n = 128
        c = jnp.broadcast_to(CENTER, (n, 3))
        r = jnp.broadcast_to(RADIUS, (n,))
        s = sph.sample_uniform(c, r, _u2(n, 1))
        dot_out = np.sum(
            np.asarray(s.n) * (np.asarray(s.p) - np.asarray(CENTER)), -1
        )
        assert (dot_out > 0).all()


class TestConeSample:
    def test_points_visible_hemisphere(self):
        """Cone-sampled points lie on the cap visible from the ref point."""
        n = 20000
        ref = jnp.broadcast_to(jnp.asarray([1.0, 2.0, 6.0]), (n, 3))
        c = jnp.broadcast_to(CENTER, (n, 3))
        r = jnp.broadcast_to(RADIUS, (n,))
        s = sph.sample_from_ref(c, r, ref, _u2(n, 2))
        p = np.asarray(s.p)
        d = np.linalg.norm(p - np.asarray(CENTER), axis=-1)
        np.testing.assert_allclose(d, 0.5, atol=1e-4)
        # visible: normal faces the ref point
        to_ref = np.asarray(ref) - p
        cosv = np.sum(np.asarray(s.n) * to_ref, -1)
        assert (cosv > -1e-4).mean() > 0.999

    def test_pdf_constant_inside_cone_zero_outside(self):
        """Outside the sphere the pdf is the uniform-cone constant
        1/(2π(1−cosθmax)) inside the subtended cone and 0 outside it."""
        n = 200000
        ref_pt = np.asarray([1.0, 2.0, 6.0])
        ref = jnp.broadcast_to(jnp.asarray(ref_pt), (n, 3))
        c = jnp.broadcast_to(CENTER, (n, 3))
        r = jnp.broadcast_to(RADIUS, (n,))
        from gnxraytracer.ops.sampling import uniform_sample_sphere

        wi = uniform_sample_sphere(_u2(n, 3))
        pdf = np.asarray(sph.pdf_from_ref(c, r, ref, wi))
        dc = np.linalg.norm(ref_pt - np.asarray(CENTER))
        cos_max = np.sqrt(1.0 - (0.5 / dc) ** 2)
        want = 1.0 / (2 * np.pi * (1.0 - cos_max))
        wc = (np.asarray(CENTER) - ref_pt) / dc
        in_cone = np.asarray(wi) @ wc >= cos_max
        np.testing.assert_allclose(pdf[in_cone], want, rtol=1e-4)
        np.testing.assert_allclose(pdf[~in_cone], 0.0, atol=1e-7)
        # and the analytic integral: constant * cone solid angle == 1
        np.testing.assert_allclose(want * 2 * np.pi * (1 - cos_max), 1.0,
                                   rtol=1e-6)

    def test_sample_pdf_consistent(self):
        """pdf_from_ref at sampled directions equals the sample's pdf."""
        n = 4096
        ref = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.0]), (n, 3))
        c = jnp.broadcast_to(CENTER, (n, 3))
        r = jnp.broadcast_to(RADIUS, (n,))
        s = sph.sample_from_ref(c, r, ref, _u2(n, 4))
        wi = s.p - ref
        wi = wi / jnp.linalg.norm(wi, axis=-1, keepdims=True)
        pdf2 = np.asarray(sph.pdf_from_ref(c, r, ref, wi))
        np.testing.assert_allclose(pdf2, np.asarray(s.pdf), rtol=5e-3)

    def test_inside_falls_back_to_area(self):
        n = 50000
        ref = jnp.broadcast_to(CENTER + jnp.asarray([0.1, 0.0, 0.0]), (n, 3))
        c = jnp.broadcast_to(CENTER, (n, 3))
        r = jnp.broadcast_to(RADIUS, (n,))
        s = sph.sample_from_ref(c, r, ref, _u2(n, 5))
        p = np.asarray(s.p)
        d = np.linalg.norm(p - np.asarray(CENTER), axis=-1)
        np.testing.assert_allclose(d, 0.5, atol=1e-4)
        assert np.isfinite(np.asarray(s.pdf)).all()
        assert (np.asarray(s.pdf) > 0).all()
        # inside-pdf integrates to 1 over the full sphere of directions
        from gnxraytracer.ops.sampling import uniform_sample_sphere

        wi = uniform_sample_sphere(_u2(n, 6))
        pdf = np.asarray(sph.pdf_from_ref(c, r, ref, wi))
        est = pdf.mean() * 4 * np.pi
        assert abs(est - 1.0) < 0.05, est
