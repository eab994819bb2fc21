"""Beckmann VNDF sampling + FresnelBlend lobe tests
(reference core/MicroFacet.cpp:11-113, core/Reflection.cpp:291-344)."""

import numpy as np

import jax.numpy as jnp

from gnxraytracer.models import microfacet as mf
from gnxraytracer.ops.sampling import uniform_sample_hemisphere
from gnxraytracer.utils.math import abs_cos_theta, normalize


def _rand2(n, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(1e-4, 1.0 - 1e-4, (n, 2)), jnp.float32)


class TestBeckmannSample:
    def test_normal_incidence_slope_stats(self):
        """At normal incidence the visible distribution equals the full
        Beckmann distribution: slopes are Gaussian with std alpha/sqrt(2)."""
        n = 20000
        ax = ay = 0.5
        wo = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
        wh = mf.beckmann_sample_wh(wo, _rand2(n, 0), ax, ay)
        wh = np.asarray(wh)
        slopes = -wh[:, :2] / wh[:, 2:3]
        assert abs(slopes[:, 0].std() - ax / np.sqrt(2)) < 0.02
        assert abs(slopes[:, 1].std() - ay / np.sqrt(2)) < 0.02
        assert abs(slopes.mean()) < 0.02

    def test_upper_hemisphere_and_finite(self):
        n = 4096
        rng = np.random.default_rng(4)
        wo = normalize(jnp.asarray(rng.normal(size=(n, 3)), jnp.float32))
        wh = mf.beckmann_sample_wh(wo, _rand2(n, 5), 0.3, 0.6)
        wh = np.asarray(wh)
        assert np.isfinite(wh).all()
        # wh is always on wo's side (flip convention of the reference)
        wo_np = np.asarray(wo)
        assert (np.sign(wh[:, 2]) == np.sign(wo_np[:, 2])).mean() > 0.999

    def test_visible_mass_toward_viewer(self):
        """Grazing wo: visible normals lean toward the viewer (that's the
        point of VNDF sampling)."""
        n = 8192
        wo = jnp.broadcast_to(
            normalize(jnp.asarray([0.95, 0.0, 0.12])), (n, 3)
        )
        wh = np.asarray(mf.beckmann_sample_wh(wo, _rand2(n, 6), 0.4, 0.4))
        assert wh[:, 0].mean() > 0.05  # tilted toward +x viewer

    def test_beckmann_d_integrates_projected_area(self):
        """∫ D(wh) cos(wh) dwh = 1 (normalization of any microfacet D)."""
        n = 200000
        u = _rand2(n, 7)
        wh = uniform_sample_hemisphere(u)
        d = np.asarray(mf.beckmann_d(wh, 0.4, 0.4))
        cos = np.asarray(abs_cos_theta(wh))
        est = (d * cos).mean() * 2 * np.pi  # / uniform-hemisphere pdf
        assert abs(est - 1.0) < 0.05


class TestFresnelBlend:
    RD = jnp.asarray([0.5, 0.4, 0.3])
    RS = jnp.asarray([0.04, 0.04, 0.04])

    def test_energy_conservation(self):
        """∫ f cos dwi <= 1 per channel (white furnace upper bound)."""
        n = 100000
        wo = jnp.broadcast_to(normalize(jnp.asarray([0.3, 0.1, 0.9])), (n, 3))
        wi = uniform_sample_hemisphere(_rand2(n, 8))
        rd = jnp.broadcast_to(self.RD, (n, 3))
        rs = jnp.broadcast_to(self.RS, (n, 3))
        f = np.asarray(mf.fresnel_blend_f(wo, wi, rd, rs, 0.3, 0.3))
        cos = np.asarray(abs_cos_theta(wi))[:, None]
        albedo = (f * cos).mean(0) * 2 * np.pi
        assert (albedo <= 1.02).all()
        assert (albedo > 0.05).all()

    def test_pdf_integrates_to_at_most_one(self):
        """∫ pdf dwi ∈ (0.8, 1]: the deficit is the half-weight GGX lobe
        mass reflected below the horizon, which Pdf zeroes (the reference's
        Sample_f rejects those directions, Reflection.cpp:332)."""
        n = 400000
        wo = jnp.broadcast_to(normalize(jnp.asarray([0.4, 0.0, 0.8])), (n, 3))
        wi = uniform_sample_hemisphere(_rand2(n, 9))
        pdf = np.asarray(mf.fresnel_blend_pdf(wo, wi, 0.4, 0.4))
        est = pdf.mean() * 2 * np.pi
        assert 0.8 < est <= 1.02

    def test_sample_pdf_consistency(self):
        """MC estimate of ∫ f cos via importance sampling equals the
        uniform-sampling estimate."""
        n = 200000
        wo = jnp.broadcast_to(normalize(jnp.asarray([0.2, 0.3, 0.9])), (n, 3))
        rd = jnp.broadcast_to(self.RD, (n, 3))
        rs = jnp.broadcast_to(self.RS, (n, 3))
        rng = np.random.default_rng(11)
        uc = jnp.asarray(rng.uniform(size=(n,)), jnp.float32)
        wi, f, pdf, valid = mf.fresnel_blend_sample(
            wo, _rand2(n, 12), uc, rd, rs, 0.35, 0.35
        )
        f, pdf, valid = np.asarray(f), np.asarray(pdf), np.asarray(valid)
        cos = np.asarray(abs_cos_theta(wi))
        w = np.where(valid[:, None] & (pdf[:, None] > 0),
                     f * cos[:, None] / np.maximum(pdf[:, None], 1e-9), 0.0)
        est_is = w.mean(0)

        wi_u = uniform_sample_hemisphere(_rand2(n, 13))
        f_u = np.asarray(mf.fresnel_blend_f(wo, wi_u, rd, rs, 0.35, 0.35))
        cos_u = np.asarray(abs_cos_theta(wi_u))[:, None]
        est_uni = (f_u * cos_u).mean(0) * 2 * np.pi
        np.testing.assert_allclose(est_is, est_uni, rtol=0.08)

    def test_reciprocity(self):
        n = 512
        rng = np.random.default_rng(14)
        wo = normalize(jnp.asarray(np.abs(rng.normal(size=(n, 3))), jnp.float32))
        wi = normalize(jnp.asarray(np.abs(rng.normal(size=(n, 3))), jnp.float32))
        rd = jnp.broadcast_to(self.RD, (n, 3))
        rs = jnp.broadcast_to(self.RS, (n, 3))
        f_ab = np.asarray(mf.fresnel_blend_f(wo, wi, rd, rs, 0.3, 0.3))
        f_ba = np.asarray(mf.fresnel_blend_f(wi, wo, rd, rs, 0.3, 0.3))
        np.testing.assert_allclose(f_ab, f_ba, rtol=1e-3, atol=1e-6)
