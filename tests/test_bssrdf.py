"""BSSRDF tests (reference core/SubReflection.{h,cpp},
materials/DisneyMaterial.cpp:346-460)."""

import numpy as np
import pytest

import jax.numpy as jnp

from gnxraytracer.models import bssrdf
from gnxraytracer.ops.sampling import uniform_sample_hemisphere


class TestFresnelMoments:
    def test_sw_integrates_to_one(self):
        """c = 1 - 2 FresnelMoment1(1/eta) is exactly the normalization
        making the hemispherical cosine integral of Sw equal 1."""
        n = 400000
        rng = np.random.default_rng(0)
        u = jnp.asarray(rng.uniform(1e-5, 1 - 1e-5, (n, 2)), jnp.float32)
        w = uniform_sample_hemisphere(u)
        for eta in [1.33, 1.5, 2.0]:
            swv = np.asarray(bssrdf.sw(w, eta))
            cosw = np.asarray(w[:, 2])
            est = (swv * cosw).mean() * 2 * np.pi
            assert abs(est - 1.0) < 0.02, (eta, est)

    def test_moments_continuous_at_one(self):
        lo = float(bssrdf.fresnel_moment1(jnp.asarray(0.999)))
        hi = float(bssrdf.fresnel_moment1(jnp.asarray(1.001)))
        assert abs(lo - hi) < 5e-2
        assert 0.0 <= float(bssrdf.fresnel_moment1(jnp.asarray(1 / 1.33))) <= 1.0


class TestDisneyProfile:
    def test_sr_normalized(self):
        """∫0^inf Sr(r) 2πr dr = R (Burley profile is normalized)."""
        d = jnp.asarray([[0.4, 0.4, 0.4]])
        big_r = jnp.asarray([[0.8, 0.5, 0.3]])
        r = np.linspace(1e-5, 20.0, 400000)
        sr = np.asarray(
            bssrdf.disney_sr(jnp.asarray(r, jnp.float32),
                             jnp.broadcast_to(big_r, (len(r), 3)),
                             jnp.broadcast_to(d, (len(r), 3)))
        )
        integral = np.trapezoid(sr * (2 * np.pi * r)[:, None], r, axis=0)
        np.testing.assert_allclose(integral, np.asarray(big_r)[0], rtol=5e-3)

    def test_sample_pdf_consistency(self):
        """IS estimate of ∫ g(r) p(r) 2πr dr via sample/pdf matches
        quadrature for a smooth g."""
        d_ch = 0.5
        n = 400000
        u = jnp.asarray(np.random.default_rng(1).uniform(size=n), jnp.float32)
        r = np.asarray(bssrdf.disney_sample_sr(u, d_ch))
        pdf = np.asarray(bssrdf.disney_pdf_sr(jnp.asarray(r), d_ch))
        g = np.exp(-r)  # arbitrary smooth test function
        # E[g / (2πr p)] with r ~ 2πr p(r) dr... the sampler draws radii with
        # area density pdf (per unit area): P(r) dr = pdf(r) 2πr dr
        est = (g / np.maximum(pdf * 2 * np.pi * r, 1e-12) * pdf * 2 * np.pi * r).mean()
        # trivially 1*mean(g) — instead check the density via histogram
        hist, edges = np.histogram(r, bins=40, range=(1e-4, 4.0), density=True)
        centers = 0.5 * (edges[:-1] + edges[1:])
        want = np.asarray(
            bssrdf.disney_pdf_sr(jnp.asarray(centers, jnp.float32), d_ch)
        ) * 2 * np.pi * centers
        want = want / np.trapezoid(
            np.asarray(bssrdf.disney_pdf_sr(
                jnp.asarray(np.linspace(1e-4, 4, 2000), jnp.float32), d_ch
            )) * 2 * np.pi * np.linspace(1e-4, 4, 2000),
            np.linspace(1e-4, 4, 2000),
        )
        inside = r <= 4.0
        scale = inside.mean()
        np.testing.assert_allclose(hist * scale, want, rtol=0.1, atol=0.02)

    def test_disney_s_finite_and_fades(self):
        n = 8
        po_p = jnp.zeros((n, 3))
        po_ns = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
        pi_p = jnp.asarray(np.random.default_rng(2).normal(size=(n, 3)),
                           jnp.float32)
        pi_ns = po_ns
        sp = jnp.ones((n, 3))
        s = np.asarray(
            bssrdf.disney_s(po_p, po_ns, jnp.full((n,), 0.8), pi_p, pi_ns,
                            jnp.full((n,), 0.7), None, sp)
        )
        assert np.isfinite(s).all()
        assert (s >= 0).all()


class TestBeamDiffusionTable:
    @pytest.fixture(scope="class")
    def table(self):
        return bssrdf.compute_beam_diffusion_table(g=0.0, eta=1.33,
                                                   n_rho=32, n_radius=32)

    def test_profile_nonnegative(self, table):
        assert (np.asarray(table.profile) >= -1e-6).all()

    def test_rho_eff_monotone_and_bounded(self, table):
        eff = np.asarray(table.rho_eff)
        assert (np.diff(eff) >= -1e-6).all()
        assert eff[0] < 1e-4  # zero albedo -> zero response
        assert eff[-1] <= 1.0 + 1e-3  # energy conservation

    def test_tabulated_pdf_integrates_to_one(self, table):
        """∫ Pdf_Sr(r) 2πr dr = 1 (the pdf is the normalized profile)."""
        sigma_t = 1.0
        rho = 0.8
        r = np.linspace(1e-5, float(table.radius_samples[-1]), 50000)
        pdf = np.asarray(
            bssrdf.tabulated_pdf_sr(table, jnp.asarray(sigma_t),
                                    jnp.full((len(r),), rho),
                                    jnp.asarray(r, jnp.float32))
        )
        est = np.trapezoid(pdf * 2 * np.pi * r, r)
        assert abs(est - 1.0) < 0.03, est

    def test_tabulated_sample_matches_pdf(self, table):
        n = 100000
        rho = 0.8
        sigma_t = 2.0
        u = jnp.asarray(np.random.default_rng(3).uniform(size=n), jnp.float32)
        r, valid = bssrdf.tabulated_sample_sr(
            table, jnp.asarray(sigma_t), jnp.full((n,), rho), u
        )
        assert bool(jnp.all(valid))
        r = np.asarray(r)
        assert (r >= 0).all() and np.isfinite(r).all()
        hist, edges = np.histogram(r, bins=30, range=(1e-4, 3.0), density=True)
        centers = 0.5 * (edges[:-1] + edges[1:])
        pdf_c = np.asarray(
            bssrdf.tabulated_pdf_sr(table, jnp.asarray(sigma_t),
                                    jnp.full((len(centers),), rho),
                                    jnp.asarray(centers, jnp.float32))
        ) * 2 * np.pi * centers
        inside = (r <= 3.0).mean()
        np.testing.assert_allclose(hist * inside, pdf_c, rtol=0.15, atol=0.03)

    def test_sr_pdf_proportionality(self, table):
        """Sr and Pdf_Sr differ only by the rho_eff normalization."""
        sigma_t = jnp.asarray([1.5])
        rho = 0.6
        r = jnp.asarray([0.05, 0.1, 0.2], jnp.float32)  # r_opt within table
        sr = np.asarray(
            bssrdf.tabulated_sr(table, jnp.broadcast_to(sigma_t, (3, 1)),
                                jnp.full((3, 1), rho), r)
        )[:, 0]
        pdf = np.asarray(
            bssrdf.tabulated_pdf_sr(table, sigma_t[0], jnp.full((3,), rho), r)
        )
        ratios = sr / np.maximum(pdf, 1e-12)
        np.testing.assert_allclose(ratios, ratios[0], rtol=1e-3)

    def test_subsurface_from_diffuse_roundtrip(self, table):
        # pick a rho node, read its rho_eff, invert
        idx = 20
        rho_want = float(table.rho_samples[idx])
        eff = table.rho_eff[idx]
        mfp = jnp.asarray(1.25)
        sigma_a, sigma_s = bssrdf.subsurface_from_diffuse(table, eff, mfp)
        rho_got = float(sigma_s / (sigma_a + sigma_s))
        assert abs(rho_got - rho_want) < 2e-2


class TestSampleSpMachinery:
    def test_axis_choice_probabilities(self):
        n = 100000
        u1 = jnp.asarray(np.random.default_rng(4).uniform(size=n), jnp.float32)
        ss = jnp.broadcast_to(jnp.asarray([1.0, 0, 0]), (n, 3))
        ts = jnp.broadcast_to(jnp.asarray([0.0, 1, 0]), (n, 3))
        ns = jnp.broadcast_to(jnp.asarray([0.0, 0, 1]), (n, 3))
        vx, vy, vz, u1r = bssrdf.choose_projection_axis(u1, ss, ts, ns)
        vz = np.asarray(vz)
        frac_ns = (vz[:, 2] == 1).mean()
        frac_ss = (vz[:, 0] == 1).mean()
        assert abs(frac_ns - 0.5) < 0.01
        assert abs(frac_ss - 0.25) < 0.01
        u1r = np.asarray(u1r)
        assert (u1r >= 0).all() and (u1r <= 1.0 + 1e-5).all()

    def test_pdf_sp_positive_finite(self):
        n = 64
        rng = np.random.default_rng(5)
        po_p = jnp.zeros((n, 3))
        pi_p = jnp.asarray(rng.normal(size=(n, 3)) * 0.3, jnp.float32)
        pi_ng = jnp.broadcast_to(jnp.asarray([0.0, 0, 1]), (n, 3))
        ss = jnp.broadcast_to(jnp.asarray([1.0, 0, 0]), (n, 3))
        ts = jnp.broadcast_to(jnp.asarray([0.0, 1, 0]), (n, 3))
        ns = jnp.broadcast_to(jnp.asarray([0.0, 0, 1]), (n, 3))
        d = 0.5

        def pdf_sr_fn(ch, r):
            return bssrdf.disney_pdf_sr(r, d)

        pdf = np.asarray(
            bssrdf.pdf_sp(pdf_sr_fn, po_p, pi_p, pi_ng, ss, ts, ns)
        )
        assert np.isfinite(pdf).all()
        assert (pdf > 0).all()


class TestSampleSpProbe:
    def test_probe_finds_wall(self):
        """Probe around a point on the Cornell floor: the chain walk must
        re-find the floor (same material) within the sampled disc."""
        from gnxraytracer.models.integrators import path
        from gnxraytracer.scene import presets
        import numpy as np

        scene, camera = presets.cornell_box(width=16, height=16)
        cfg = path.make_config(scene, 16, 16, spp=1)
        # floor of the reference Cornell box: find a floor triangle's
        # material by probing straight down from the center
        n = 32
        po_p = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 0.0]), (n, 3))
        # identify floor material via a downward ray
        from gnxraytracer.ops import trace

        h = trace.scene_intersect(
            scene, cfg, po_p[:1], jnp.asarray([[0.0, -1.0, 0.0]]),
            jnp.full((1,), 1e9)
        )
        it0 = trace.make_interaction(
            scene, cfg, po_p[:1], jnp.asarray([[0.0, -1.0, 0.0]]), h
        )
        assert bool(h.hit[0])
        floor_mat = it0.mat[0]
        floor_p = it0.p[0]

        # probe from the floor point along its own frame
        rng = np.random.default_rng(0)
        po = jnp.broadcast_to(floor_p, (n, 3))
        ns = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (n, 3))
        ss = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
        ts = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
        r = jnp.asarray(rng.uniform(0.01, 0.2, n), jnp.float32)
        phi = jnp.asarray(rng.uniform(0, 2 * np.pi, n), jnp.float32)
        found, pi, n_found = bssrdf.sample_sp_probe(
            scene, cfg, po, jnp.zeros((n, 3)), ns, ss, ts, ns, r, phi,
            jnp.full((n,), 0.5), jnp.full((n,), floor_mat, jnp.int32),
            jnp.asarray(rng.uniform(size=n), jnp.float32),
        )
        found = np.asarray(found)
        assert found.mean() > 0.9  # nearly every probe re-finds the floor
        # chosen points lie on the floor plane near the sampled radius
        pi_p = np.asarray(pi.p)[found]
        np.testing.assert_allclose(pi_p[:, 1], float(floor_p[1]), atol=1e-2)
        dist = np.linalg.norm(pi_p - np.asarray(floor_p), axis=-1)
        np.testing.assert_allclose(dist, np.asarray(r)[found], atol=2e-2)
