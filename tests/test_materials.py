"""BSDF correctness: white-furnace energy bounds and sample/pdf
consistency (the chi-square-style checks the reference dropped,
SURVEY.md §4 item 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gnxraytracer.models import bxdf, materials
from gnxraytracer.models.integrators.path import RenderCfg
from gnxraytracer.scene.scene import SceneBuilder
from gnxraytracer.utils.math import abs_cos_theta


def build_mats(add_fn):
    b = SceneBuilder()
    add_fn(b)
    b.add_mesh(np.eye(3, dtype=np.float32), [[0, 1, 2]], 0)
    scene = b.build()
    return scene.materials


def cfg_for(mats, **kw):
    kinds = tuple(sorted(set(np.asarray(mats.kind).tolist())))
    return RenderCfg(width=1, height=1, spp=1, mat_kinds=kinds,
                     light_kinds=(), n_lights=0, **kw)


def mc_reflectance(mats, cfg, wo, n=200_000, seed=0):
    """rho(wo) = E[f * cos / pdf] via the material's own sampler."""
    rs = np.random.RandomState(seed)
    u2 = jnp.asarray(rs.rand(n, 2).astype(np.float32))
    uc = jnp.asarray(rs.rand(n).astype(np.float32))
    mid = jnp.zeros(n, jnp.int32)
    wo_b = jnp.broadcast_to(jnp.asarray(wo, jnp.float32), (n, 3))
    smp = materials.sample(mats, mid, cfg, wo_b, u2, uc)
    w = np.asarray(jnp.where(smp.valid[..., None], smp.weight, 0.0))
    return w.mean(axis=0)


class TestFresnel:
    def test_dielectric_normal_incidence(self):
        # R0 = ((n1-n2)/(n1+n2))^2 = 0.04 for eta 1.5
        fr = bxdf.fr_dielectric(jnp.asarray([1.0]), 1.0, 1.5)
        np.testing.assert_allclose(float(fr[0]), 0.04, atol=1e-4)

    def test_dielectric_grazing_is_one(self):
        fr = bxdf.fr_dielectric(jnp.asarray([0.001]), 1.0, 1.5)
        assert float(fr[0]) > 0.95

    def test_tir_from_inside(self):
        # beyond critical angle from dense side: total internal reflection
        fr = bxdf.fr_dielectric(jnp.asarray([-0.3]), 1.0, 1.5)
        assert float(fr[0]) == 1.0

    def test_conductor_bounded(self):
        eta = jnp.asarray([[0.2, 0.9, 1.4]])
        k = jnp.asarray([[3.9, 2.5, 2.1]])
        fr = bxdf.fr_conductor(jnp.asarray([0.7]), jnp.ones((1, 3)), eta, k)
        assert np.all((np.asarray(fr) >= 0) & (np.asarray(fr) <= 1))


class TestWhiteFurnace:
    """rho <= albedo (energy conservation) and rho ~ albedo for diffuse."""

    def test_lambert(self):
        mats = build_mats(lambda b: b.add_matte((1.0, 1.0, 1.0), sigma=0.0))
        cfg = cfg_for(mats)
        rho = mc_reflectance(mats, cfg, [0.3, 0.2, 0.93])
        np.testing.assert_allclose(rho, 1.0, atol=5e-3)

    def test_oren_nayar_conserves(self):
        mats = build_mats(lambda b: b.add_matte((1.0, 1.0, 1.0), sigma=60.0))
        cfg = cfg_for(mats)
        rho = mc_reflectance(mats, cfg, [0.0, 0.0, 1.0])
        assert np.all(rho <= 1.02) and np.all(rho > 0.5)

    def test_metal_below_one(self):
        mats = build_mats(lambda b: b.add_metal(
            (0.2, 0.92, 1.1), (3.9, 2.45, 2.14), roughness=0.1))
        cfg = cfg_for(mats)
        rho = mc_reflectance(mats, cfg, [0.0, 0.0, 1.0])
        assert np.all(rho <= 1.05), rho
        assert np.all(rho > 0.3)  # copper-ish is a good reflector

    def test_glass_smooth_total_energy(self):
        mats = build_mats(lambda b: b.add_glass(eta=1.5))
        cfg = cfg_for(mats)
        rho = mc_reflectance(mats, cfg, [0.0, 0.0, 1.0])
        # R + T should carry ~all energy (radiance-mode eta^2 asymmetry
        # cancels over a round trip; single crossing here: T scaled 1/eta^2)
        assert np.all(rho > 0.4) and np.all(rho < 1.1), rho

    def test_plastic_conserves(self):
        mats = build_mats(lambda b: b.add_plastic((0.8, 0.3, 0.3), roughness=0.2))
        cfg = cfg_for(mats)
        rho = mc_reflectance(mats, cfg, [0.2, 0.1, 0.97])
        assert np.all(rho <= 1.1), rho

    def test_disney_diffuse_only(self):
        mats = build_mats(lambda b: b.add_disney((0.7, 0.7, 0.7), rough_u=0.5,
                                                 metallic=0.0))
        cfg = cfg_for(mats)
        rho = mc_reflectance(mats, cfg, [0.0, 0.0, 1.0])
        assert np.all(rho <= 1.25), rho  # Disney is not strictly conserving
        assert np.all(rho > 0.3), rho

    def test_disney_metallic(self):
        mats = build_mats(lambda b: b.add_disney((0.9, 0.6, 0.2), rough_u=0.3,
                                                 metallic=1.0))
        cfg = cfg_for(mats)
        rho = mc_reflectance(mats, cfg, [0.0, 0.0, 1.0])
        assert np.all(rho <= 1.1), rho
        assert rho[0] > rho[2]  # keeps the golden tint


class TestSamplePdfConsistency:
    """pdf(wo, sampled wi) must equal the pdf reported by sample()."""

    @pytest.mark.parametrize("builder,kw", [
        (lambda b: b.add_matte((0.5, 0.5, 0.5), sigma=0.0), {}),
        (lambda b: b.add_metal((0.2, 0.9, 1.1), (3.9, 2.5, 2.1), roughness=0.3), {}),
        (lambda b: b.add_plastic((0.5, 0.5, 0.5), roughness=0.3), {}),
        (lambda b: b.add_disney((0.6, 0.5, 0.4), rough_u=0.4, metallic=0.3,
                                clearcoat=1.0), {}),
    ])
    def test_eval_pdf_matches_sample_pdf(self, builder, kw):
        mats = build_mats(builder)
        cfg = cfg_for(mats)
        rs = np.random.RandomState(7)
        n = 5000
        u2 = jnp.asarray(rs.rand(n, 2).astype(np.float32))
        uc = jnp.asarray(rs.rand(n).astype(np.float32))
        mid = jnp.zeros(n, jnp.int32)
        wo = jnp.broadcast_to(jnp.asarray([0.4, -0.2, 0.89]), (n, 3))
        wo = wo / jnp.linalg.norm(wo, axis=-1, keepdims=True)
        smp = materials.sample(mats, mid, cfg, wo, u2, uc)
        f_eval, pdf_eval = materials.evaluate(mats, mid, cfg, wo, smp.wi)
        valid = np.asarray(smp.valid) & ~np.asarray(smp.specular)
        pe = np.asarray(pdf_eval)[valid]
        ps = np.asarray(smp.pdf)[valid]
        np.testing.assert_allclose(pe, ps, rtol=2e-3, atol=1e-4)
        fe = np.asarray(f_eval)[valid]
        fs = np.asarray(smp.f)[valid]
        np.testing.assert_allclose(fe, fs, rtol=2e-3, atol=1e-4)
