"""Whitted / DirectLighting integrator tests + cross-integrator agreement
(direct illumination must match between Whitted, Direct, and Path on a
diffuse-only scene where all estimators share the same expectation)."""

import numpy as np
import pytest

from gnxraytracer.models.integrators import direct, path, whitted
from gnxraytracer.ops import samplers
from gnxraytracer.scene import presets


def render_all(scene, cam, w, h, spp, max_depth, seed=0):
    out = {}
    cfg = path.make_config(scene, w, h, spp=spp, max_depth=max_depth,
                           spp_chunk=min(spp, 16))
    s = samplers.make_random_sampler(spp, seed=seed)
    out["path"] = np.asarray(path.render(scene, cam, s, cfg))
    out["whitted"] = np.asarray(whitted.render(scene, cam, s, cfg))
    out["direct_one"] = np.asarray(direct.render(scene, cam, s, cfg, "one"))
    out["direct_all"] = np.asarray(direct.render(scene, cam, s, cfg, "all"))
    return out


class TestSphereScene:
    """BASELINE config 1: matte sphere + point light. Direct lighting only,
    so all four integrators must agree exactly in expectation."""

    @pytest.mark.slow
    def test_integrators_agree(self):
        scene, cam = presets.sphere_point_light(32, 32)
        imgs = render_all(scene, cam, 32, 32, spp=64, max_depth=3)
        ref = imgs["whitted"]
        assert ref.mean() > 0.005
        for k in ("direct_one", "direct_all"):
            num = np.abs(imgs[k] - ref).mean()
            den = ref.mean() + 1e-6
            assert num / den < 0.05, (k, num / den)
        # path adds tiny indirect (sphere only: no interreflection) -> close
        assert np.abs(imgs["path"] - ref).mean() / (ref.mean() + 1e-6) < 0.05

    def test_whitted_point_light_is_deterministic_shading(self):
        # point light NEE has pdf 1 and no randomness: identical across spp
        scene, cam = presets.sphere_point_light(24, 24)
        cfg = path.make_config(scene, 24, 24, spp=2, max_depth=2, spp_chunk=2)
        s = samplers.make_random_sampler(2, seed=1)
        img = np.asarray(whitted.render(scene, cam, s, cfg))
        assert np.isfinite(img).all()


class TestCornellWhitted:
    def test_whitted_darker_than_path(self):
        """Whitted misses diffuse interreflection -> strictly less energy
        than path tracing on the Cornell box."""
        scene, cam = presets.cornell_box(width=24, height=24)
        cfg = path.make_config(scene, 24, 24, spp=32, max_depth=5, spp_chunk=16)
        s = samplers.make_halton_sampler(32, 24, 24)
        img_w = np.asarray(whitted.render(scene, cam, s, cfg))
        img_p = np.asarray(path.render(scene, cam, s, cfg))
        assert img_w.mean() < img_p.mean()
        assert img_w.mean() > 0.1  # but not black

    def test_direct_between_whitted_and_path(self):
        # skybox off: Direct's MIS BSDF-side picks up skybox Le that
        # Whitted structurally cannot (reference EstimateDirect:159-207),
        # so only the skybox-free scene has Direct == Whitted.
        scene, cam = presets.cornell_box(width=16, height=16, skybox=False)
        cfg = path.make_config(scene, 16, 16, spp=64, max_depth=5, spp_chunk=32)
        s = samplers.make_random_sampler(64, seed=2)
        img_w = np.asarray(whitted.render(scene, cam, s, cfg)).mean()
        img_d = np.asarray(direct.render(scene, cam, s, cfg, "one")).mean()
        img_p = np.asarray(path.render(scene, cam, s, cfg)).mean()
        # direct(MIS, one light) estimates the same 1-bounce integral as
        # whitted (all lights, no MIS) on this diffuse scene
        assert abs(img_d - img_w) / img_w < 0.1, (img_d, img_w)
        assert img_p > img_d


class TestMirrorCornell:
    def test_mirror_reflection_visible_in_whitted(self):
        # swap the back-wall-facing dragon material spot for a mirror floor:
        # build cornell with a mirror sphere in front
        from gnxraytracer.scene.scene import SceneBuilder
        from gnxraytracer.scene.presets import (
            add_area_lights, add_cornell, reference_materials)
        from gnxraytracer.scene.camera import make_perspective_camera

        b = SceneBuilder()
        mats = reference_materials(b)
        add_cornell(b, mats["red"], mats["blue"], mats["white"])
        add_area_lights(b, mats["dragon"])
        b.add_sphere((0.0, -1.0, 0.5), 1.0, mats["mirror"])
        scene = b.build()
        cam = make_perspective_camera(32, 32, eye=(0, 0, 5.0), look=(0, 0, 0))
        cfg = path.make_config(scene, 32, 32, spp=16, max_depth=5, spp_chunk=16)
        s = samplers.make_halton_sampler(16, 32, 32)
        img = np.asarray(whitted.render(scene, cam, s, cfg))
        assert np.isfinite(img).all()
        # mirror sphere region reflects colored walls -> nonzero
        center = img[18:26, 12:20]
        assert center.mean() > 0.02


class TestWhittedFaithful:
    """VERDICT r1 item 10: dual specular recursion
    (WhittedIntegrator.cpp:56-62) behind cfg.whitted_faithful."""

    @staticmethod
    def _glass_scene(w=32, h=32):
        from gnxraytracer.scene.camera import make_perspective_camera
        from gnxraytracer.scene.scene import SceneBuilder

        b = SceneBuilder()
        floor = b.add_matte((0.7, 0.7, 0.7))
        glass = b.add_glass(eta=1.5)
        fv = np.array([[-4, -1, 4], [4, -1, 4], [4, -1, -4], [-4, -1, -4]],
                      np.float32)
        b.add_mesh(fv, np.array([[0, 1, 2], [0, 2, 3]]), floor)
        b.add_sphere((0.0, 0.2, 0.0), 0.9, glass)
        b.add_point_light((3, 4, 3), (80, 80, 80))
        scene = b.build()
        cam = make_perspective_camera(w, h, eye=(0, 0.6, 3.5),
                                      look=(0, 0, 0))
        return scene, cam

    @pytest.mark.slow
    def test_faithful_matches_stochastic_expectation(self):
        scene, cam = self._glass_scene()
        s_lo = samplers.make_random_sampler(8, seed=0)
        cfg_f = path.make_config(scene, 32, 32, spp=8, max_depth=4,
                                 spp_chunk=8, whitted_faithful=True)
        img_f = np.asarray(whitted.render(scene, cam, s_lo, cfg_f))
        assert np.isfinite(img_f).all()
        s_hi = samplers.make_random_sampler(128, seed=1)
        cfg_s = path.make_config(scene, 32, 32, spp=128, max_depth=4,
                                 spp_chunk=32)
        img_s = np.asarray(whitted.render(scene, cam, s_hi, cfg_s))
        # same expectation: block-averaged images agree
        bf = img_f.reshape(8, 4, 8, 4, 3).mean((1, 3))
        bs = img_s.reshape(8, 4, 8, 4, 3).mean((1, 3))
        np.testing.assert_allclose(bf, bs, atol=0.12)

    @pytest.mark.slow
    def test_faithful_has_no_fresnel_choice_variance(self):
        """At equal spp, the faithful tree (deterministic branches) must
        have less residual noise than the stochastic single-branch mode
        inside the glass sphere silhouette."""
        scene, cam = self._glass_scene()
        cfg_f = path.make_config(scene, 32, 32, spp=4, max_depth=4,
                                 spp_chunk=4, whitted_faithful=True)
        cfg_s = cfg_f._replace(whitted_faithful=False)
        a = np.asarray(whitted.render(
            scene, cam, samplers.make_random_sampler(4, seed=2), cfg_f))
        b = np.asarray(whitted.render(
            scene, cam, samplers.make_random_sampler(4, seed=3), cfg_f))
        c = np.asarray(whitted.render(
            scene, cam, samplers.make_random_sampler(4, seed=2), cfg_s))
        d = np.asarray(whitted.render(
            scene, cam, samplers.make_random_sampler(4, seed=3), cfg_s))
        # seed-to-seed variation inside the sphere region
        sl = np.s_[8:24, 8:24]
        var_f = np.abs(a - b)[sl].mean()
        var_s = np.abs(c - d)[sl].mean()
        assert var_f < var_s
