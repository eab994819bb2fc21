"""End-to-end wavefront path-integrator tests on the Cornell preset
(SURVEY.md §4: golden-style integration checks on small configs)."""

import jax.numpy as jnp
import numpy as np
import pytest

from gnxraytracer.models.integrators import path
from gnxraytracer.ops import samplers
from gnxraytracer.scene import presets


@pytest.fixture(scope="module")
def cornell_small():
    scene, cam = presets.cornell_box(width=32, height=32)
    cfg = path.make_config(scene, 32, 32, spp=8, max_depth=5, spp_chunk=8)
    s = samplers.make_halton_sampler(cfg.spp, 32, 32)
    img = np.asarray(path.render(scene, cam, s, cfg))
    return scene, cam, cfg, s, img


class TestCornellRender:
    def test_finite_nonblack(self, cornell_small):
        _, _, _, _, img = cornell_small
        assert np.isfinite(img).all()
        assert img.mean() > 0.05

    def test_deterministic(self, cornell_small):
        scene, cam, cfg, s, img = cornell_small
        img2 = np.asarray(path.render(scene, cam, s, cfg))
        np.testing.assert_array_equal(img, img2)

    def test_light_patch_brightest(self, cornell_small):
        _, _, _, _, img = cornell_small
        lum = img @ np.asarray([0.2126, 0.7152, 0.0722])
        # the area light (Le=5) should dominate everything else
        top_rows = lum[:14]
        assert top_rows.max() > 3.0
        # direct emission ~5 per channel where the light is seen
        assert img.max() > 4.0

    def test_wall_color_bleeding(self, cornell_small):
        _, _, _, _, img = cornell_small
        left = img[8:28, :4].mean(axis=(0, 1))
        right = img[8:28, 28:].mean(axis=(0, 1))
        # blue wall on image-left (world +x, material2), red on image-right
        assert left[2] > 2.0 * left[0], f"left not blue: {left}"
        assert right[0] > 2.0 * right[2], f"right not red: {right}"

    @pytest.mark.slow
    def test_variance_decreases_with_spp(self):
        scene, cam = presets.cornell_box(width=24, height=24)
        imgs = {}
        for spp in (4, 32):
            cfg = path.make_config(scene, 24, 24, spp=spp, max_depth=5,
                                   spp_chunk=spp)
            s = samplers.make_random_sampler(spp, seed=3)
            imgs[spp] = np.asarray(path.render(scene, cam, s, cfg))
        # high-spp render as pseudo-reference
        cfg = path.make_config(scene, 24, 24, spp=128, max_depth=5, spp_chunk=32)
        s = samplers.make_random_sampler(128, seed=9)
        ref = np.asarray(path.render(scene, cam, s, cfg))
        err4 = np.abs(imgs[4] - ref).mean()
        err32 = np.abs(imgs[32] - ref).mean()
        assert err32 < err4, (err4, err32)

    @pytest.mark.slow
    def test_means_agree_across_samplers(self):
        # Halton and random samplers estimate the same integral
        scene, cam = presets.cornell_box(width=16, height=16)
        cfg = path.make_config(scene, 16, 16, spp=64, max_depth=5, spp_chunk=32)
        h = samplers.make_halton_sampler(64, 16, 16)
        r = samplers.make_random_sampler(64, seed=5)
        img_h = np.asarray(path.render(scene, cam, h, cfg))
        img_r = np.asarray(path.render(scene, cam, r, cfg))
        assert abs(img_h.mean() - img_r.mean()) / img_r.mean() < 0.1


class TestFastMis:
    def test_fast_mis_matches_faithful(self):
        """The folded-MIS estimator (2 casts/bounce) must agree with the
        reference-structured estimator in expectation."""
        scene, cam = presets.cornell_box(width=16, height=16)
        s = samplers.make_random_sampler(256, seed=11)
        cfg_a = path.make_config(scene, 16, 16, spp=256, max_depth=5,
                                 spp_chunk=64, fast_mis=False)
        cfg_b = cfg_a._replace(fast_mis=True)
        a = np.asarray(path.render(scene, cam, s, cfg_a))
        b = np.asarray(path.render(scene, cam, s, cfg_b))
        assert abs(a.mean() - b.mean()) / a.mean() < 0.03, (a.mean(), b.mean())


class TestSpherePointLight:
    def test_sphere_renders(self):
        scene, cam = presets.sphere_point_light(32, 32)
        cfg = path.make_config(scene, 32, 32, spp=4, max_depth=2, spp_chunk=4)
        s = samplers.make_random_sampler(cfg.spp)
        img = np.asarray(path.render(scene, cam, s, cfg))
        assert np.isfinite(img).all()
        # sphere lit from upper right; center of image nonblack
        assert img[12:20, 12:20].mean() > 0.01
        # corners (miss everything, no env) are black
        assert img[:2, :2].max() == 0.0
