"""Light-type coverage: spot, distant, power/spatial strategies,
analytic checks against closed forms."""

import jax.numpy as jnp
import pytest
import numpy as np

from gnxraytracer.models import light_dist, lights
from gnxraytracer.models.integrators import path
from gnxraytracer.ops import samplers
from gnxraytracer.scene.camera import make_perspective_camera
from gnxraytracer.scene.scene import SceneBuilder


def plane_scene(add_lights):
    b = SceneBuilder()
    m = b.add_matte((0.8, 0.8, 0.8), sigma=0.0)
    g = 4.0
    v = np.array([[-g, 0, g], [g, 0, g], [-g, 0, -g],
                  [g, 0, g], [g, 0, -g], [-g, 0, -g]], np.float32)
    b.add_mesh(v, np.arange(6).reshape(2, 3), m)
    add_lights(b)
    scene = b.build()
    cam = make_perspective_camera(32, 32, eye=(0, 3.0, 6.0), look=(0, 0, 0))
    return scene, cam


def render(scene, cam, spp=16, **kw):
    cfg = path.make_config(scene, 32, 32, spp=spp, max_depth=2, spp_chunk=spp,
                           **kw)
    s = samplers.make_random_sampler(spp, seed=1)
    return np.asarray(path.render(scene, cam, s, cfg))


class TestSpotLight:
    def test_cone_limits_illumination(self):
        # narrow spot pointing down at origin: bright center, dark edges
        scene, cam = plane_scene(lambda b: b.add_spot_light(
            (0, 4, 0), (0, -1, 0), (80, 80, 80), total_width_deg=15,
            falloff_start_deg=10))
        img = render(scene, cam)
        lum = img @ np.asarray([0.2126, 0.7152, 0.0722])
        center = lum[16:22, 12:20].mean()
        border = lum[26:30, 2:6].mean()
        assert center > 10 * max(border, 1e-6), (center, border)

    def test_wide_spot_approaches_point(self):
        # 90-degree spot with no falloff ~ point light over the lit half
        scene_s, cam = plane_scene(lambda b: b.add_spot_light(
            (0, 4, 0), (0, -1, 0), (80, 80, 80), total_width_deg=89,
            falloff_start_deg=88))
        scene_p, _ = plane_scene(lambda b: b.add_point_light(
            (0, 4, 0), (80, 80, 80)))
        a = render(scene_s, cam)
        b = render(scene_p, cam)
        center = (slice(14, 24), slice(10, 22))
        np.testing.assert_allclose(a[center].mean(), b[center].mean(), rtol=0.05)


class TestDistantLight:
    def test_parallel_illumination(self):
        # straight-down distant light: unshadowed plane has L = kd/pi * E
        scene, cam = plane_scene(lambda b: b.add_distant_light(
            (0, -1, 0), (2.0, 2.0, 2.0)))
        img = render(scene, cam)
        lit = np.median(img[18:26, 8:24])  # median: region edge touches bg
        want = 0.8 / np.pi * 2.0  # kd/pi * |cos(0)| * L
        np.testing.assert_allclose(lit, want, rtol=0.02)


class TestPowerStrategy:
    @pytest.mark.slow
    def test_power_reduces_variance_vs_uniform(self):
        """With one bright + one negligible light, power selection puts all
        samples on the bright light -> lower variance at equal spp."""
        def add(b):
            b.add_point_light((0, 4, 0), (80, 80, 80))
            b.add_point_light((3, 4, 3), (0.001, 0.001, 0.001))

        scene, cam = plane_scene(add)
        imgs_u, imgs_p = [], []
        for seed in range(4):
            cfg_u = path.make_config(scene, 32, 32, spp=8, max_depth=2,
                                     spp_chunk=8, light_strategy="uniform")
            cfg_p = cfg_u._replace(light_strategy="power")
            s = samplers.make_random_sampler(8, seed=seed)
            imgs_u.append(np.asarray(path.render(scene, cam, s, cfg_u)))
            imgs_p.append(np.asarray(path.render(scene, cam, s, cfg_p)))
        var_u = np.var(np.stack(imgs_u), axis=0).mean()
        var_p = np.var(np.stack(imgs_p), axis=0).mean()
        assert var_p < var_u, (var_u, var_p)


class TestSpatialStrategy:
    def test_spatial_grid_builds_and_renders(self):
        # skybox off: with it on, its tiny spatial pmf makes the estimator
        # heavy-tailed and neither mean nor median converges at test spp
        from gnxraytracer.scene import presets

        scene, cam = presets.cornell_box(width=16, height=16, skybox=False)
        cfg = path.make_config(scene, 16, 16, spp=32, max_depth=3,
                               spp_chunk=32, light_strategy="spatial")
        dist = light_dist.build_spatial_distribution(scene, cfg, res=8,
                                                     n_samples=16)
        scene2 = scene._replace(light_dist=dist)
        s = samplers.make_random_sampler(32, seed=2)
        img = np.asarray(path.render(scene2, cam, s, cfg))
        assert np.isfinite(img).all() and img.mean() > 0.05
        cfg_u = cfg._replace(light_strategy="uniform")
        img_u = np.asarray(path.render(scene, cam, s, cfg_u))
        assert abs(img.mean() - img_u.mean()) / img_u.mean() < 0.1, (
            img.mean(), img_u.mean())
