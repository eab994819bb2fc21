"""Differentiable-rendering tests: finite-difference vs AD gradients of
the pixel loss w.r.t. scene parameters (SURVEY.md §4 item 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gnxraytracer.models.integrators import path
from gnxraytracer.ops import samplers
from gnxraytracer.parallel import sharding
from gnxraytracer.scene import presets


@pytest.fixture(scope="module")
def setup():
    scene, cam = presets.cornell_box(width=16, height=16)
    cfg = path.make_config(scene, 16, 16, spp=32, max_depth=3, spp_chunk=32)
    s = samplers.make_halton_sampler(32, 16, 16)
    return scene, cam, cfg, s


def render_with(scene, cam, cfg, s):
    img = path.render_chunk(scene, cam, s, cfg, 0, cfg.spp_chunk)
    return img / cfg.spp_chunk


class TestGradients:
    @pytest.mark.slow
    def test_grad_wrt_kd_matches_fd(self, setup):
        scene, cam, cfg, s = setup

        def loss(kd):
            sc = scene._replace(materials=scene.materials._replace(kd=kd))
            return jnp.mean(render_with(sc, cam, cfg, s))

        kd0 = scene.materials.kd
        g = jax.grad(loss)(kd0)
        assert np.isfinite(np.asarray(g)).all()
        # FD on the white-wall red channel (material 0)
        eps = 1e-2
        e = jnp.zeros_like(kd0).at[0, 0].set(eps)
        fd = (loss(kd0 + e) - loss(kd0 - e)) / (2 * eps)
        ad = g[0, 0]
        # same sampler stream -> FD is exact up to float noise & nonlinearity
        np.testing.assert_allclose(float(ad), float(fd), rtol=0.08, atol=1e-5)
        assert float(ad) > 0  # brighter wall -> brighter image

    @pytest.mark.slow
    def test_grad_wrt_light_emission(self, setup):
        scene, cam, cfg, s = setup

        def loss(emit):
            sc = scene._replace(lights=scene.lights._replace(emit=emit))
            return jnp.mean(render_with(sc, cam, cfg, s))

        e0 = scene.lights.emit
        g = jax.grad(loss)(e0)
        assert np.isfinite(np.asarray(g)).all()
        # emission enters linearly: FD should match tightly
        eps = 1e-2
        de = jnp.zeros_like(e0).at[0, 1].set(eps)
        fd = (loss(e0 + de) - loss(e0 - de)) / (2 * eps)
        np.testing.assert_allclose(float(g[0, 1]), float(fd), rtol=2e-2)
        assert float(g[0, 1]) > 0

    def test_grad_wrt_sigma_finite(self, setup):
        scene, cam, cfg, s = setup

        def loss(sigma):
            sc = scene._replace(materials=scene.materials._replace(sigma=sigma))
            return jnp.mean(render_with(sc, cam, cfg, s))

        g = jax.grad(loss)(scene.materials.sigma)
        assert np.isfinite(np.asarray(g)).all()

    @pytest.mark.slow
    def test_train_step_reduces_loss(self, setup):
        """One inverse-rendering step on kd moves the loss down."""
        scene, cam, cfg, s = setup
        target = np.asarray(render_with(scene, cam, cfg, s))
        # perturb kd away from truth, then take gradient steps back
        mats = scene.materials
        kd_wrong = jnp.clip(mats.kd + 0.2, 0.0, 1.0)
        sc = scene._replace(materials=mats._replace(kd=kd_wrong))

        def loss(kd):
            s2 = scene._replace(materials=mats._replace(kd=kd))
            img = render_with(s2, cam, cfg, s)
            return jnp.mean((img - target) ** 2)

        l0 = float(loss(kd_wrong))
        g = jax.grad(loss)(kd_wrong)
        kd_new = kd_wrong - 2.0 * g
        l1 = float(loss(kd_new))
        assert l1 < l0, (l0, l1)


class TestShardedTrainStep:
    @pytest.mark.slow
    def test_8device_step_matches_1device(self):
        """Sharded (8 virtual devices) training step == single-device step."""
        scene, cam = presets.cornell_box(width=8, height=8)
        cfg = path.make_config(scene, 8, 8, spp=4, max_depth=2, spp_chunk=4)
        s = samplers.make_halton_sampler(4, 8, 8)
        params = sharding.extract_params(scene)
        target = jnp.zeros((8, 8, 3))
        mesh8 = sharding.make_mesh(8)
        mesh1 = sharding.make_mesh(1)
        step8 = sharding.make_train_step(cfg, mesh8)
        step1 = sharding.make_train_step(cfg, mesh1)
        l8, p8 = step8(params, scene, cam, s, target)
        l1, p1 = step1(params, scene, cam, s, target)
        np.testing.assert_allclose(float(l8), float(l1), rtol=1e-5)
        for k in params:
            np.testing.assert_allclose(np.asarray(p8[k]), np.asarray(p1[k]),
                                       rtol=1e-4, atol=1e-6)


class TestGradientSurface:
    """VERDICT r1 item 8: every parameter class SURVEY §7 names is a
    gradient target — roughness, eta, Disney params, medium sigma, texture
    texels — each checked FD-vs-AD (directional derivative where the
    per-element signal is tiny)."""

    def _dir_fd_check(self, loss, x0, eps, rtol, key=0):
        g = jax.grad(loss)(x0)
        assert np.isfinite(np.asarray(g)).all()
        v = jax.random.normal(jax.random.PRNGKey(key), x0.shape, x0.dtype)
        fd = (loss(x0 + eps * v) - loss(x0 - eps * v)) / (2 * eps)
        ad = jnp.sum(g * v)
        np.testing.assert_allclose(float(ad), float(fd), rtol=rtol,
                                   atol=5e-4)
        return g

    @pytest.mark.slow
    def test_grad_wrt_roughness(self):
        from gnxraytracer.scene.scene import SceneBuilder
        from gnxraytracer.scene.camera import make_perspective_camera

        b = SceneBuilder()
        m = b.add_plastic((0.4, 0.4, 0.4), roughness=0.3)
        fv = np.array([[-2, -1, 2], [2, -1, 2], [2, -1, -2], [-2, -1, -2]],
                      np.float32)
        b.add_mesh(fv, np.array([[0, 1, 2], [0, 2, 3]]), m)
        b.add_point_light((1.5, 2.0, 1.5), (30, 30, 30))
        scene = b.build()
        cam = make_perspective_camera(16, 16, eye=(0, 0.5, 3), look=(0, -0.5, 0))
        cfg = path.make_config(scene, 16, 16, spp=16, max_depth=2, spp_chunk=16)
        s = samplers.make_halton_sampler(16, 16, 16)

        def loss(r):
            sc = scene._replace(materials=scene.materials._replace(
                rough_u=r, rough_v=r))
            return jnp.mean(render_with(sc, cam, cfg, s))

        self._dir_fd_check(loss, scene.materials.rough_u, 1e-3, 0.25)

    @pytest.mark.slow
    def test_grad_wrt_eta_finite_and_nonzero(self):
        # slow-tier on purpose: 16x16x16spp glass AD costs ~20s on the
        # 2-core builder (same re-triage as the other >=15s cases)
        """Dielectric eta: the sampled direction is detached
        (stop_gradient), but the Fresnel split is attached — gradient must
        be finite and nonzero on a glass scene."""
        scene, cam = presets.cornell_glass(width=16, height=16)
        cfg = path.make_config(scene, 16, 16, spp=16, max_depth=4,
                               spp_chunk=16)
        s = samplers.make_halton_sampler(16, 16, 16)

        def loss(eta):
            sc = scene._replace(materials=scene.materials._replace(eta=eta))
            return jnp.mean(render_with(sc, cam, cfg, s))

        g = jax.grad(loss)(scene.materials.eta)
        assert np.isfinite(np.asarray(g)).all()
        assert np.abs(np.asarray(g)).max() > 0

    @pytest.mark.slow
    def test_grad_wrt_disney_params(self):
        from gnxraytracer.scene.scene import SceneBuilder
        from gnxraytracer.scene.camera import make_perspective_camera

        b = SceneBuilder()
        m = b.add_disney((0.6, 0.3, 0.2), rough_u=0.4, metallic=0.4,
                         sheen=0.5, clearcoat=0.5)
        fv = np.array([[-2, -1, 2], [2, -1, 2], [2, -1, -2], [-2, -1, -2]],
                      np.float32)
        b.add_mesh(fv, np.array([[0, 1, 2], [0, 2, 3]]), m)
        b.add_point_light((1.5, 2.0, 1.5), (30, 30, 30))
        scene = b.build()
        cam = make_perspective_camera(16, 16, eye=(0, 0.5, 3), look=(0, -0.5, 0))
        cfg = path.make_config(scene, 16, 16, spp=16, max_depth=2, spp_chunk=16)
        s = samplers.make_halton_sampler(16, 16, 16)

        def loss_metallic(x):
            sc = scene._replace(materials=scene.materials._replace(metallic=x))
            return jnp.mean(render_with(sc, cam, cfg, s))

        self._dir_fd_check(loss_metallic, scene.materials.metallic, 1e-3, 0.25)

        for col in ("sheen", "clearcoat", "spec_trans"):
            def loss_c(x, c=col):
                sc = scene._replace(
                    materials=scene.materials._replace(**{c: x}))
                return jnp.mean(render_with(sc, cam, cfg, s))

            g = jax.grad(loss_c)(getattr(scene.materials, col))
            assert np.isfinite(np.asarray(g)).all(), col

    @pytest.mark.slow
    def test_grad_wrt_medium_sigma(self):
        from gnxraytracer.models.integrators import volpath
        from gnxraytracer.scene.scene import SceneBuilder
        from gnxraytracer.scene.camera import make_perspective_camera
        from gnxraytracer.scene.presets import _box_mesh

        b = SceneBuilder()
        med = b.add_homogeneous_medium((0.3, 0.3, 0.3), (0.4, 0.4, 0.4))
        vi, fi = _box_mesh((-1, -1, -1), (1, 1, 1))
        b.add_mesh(vi, fi, material=-1, medium=(med, -1))
        floor = b.add_matte((0.7, 0.7, 0.7))
        fv = np.array([[-3, -1.5, 3], [3, -1.5, 3], [3, -1.5, -3],
                       [-3, -1.5, -3]], np.float32)
        b.add_mesh(fv, np.array([[0, 1, 2], [0, 2, 3]]), floor)
        b.add_point_light((2, 3, 2), (60, 60, 60))
        scene = b.build()
        cam = make_perspective_camera(12, 12, eye=(0, 0.3, 4), look=(0, -0.3, 0))
        cfg = volpath.make_config(scene, 12, 12, spp=8, max_depth=4,
                                  spp_chunk=8)
        s = samplers.make_random_sampler(8, seed=5)

        def loss(sa):
            sc = scene._replace(media=scene.media._replace(sigma_a=sa))
            return jnp.mean(volpath.render_chunk(sc, cam, s, cfg, 0, 8))

        g = jax.grad(loss)(scene.media.sigma_a)
        assert np.isfinite(np.asarray(g)).all()
        # more absorption -> darker image: negative gradient on the medium
        assert float(np.asarray(g)[0].sum()) < 0

    @pytest.mark.slow
    def test_grad_wrt_texture_texels(self):
        from gnxraytracer.scene.scene import SceneBuilder
        from gnxraytracer.scene.camera import make_perspective_camera

        b = SceneBuilder()
        rs = np.random.RandomState(0)
        t = b.add_texture(0.2 + 0.6 * rs.rand(64, 64, 3).astype(np.float32))
        m = b.add_matte((1, 1, 1), kd_tex=t)
        fv = np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]],
                      np.float32)
        uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
        b.add_mesh(fv, np.array([[0, 1, 2], [0, 2, 3]]), m, uvs=uv)
        b.add_point_light((2, 2, 3), (40, 40, 40))
        scene = b.build()
        cam = make_perspective_camera(16, 16, eye=(0, 0, 3.5), look=(0, 0, 0))
        cfg = path.make_config(scene, 16, 16, spp=8, max_depth=2,
                               spp_chunk=8, texture_filter="bilinear")
        s = samplers.make_halton_sampler(8, 16, 16)
        atlas0 = scene.textures[0]

        def loss(atlas):
            sc = scene._replace(textures=(atlas,) + tuple(scene.textures[1:]))
            return jnp.mean(render_with(sc, cam, cfg, s))

        self._dir_fd_check(loss, atlas0, 1e-2, 0.15)

    def test_extract_insert_roundtrip_covers_all_classes(self):
        scene, _ = presets.envmap_mesh(8, 8, mesh_tris=50)
        p = sharding.extract_params(scene)
        for k in ("kd", "rough_u", "eta", "metallic", "sheen", "clearcoat",
                  "light_emit", "env_image", "tex_atlas"):
            assert k in p, k
        sc2 = sharding.insert_params(scene, jax.tree_util.tree_map(
            lambda x: x * 1.0, p))
        np.testing.assert_allclose(np.asarray(sc2.materials.metallic),
                                   np.asarray(scene.materials.metallic))
