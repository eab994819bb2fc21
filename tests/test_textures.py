"""Texture system: atlas lookups, kd textures in renders, bump mapping."""

import jax.numpy as jnp
import numpy as np
import pytest

from gnxraytracer.models.integrators import path
from gnxraytracer.ops import samplers
from gnxraytracer.ops.texture import (
    bilinear_lookup, build_texture_atlas, trilinear_lookup,
)
from gnxraytracer.scene.camera import make_perspective_camera
from gnxraytracer.scene.scene import SceneBuilder


def quad_scene(material_fn):
    b = SceneBuilder()
    m = material_fn(b)
    v = np.array([[-2, -2, 0], [2, -2, 0], [2, 2, 0], [-2, 2, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32)
    b.add_mesh(v, f, m, uvs=uv)
    b.add_point_light((3, 3, 4), (60, 60, 60))
    scene = b.build()
    cam = make_perspective_camera(32, 32, eye=(0, 0, 4.0), look=(0, 0, 0))
    return scene, cam


class TestAtlas:
    def test_bilinear_exact_at_texel_centers(self):
        img = np.random.RandomState(0).rand(256, 256, 3).astype(np.float32)
        atlas, offs, sizes = build_texture_atlas([img], base_size=256)
        # texel centers: uv = (i+0.5)/256
        ij = np.asarray([[10, 20], [100, 200], [255, 0]])
        uv = jnp.asarray((ij[:, ::-1] + 0.5) / 256.0, jnp.float32)
        got = np.asarray(bilinear_lookup(atlas, offs, sizes, jnp.zeros(3, jnp.int32), uv))
        want = img[ij[:, 0], ij[:, 1]]
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_mip_levels_average(self):
        img = np.ones((64, 64, 3), np.float32)
        img[::2] = 0.0  # stripes; every mip level >=1 averages to 0.5
        atlas, offs, sizes = build_texture_atlas([img], base_size=64)
        uv = jnp.asarray([[0.5, 0.5]])
        coarse = np.asarray(
            bilinear_lookup(atlas, offs, sizes, jnp.zeros(1, jnp.int32), uv,
                            level=3))
        np.testing.assert_allclose(coarse, 0.5, atol=0.05)

    def test_trilinear_blends(self):
        img = np.random.RandomState(1).rand(64, 64, 3).astype(np.float32)
        atlas, offs, sizes = build_texture_atlas([img], base_size=64)
        uv = jnp.asarray([[0.3, 0.7]])
        tid = jnp.zeros(1, jnp.int32)
        fine = np.asarray(trilinear_lookup(atlas, offs, sizes, tid, uv,
                                           jnp.asarray([1.0 / 64])))
        assert np.isfinite(fine).all()


class TestRenderedTextures:
    @pytest.mark.slow
    def test_kd_texture_colors_render(self):
        def mat(b):
            img = np.zeros((32, 32, 3), np.float32)
            img[:, :16] = [1.0, 0.0, 0.0]
            img[:, 16:] = [0.0, 0.0, 1.0]
            t = b.add_texture(img)
            return b.add_matte((1, 1, 1), kd_tex=t)

        scene, cam = quad_scene(mat)
        cfg = path.make_config(scene, 32, 32, spp=8, max_depth=1, spp_chunk=8)
        s = samplers.make_random_sampler(8)
        img = np.asarray(path.render(scene, cam, s, cfg))
        # LookAt handedness mirrors u: image-left shows texture u=1 (blue)
        left = img[10:22, 4:12]
        right = img[10:22, 20:28]
        assert left[..., 2].mean() > 3 * left[..., 0].mean()
        assert right[..., 0].mean() > 3 * right[..., 2].mean()

    @pytest.mark.slow
    def test_bump_mapping_changes_shading(self):
        y, x = np.mgrid[0:64, 0:64] / 64.0
        h = (0.5 + 0.5 * np.sin(x * 20) * np.sin(y * 20)).astype(np.float32)

        def mat(b):
            t = b.add_texture(np.stack([h] * 3, -1))
            return b.add_material(0, kd=(0.8, 0.8, 0.8), bump_tex=t,
                                  bump_scale=1.0)

        scene, cam = quad_scene(mat)
        cfg = path.make_config(scene, 32, 32, spp=16, max_depth=1, spp_chunk=16)
        assert cfg.has_bump
        s = samplers.make_random_sampler(16)
        bumped = np.asarray(path.render(scene, cam, s, cfg))
        flat = np.asarray(path.render(scene, cam, s, cfg._replace(has_bump=False)))
        assert np.isfinite(bumped).all()
        # bump perturbs shading substantially somewhere on the quad
        assert np.abs(bumped - flat).max() > 0.1


class TestMipFiltering:
    """VERDICT r1 item 4: MIPMap + camera ray differentials wired into the
    integrators.  A grazing-angle, heavily-tiled checker floor aliases with
    level-0 bilinear and must be smooth with the EWA footprint lookup
    (core/Interaction.cpp:65 -> core/MIPMap.h:259)."""

    @staticmethod
    def _floor_scene(w=48, h=48):
        b = SceneBuilder()
        # high-frequency checker: 32 px period at the 256-texel base level
        y, x = np.mgrid[0:256, 0:256]
        c = (((x // 16) + (y // 16)) % 2).astype(np.float32)
        tex = 0.1 + 0.8 * np.stack([c] * 3, -1)
        t = b.add_texture(tex)
        m = b.add_material(0, kd=(1, 1, 1), kd_tex=t)
        # deep floor quad, uv tiled 60x -> far pixels cover many periods
        v = np.array([[-30, -1, 2], [30, -1, 2], [30, -1, -120],
                      [-30, -1, -120]], np.float32)
        f = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
        uv = np.array([[0, 0], [60, 0], [60, 120], [0, 120]], np.float32)
        b.add_mesh(v, f, m, uvs=uv)
        b.add_distant_light((0.0, -1.0, -0.15), (3.0, 3.0, 3.0))
        scene = b.build()
        cam = make_perspective_camera(w, h, eye=(0, 0.5, 4.0),
                                      look=(0, -0.2, 0))
        return scene, cam

    def _render(self, filt, spp=1, w=48, h=48):
        scene, cam = self._floor_scene(w, h)
        cfg = path.make_config(scene, w, h, spp=spp, max_depth=1,
                               spp_chunk=spp, texture_filter=filt)
        s = samplers.make_halton_sampler(spp, w, h)
        return np.asarray(path.render(scene, cam, s, cfg))

    @pytest.mark.slow
    def test_ewa_removes_minification_aliasing(self):
        bil = self._render("bilinear")
        ewa = self._render("ewa")
        assert np.isfinite(ewa).all()
        # far region = upper floor rows (heavily minified).  Neighboring
        # pixels under bilinear alias across checker phases -> large local
        # pixel-to-pixel variation; EWA averages the footprint -> smooth.
        def far_rows(img):
            lum = img @ np.asarray([0.2126, 0.7152, 0.0722])
            rows = lum[12:22]  # distant floor band
            return rows
        rough_b = np.abs(np.diff(far_rows(bil), axis=1)).mean()
        rough_e = np.abs(np.diff(far_rows(ewa), axis=1)).mean()
        assert rough_e < 0.4 * rough_b, (rough_b, rough_e)
        # EWA converges to the checker mean (0.5 * albedo scale), not a
        # biased sample of one phase
        fb = far_rows(ewa)
        assert 0.2 < fb.mean() / max(far_rows(bil).mean(), 1e-6) < 2.0

    @pytest.mark.slow
    def test_trilinear_also_smooths(self):
        bil = self._render("bilinear")
        tri = self._render("trilinear")
        lum_b = np.abs(np.diff(bil[12:22] @ np.ones(3) / 3, axis=1)).mean()
        lum_t = np.abs(np.diff(tri[12:22] @ np.ones(3) / 3, axis=1)).mean()
        assert lum_t < 0.6 * lum_b, (lum_b, lum_t)
