"""Sobol' generator-matrix construction + Owen scrambling tests."""

import jax.numpy as jnp
import pytest
import numpy as np

from gnxraytracer.ops import samplers, sobol


class TestMatrices:
    def test_dim0_is_van_der_corput(self):
        m = sobol.sobol_matrices()
        # dim 0 radical inverse: index 1 -> 0.5, 2 -> 0.25, 3 -> 0.75
        for idx, want in [(1, 0.5), (2, 0.25), (3, 0.75), (4, 0.125)]:
            v = sobol.sobol_u32_static(0, jnp.asarray([idx], jnp.uint32))
            got = float(sobol.to_unit_float(v)[0])
            np.testing.assert_allclose(got, want, atol=1e-7)

    def test_first_coordinate_stratification(self):
        """First 2^k points of any dim must be a (0,1)-stratified set:
        exactly one point per 1/2^k interval (the defining Sobol property)."""
        for dim in (0, 1, 2, 7, 50):
            idx = jnp.arange(64, dtype=jnp.uint32)
            u = np.asarray(sobol.to_unit_float(sobol.sobol_u32_static(dim, idx)))
            cells = np.floor(u * 64).astype(int)
            assert sorted(cells.tolist()) == list(range(64)), f"dim {dim}"

    def test_2d_projection_stratified(self):
        """Consecutive dims: first 2^k points fill a 2^j x 2^(k-j) grid with
        one point per cell (property of (t,s) digital nets, t small)."""
        idx = jnp.arange(256, dtype=jnp.uint32)
        u0 = np.asarray(sobol.to_unit_float(sobol.sobol_u32_static(0, idx)))
        u1 = np.asarray(sobol.to_unit_float(sobol.sobol_u32_static(1, idx)))
        cells = set(zip(np.floor(u0 * 16).astype(int),
                        np.floor(u1 * 16).astype(int)))
        assert len(cells) == 256  # perfectly stratified 16x16


class TestOwen:
    def test_scramble_preserves_stratification(self):
        idx = jnp.arange(64, dtype=jnp.uint32)
        v = sobol.sobol_u32_static(3, idx)
        sv = sobol.owen_scramble(v, jnp.uint32(0xABCD1234))
        u = np.asarray(sobol.to_unit_float(sv))
        cells = np.floor(u * 64).astype(int)
        assert sorted(cells.tolist()) == list(range(64))

    def test_different_seeds_decorrelate(self):
        idx = jnp.arange(128, dtype=jnp.uint32)
        v = sobol.sobol_u32_static(5, idx)
        a = np.asarray(sobol.to_unit_float(sobol.owen_scramble(v, jnp.uint32(1))))
        b = np.asarray(sobol.to_unit_float(sobol.owen_scramble(v, jnp.uint32(2))))
        assert not np.allclose(a, b)


class TestSobolSampler:
    def test_sampler_api(self):
        s = samplers.make_sobol_sampler(16)
        pix = jnp.arange(64, dtype=jnp.int32)
        smp = jnp.zeros_like(pix)
        u = np.asarray(samplers.sample_all_dims(s, pix, smp, 13))
        assert u.shape == (64, 13)
        assert np.all((u >= 0) & (u < 1))
        # different pixels get different scrambles of the same index
        assert len(np.unique(u[:, 5])) > 32

    @pytest.mark.slow
    def test_render_with_sobol(self):
        from gnxraytracer.models.integrators import path
        from gnxraytracer.scene import presets

        scene, cam = presets.cornell_box(width=16, height=16)
        cfg = path.make_config(scene, 16, 16, spp=16, max_depth=3, spp_chunk=16)
        s = samplers.make_sobol_sampler(16)
        img = np.asarray(path.render(scene, cam, s, cfg))
        assert np.isfinite(img).all() and img.mean() > 0.05
        # agrees with halton estimate
        h = samplers.make_halton_sampler(16, 16, 16)
        img_h = np.asarray(path.render(scene, cam, h, cfg))
        assert abs(img.mean() - img_h.mean()) / img_h.mean() < 0.1
