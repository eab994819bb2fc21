"""The fused env Le+pdf path (models/lights.envmap_le_pdf,
sampling.sample_continuous_2d_idx) against the separate lookups it
replaces."""

import numpy as np
import jax.numpy as jnp


def test_envmap_le_pdf_matches_separate_path():
    from gnxraytracer.models import lights
    from gnxraytracer.models.integrators import path
    from gnxraytracer.scene import presets

    scene, _cam = presets.envmap_mesh(32, 32)
    cfg = path.make_config(scene, 32, 32, spp=2, max_depth=2)
    rs = np.random.RandomState(0)
    n = 2048
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)
    le_f, pdf_f = lights.envmap_le_pdf(scene, d)
    le_o = lights.envmap_le(scene, d)
    env_idx = jnp.argmax(scene.lights.kind == 4).astype(jnp.int32)
    lidx = jnp.full((n,), env_idx, jnp.int32)
    pdf_o = lights.pdf_li(scene, cfg, lidx, jnp.zeros((n, 3)), d)
    np.testing.assert_allclose(np.asarray(le_f), np.asarray(le_o),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(pdf_f), np.asarray(pdf_o),
                               rtol=1e-5, atol=1e-12)


def test_sample_continuous_2d_idx_consistent():
    """The idx variant's texel + the packed func channel reproduce
    sample_continuous_2d's pdf exactly (the le_func contract)."""
    from gnxraytracer.ops.sampling import (Distribution2D,
                                               make_distribution2d,
                                               sample_continuous_2d,
                                               sample_continuous_2d_idx)

    rs = np.random.RandomState(1)
    func = rs.rand(17, 33).astype(np.float32) ** 2
    d2 = make_distribution2d(jnp.asarray(func))
    u = jnp.asarray(rs.rand(4096, 2).astype(np.float32))
    p_a, pdf_a = sample_continuous_2d(d2, u)
    p_b, iv, iu = sample_continuous_2d_idx(d2, u)
    np.testing.assert_array_equal(np.asarray(p_a), np.asarray(p_b))
    packed = np.asarray(d2.cond_func) / float(d2.marg_int)
    pdf_b = packed[np.asarray(iv), np.asarray(iu)]
    np.testing.assert_allclose(np.asarray(pdf_a), pdf_b, rtol=1e-5,
                               atol=1e-12)
