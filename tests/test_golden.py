"""Golden-image regression tests (SURVEY.md §4 item 2): fixed sampler
streams, low-res renders compared against committed fixtures.  Guards
against silent estimator/sampler/geometry regressions between rounds."""

import os

import numpy as np
import pytest

from gnxraytracer.models.integrators import path, volpath, whitted
from gnxraytracer.ops import samplers
from gnxraytracer.scene import presets

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def check(name, img, rtol=2e-3, atol=2e-4):
    # Regenerate fixtures after a deliberate estimator change with:
    #   GOLDEN_REGEN=1 pytest tests/test_golden.py
    # (then re-run tests/test_reference_parity.py — the oracle goldens are
    # the ground truth that guards against regenerating in a broken state).
    path_ = os.path.join(GOLDEN, name)
    if os.environ.get("GOLDEN_REGEN"):
        np.save(path_, img)
        return
    ref = np.load(path_)
    np.testing.assert_allclose(img, ref, rtol=rtol, atol=atol,
                               err_msg=f"golden drift: {name}")


class TestGolden:
    def test_cornell_path_sobol(self):
        scene, cam = presets.cornell_box(width=32, height=32)
        cfg = path.make_config(scene, 32, 32, spp=16, max_depth=5, spp_chunk=16)
        s = samplers.make_sobol_sampler(16)
        check("cornell_path_sobol_32.npy",
              np.asarray(path.render(scene, cam, s, cfg)))

    def test_cornell_whitted_halton(self):
        scene, cam = presets.cornell_box(width=32, height=32)
        cfg = path.make_config(scene, 32, 32, spp=8, max_depth=5, spp_chunk=8)
        s = samplers.make_halton_sampler(8, 32, 32)
        check("cornell_whitted_halton_32.npy",
              np.asarray(whitted.render(scene, cam, s, cfg)))

    def test_volpath(self):
        scene, cam = presets.volumetric_cornell(24, 24,
                                                use_reference_volume=False)
        cfg = path.make_config(scene, 24, 24, spp=8, max_depth=6, spp_chunk=8)
        s = samplers.make_random_sampler(8, seed=5)
        check("volpath_24.npy", np.asarray(volpath.render(scene, cam, s, cfg)))

    # -- VERDICT r1 item 9: goldens for BASELINE configs 2/3/4 and the
    # bench estimator (fast_mis + compact_tail), which previously had none

    def test_direct_cornell_mis(self):
        """BASELINE config 2: DirectLighting on the Cornell box (MIS)."""
        from gnxraytracer.models.integrators import direct

        scene, cam = presets.cornell_box(width=32, height=32)
        cfg = path.make_config(scene, 32, 32, spp=8, max_depth=3, spp_chunk=8)
        s = samplers.make_halton_sampler(8, 32, 32)
        check("direct_cornell_32.npy",
              np.asarray(direct.render(scene, cam, s, cfg, "one")))

    def test_cornell_glass_path(self):
        """BASELINE config 3: glass/mirror/Disney Cornell, Halton, 8 deep."""
        scene, cam = presets.cornell_glass(width=32, height=32)
        cfg = path.make_config(scene, 32, 32, spp=8, max_depth=8, spp_chunk=8)
        s = samplers.make_halton_sampler(8, 32, 32)
        check("cornell_glass_path_32.npy",
              np.asarray(path.render(scene, cam, s, cfg)))

    @pytest.mark.slow
    def test_envmap_mesh_sobol(self):
        """BASELINE config 4 (small stand-in): mesh + ImageTexture + HDR env
        + Sobol through the EWA texture path.  Kept small — the 8-virtual-
        device CPU backend pays a heavy compile for the EWA+env graph."""
        scene, cam = presets.envmap_mesh(24, 24, mesh_tris=320)
        cfg = path.make_config(scene, 24, 24, spp=4, max_depth=3, spp_chunk=4)
        s = samplers.make_sobol_sampler(4)
        check("envmap_mesh_sobol_24.npy",
              np.asarray(path.render(scene, cam, s, cfg)))

    def test_bench_estimator_fast_mis_compact(self):
        """The exact estimator bench.py ships (fast_mis + compact_tail +
        count_rays): guards the headline perf config against silent value
        drift.  Width 2048 lanes so the compact path (n % frac == 0,
        m >= 256) actually engages at this test size."""
        scene, cam = presets.cornell_box(width=16, height=16)
        cfg = path.make_config(scene, 16, 16, spp=8, max_depth=8,
                               spp_chunk=8, fast_mis=True, compact_tail=True,
                               compact_from=5, compact_frac=8,
                               rr_threshold=1.0, count_rays=True)
        s = samplers.make_sobol_sampler(8)
        img, nrays = path._render_chunk_jit(scene, cam, s, cfg, 0, 8)
        img = np.asarray(img).reshape(16, 16, 3) / 8
        assert float(nrays) > 0
        check("bench_fastmis_compact_16.npy", img)
