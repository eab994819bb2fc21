"""Multi-host helpers: range splitting and slab/sample-mode rendering
(single-process semantics; real multi-host differs only in process ids)."""

import pytest
import numpy as np

from gnxraytracer.models.integrators import path
from gnxraytracer.ops import samplers
from gnxraytracer.parallel import multihost
from gnxraytracer.scene import presets


class TestRanges:
    def test_sample_split_covers_all(self):
        spans = [multihost.sample_range_for_host(100, pid, 8) for pid in range(8)]
        covered = []
        for start, count in spans:
            covered.extend(range(start, start + count))
        assert sorted(covered) == list(range(100))

    def test_row_split_covers_all(self):
        spans = [multihost.row_range_for_host(37, pid, 4) for pid in range(4)]
        covered = []
        for start, count in spans:
            covered.extend(range(start, start + count))
        assert sorted(covered) == list(range(37))

    def test_init_is_noop_single_host(self):
        multihost.init()  # must not block or raise without a coordinator


class TestRealTwoProcess:
    """Launch TWO coordinated jax.distributed processes (CPU backend, 2
    virtual chips each) and check the cross-process sample-split render
    combines to the single-process image."""

    @pytest.mark.slow
    def test_two_process_sample_split(self, tmp_path):
        import os
        import socket
        import subprocess
        import sys

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "tests._multihost_worker",
                 str(pid), "2", str(port), str(tmp_path)],
                cwd=repo, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for pid in range(2)
        ]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            outs.append(out.decode(errors="replace"))
        for pid, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {pid} failed:\n{out}"

        # oracle: single-process render of the same config
        scene, cam = presets.cornell_box(width=8, height=8)
        cfg = path.make_config(scene, 8, 8, spp=4, max_depth=2, spp_chunk=2)
        s = samplers.make_sobol_sampler(4)
        full = np.asarray(path.render(scene, cam, s, cfg))

        for pid in range(2):
            img = np.load(tmp_path / f"img_{pid}.npy")
            np.testing.assert_allclose(img, full, atol=1e-5)


class TestSlabRender:
    @pytest.mark.slow
    def test_row_slab_matches_full_render(self):
        scene, cam = presets.cornell_box(width=8, height=8)
        cfg = path.make_config(scene, 8, 8, spp=4, max_depth=2, spp_chunk=4)
        s = samplers.make_sobol_sampler(4)
        slab, rows = multihost.render_multihost(scene, cam, s, cfg, mode="rows")
        full = np.asarray(path.render(scene, cam, s, cfg))
        assert slab.shape == (rows, 8, 3)
        np.testing.assert_allclose(slab, full[:rows], atol=1e-5)
