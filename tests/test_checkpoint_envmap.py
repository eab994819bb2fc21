"""VERDICT r1 item 9 leftovers: checkpoint/resume roundtrip through the
CLI, and a chi-square test of InfiniteAreaLight importance sampling
(lights/InfiniteAreaLight.cpp:62-121 equivalent)."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "gnxraytracer.cli", "render", "--cpu",
         *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=500)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


class TestCheckpointResume:
    @pytest.mark.slow
    def test_resume_matches_uninterrupted(self, tmp_path):
        """8 spp + resume to 16 spp == straight 16 spp, bit-exact (the
        sampler streams are indexed by absolute sample id, so the resumed
        run renders exactly the missing samples)."""
        common = ["--preset", "cornell", "--width", "24", "--height", "24",
                  "--max-depth", "3", "--sampler", "halton",
                  "--spp-chunk", "4"]
        a = str(tmp_path / "a.npy")
        b = str(tmp_path / "b.npy")
        ck = str(tmp_path / "ck.npz")
        run_cli(*common, "--spp", "8", "--checkpoint", ck, "--out-npy", a)
        assert os.path.exists(ck)
        st = np.load(ck)
        assert int(st["spp"]) == 8
        out = run_cli(*common, "--spp", "16", "--checkpoint", ck, "--resume",
                      "--out-npy", b)
        assert "resumed at 8 spp" in out
        straight = str(tmp_path / "c.npy")
        run_cli(*common, "--spp", "16", "--out-npy", straight)
        np.testing.assert_array_equal(np.load(b), np.load(straight))


class TestEnvmapImportance:
    def _scene(self):
        from gnxraytracer.scene.scene import SceneBuilder

        rs = np.random.RandomState(7)
        # low-res env with strong hot spots (importance must follow them)
        img = rs.rand(16, 32, 3).astype(np.float32) * 0.2
        img[3, 5] = (40.0, 30.0, 20.0)
        img[10, 20] = (5.0, 25.0, 35.0)
        b = SceneBuilder()
        b.add_matte((0.5, 0.5, 0.5))
        b.set_environment(img)
        return b.build(), img

    def test_chi_square_matches_lum_sin_theta(self):
        """Histogram of sampled (u,v) cells vs the luminance*sin(theta)
        target pmf (the Distribution2D the reference builds,
        InfiniteAreaLight.cpp:62-82)."""
        from gnxraytracer.models import lights as lights_mod
        from gnxraytracer.models.integrators import path as path_mod

        scene, img = self._scene()
        cfg = path_mod.make_config(scene, 8, 8, spp=1)
        n = 200_000
        rs = np.random.RandomState(3)
        u2 = jnp.asarray(rs.rand(n, 2).astype(np.float32))
        p = jnp.zeros((n, 3), jnp.float32)
        lidx = jnp.zeros((n,), jnp.int32)  # the single infinite light
        ls = lights_mod.sample_li(scene, cfg, lidx, p, u2)
        # recover (u,v) from the sampled direction (identity light_to_world)
        wi = np.asarray(ls.wi)
        theta = np.arccos(np.clip(wi[:, 2], -1, 1))
        phi = np.arctan2(wi[:, 1], wi[:, 0])
        phi = np.where(phi < 0, phi + 2 * np.pi, phi)
        h, w = img.shape[:2]
        iu = np.minimum((phi / (2 * np.pi) * w).astype(int), w - 1)
        iv = np.minimum((theta / np.pi * h).astype(int), h - 1)
        counts = np.zeros((h, w))
        np.add.at(counts, (iv, iu), 1.0)
        lum = img @ np.array([0.212671, 0.715160, 0.072169])
        sin_t = np.sin(np.pi * (np.arange(h) + 0.5) / h)
        target = lum * sin_t[:, None]
        target = target / target.sum()
        expect = target * n
        # chi-square over cells with enough expected mass
        mask = expect > 20
        chi2 = (((counts - expect) ** 2) / np.maximum(expect, 1e-9))[mask].sum()
        dof = int(mask.sum()) - 1
        # loose bound: chi2/dof ~ 1 for a correct sampler; reject > 2
        assert chi2 / max(dof, 1) < 2.0, (chi2, dof)
        # the two hot texels together must receive the majority of samples
        hot = counts[3, 5] + counts[10, 20]
        assert hot / n > 0.5 * (target[3, 5] + target[10, 20])

    def test_pdf_li_consistent_with_histogram(self):
        """pdf_li at sampled directions integrates to ~1 over the sphere
        (MC check: E[1/pdf] over importance samples = 4pi-free total)."""
        from gnxraytracer.models import lights as lights_mod
        from gnxraytracer.models.integrators import path as path_mod

        scene, img = self._scene()
        cfg = path_mod.make_config(scene, 8, 8, spp=1)
        n = 50_000
        rs = np.random.RandomState(11)
        u2 = jnp.asarray(rs.rand(n, 2).astype(np.float32))
        p = jnp.zeros((n, 3), jnp.float32)
        lidx = jnp.zeros((n,), jnp.int32)
        ls = lights_mod.sample_li(scene, cfg, lidx, p, u2)
        pdf_q = np.asarray(
            lights_mod.pdf_li(scene, cfg, lidx, p, ls.wi))
        pdf_s = np.asarray(ls.pdf)
        ok = pdf_s > 1e-9
        # Pdf_Li must agree with the sampling pdf at the sampled directions
        # (a few lanes land exactly on texel boundaries where the
        # direction->uv roundtrip bins into the neighboring cell — require
        # the bulk to match instead of every lane)
        ratio = pdf_q[ok] / pdf_s[ok]
        frac_ok = (np.abs(ratio - 1.0) < 5e-2).mean()
        assert frac_ok > 0.995, frac_ok
        np.testing.assert_allclose(np.median(ratio), 1.0, rtol=1e-3)
        # MC power check: E[Le/pdf] = integral of Le over the sphere — a
        # low-variance estimator under importance sampling (Le/pdf is near
        # constant), unlike E[1/pdf] which blows up on rare dim texels
        li = np.asarray(ls.li)
        est = (li[ok] / pdf_s[ok, None]).mean(0)
        h, w = img.shape[:2]
        theta_c = np.pi * (np.arange(h) + 0.5) / h
        d_omega = (np.pi / h) * (2 * np.pi / w) * np.sin(theta_c)
        want = (img * d_omega[:, None, None]).sum((0, 1))
        np.testing.assert_allclose(est, want, rtol=0.1)
