"""Nested-shell shadow transmittance (VERDICT r1 item 6).

The reference's VisibilityTester::Tr (/root/reference/core/Light.cpp:33-53)
walks through null-material boundaries multiplying each segment's medium
Tr.  models/media.transmittance_walk is the bounded wavefront equivalent; these
tests build a scene where the single-medium shortcut is provably wrong and
check the walk against a float64 analytic oracle.

Geometry: two nested axis-aligned null-material box shells,
  inner [-0.5, 0.5]^3 -> homogeneous medium A inside, B outside
  outer [-1.5, 1.5]^3 -> homogeneous medium B inside, vacuum outside
A shadow ray from the inner region along +x crosses x=0.5 (A->B) and
x=1.5 (B->vacuum): true Tr = exp(-sA*(0.5-x0)) * exp(-sB*1.0).
"""

import jax.numpy as jnp
import numpy as np

from gnxraytracer.models import media as media_mod
from gnxraytracer.models.integrators import volpath
from gnxraytracer.scene.presets import _box_mesh
from gnxraytracer.scene.scene import SceneBuilder

SIG_A = np.array([0.9, 0.5, 0.2])
SIG_B = np.array([0.1, 0.3, 0.6])


def nested_shell_scene():
    b = SceneBuilder()
    med_a = b.add_homogeneous_medium(SIG_A * 0.5, SIG_A * 0.5, g=0.0)
    med_b = b.add_homogeneous_medium(SIG_B * 0.5, SIG_B * 0.5, g=0.0)
    vi, fi = _box_mesh((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
    vo, fo = _box_mesh((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
    b.add_mesh(vi, fi, material=-1, medium=(med_a, med_b))
    b.add_mesh(vo, fo, material=-1, medium=(med_b, -1))
    b.add_point_light((5.0, 0.0, 0.0), (50.0, 50.0, 50.0))
    scene = b.build()
    return scene, med_a, med_b


def make_cfg(scene):
    cfg = volpath.make_config(scene, 8, 8, spp=1, max_depth=6,
                              tr_walk_segments=4)
    return cfg


class TestTransmittanceWalk:
    def test_matches_analytic_nested_shells(self):
        scene, med_a, med_b = nested_shell_scene()
        cfg = make_cfg(scene)
        x0 = np.array([-0.3, 0.0, 0.2, 0.45], np.float32)
        n = len(x0)
        o = np.stack([x0, np.zeros(n), np.zeros(n)], -1).astype(np.float32)
        d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
        t_max = np.full(n, 4.0, np.float32)  # ends in vacuum before light
        lane_key = jnp.arange(n, dtype=jnp.int32)
        tr, blocked = media_mod.transmittance_walk(
            scene, cfg, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
            jnp.full((n,), med_a, jnp.int32), lane_key, 3, 0x5EED)
        assert not np.asarray(blocked).any()
        # float64 oracle: segment lengths through each shell
        la = 0.5 - x0.astype(np.float64)
        lb = 1.5 - 0.5
        want = np.exp(-np.outer(la, SIG_A) - lb * SIG_B[None, :])
        np.testing.assert_allclose(np.asarray(tr), want, rtol=2e-3)

    def test_single_medium_shortcut_is_wrong_here(self):
        """Sanity: the pre-walk fast path (current-medium-only Tr) must
        disagree with the oracle on this scene, proving the walk is load-
        bearing rather than vacuously equal."""
        scene, med_a, med_b = nested_shell_scene()
        n = 3
        o = np.zeros((n, 3), np.float32)
        d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
        t_max = jnp.full((n,), 4.0)
        tr_fast = media_mod.medium_tr(
            scene.media, jnp.full((n,), med_a, jnp.int32), jnp.asarray(o),
            jnp.asarray(d), t_max, jnp.arange(n, dtype=jnp.int32), 3, 0)
        want = np.exp(-0.5 * SIG_A - 1.0 * SIG_B)
        assert np.abs(np.asarray(tr_fast) - want[None, :]).max() > 0.1

    def test_blocker_returns_zero(self):
        scene_b = SceneBuilder()
        med = scene_b.add_homogeneous_medium((0.2,) * 3, (0.2,) * 3)
        vi, fi = _box_mesh((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
        scene_b.add_mesh(vi, fi, material=-1, medium=(med, -1))
        m = scene_b.add_matte((0.5, 0.5, 0.5))
        vw, fw = _box_mesh((1.0, -0.2, -0.2), (1.2, 0.2, 0.2))
        scene_b.add_mesh(vw, fw, material=m)  # opaque blocker
        scene_b.add_point_light((5, 0, 0), (10, 10, 10))
        scene = scene_b.build()
        cfg = make_cfg(scene)
        o = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.6, 0.0]], jnp.float32)
        d = jnp.asarray([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], jnp.float32)
        tr, blocked = media_mod.transmittance_walk(
            scene, cfg, o, d, jnp.full((2,), 4.0), jnp.asarray([med, -1]),
            jnp.arange(2, dtype=jnp.int32), 1, 0)
        got = np.asarray(blocked)
        assert got[0]  # straight at the blocker
        assert not got[1]  # above it
        assert np.asarray(tr)[0].max() == 0.0

    def test_volpath_renders_with_walk(self):
        """End-to-end: the walk-enabled volpath integrator compiles and
        produces a finite image that differs from the single-medium mode
        on the nested-shell scene (brighter, since B is thinner than A
        along most shadow paths)."""
        from gnxraytracer.ops import samplers

        b = SceneBuilder()
        med_a = b.add_homogeneous_medium(SIG_A, SIG_A, g=0.0)
        med_b = b.add_homogeneous_medium(SIG_B * 0.1, SIG_B * 0.1, g=0.0)
        vi, fi = _box_mesh((-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
        vo, fo = _box_mesh((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))
        b.add_mesh(vi, fi, material=-1, medium=(med_a, med_b))
        b.add_mesh(vo, fo, material=-1, medium=(med_b, -1))
        m = b.add_matte((0.7, 0.7, 0.7))
        fv, ff = _box_mesh((-3, -2.2, -3), (3, -2.0, 3))
        b.add_mesh(fv, ff, material=m)
        b.add_point_light((4.0, 2.0, 0.0), (200.0, 200.0, 200.0))
        scene = b.build()
        from gnxraytracer.scene.camera import make_perspective_camera

        cam = make_perspective_camera(24, 24, eye=(0, 0.3, 5.0),
                                      look=(0, -0.2, 0))
        s = samplers.make_random_sampler(8, seed=1)
        cfg_w = volpath.make_config(scene, 24, 24, spp=8, max_depth=6,
                                    spp_chunk=8, tr_walk_segments=4)
        cfg_0 = cfg_w._replace(tr_walk_segments=0)
        img_w = np.asarray(volpath.render(scene, cam, s, cfg_w))
        img_0 = np.asarray(volpath.render(scene, cam, s, cfg_0))
        assert np.isfinite(img_w).all()
        assert np.abs(img_w - img_0).mean() > 1e-4
