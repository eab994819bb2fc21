"""Watertight triangle / sphere intersection vs float64 brute-force oracles
(SURVEY.md §4 test pyramid, item 1)."""

import jax.numpy as jnp
import numpy as np

from gnxraytracer.ops import intersect


def mt_oracle(o, d, p0, p1, p2):
    """Moller-Trumbore in float64 (reference-independent oracle)."""
    e1, e2 = p1 - p0, p2 - p0
    pv = np.cross(d, e2)
    det = e1 @ pv
    if abs(det) < 1e-12:
        return None
    inv = 1.0 / det
    tv = o - p0
    u = (tv @ pv) * inv
    if u < 0 or u > 1:
        return None
    qv = np.cross(tv, e1)
    v = (d @ qv) * inv
    if v < 0 or u + v > 1:
        return None
    t = (e2 @ qv) * inv
    return t if t > 0 else None


class TestTriangle:
    def test_random_rays_match_oracle(self):
        rs = np.random.RandomState(0)
        tris = rs.randn(50, 3, 3).astype(np.float32)
        verts = tris.reshape(-1, 3)
        idx = np.arange(150).reshape(50, 3).astype(np.int32)
        o = rs.randn(200, 3).astype(np.float32) * 3
        d = rs.randn(200, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        hit = intersect.closest_triangle_hit(
            jnp.asarray(o), jnp.asarray(d), jnp.full(200, 1e30, jnp.float32),
            jnp.asarray(verts), jnp.asarray(idx),
        )
        got_hit = np.asarray(hit.hit)
        got_t = np.asarray(hit.t)
        mismatches = 0
        for i in range(200):
            ts = [
                t for k in range(50)
                if (t := mt_oracle(o[i].astype(np.float64), d[i].astype(np.float64),
                                   *tris[k].astype(np.float64))) is not None
            ]
            want_hit = len(ts) > 0
            if want_hit != got_hit[i]:
                mismatches += 1
            elif want_hit:
                if abs(min(ts) - got_t[i]) > 1e-3 * max(1.0, abs(min(ts))):
                    mismatches += 1
        # allow rare float32-vs-float64 edge disagreements
        assert mismatches <= 2, f"{mismatches} oracle mismatches"

    def test_watertight_shared_edge(self):
        # Two triangles sharing an edge: rays through the shared edge must
        # hit at least one (the watertight property the algorithm exists for)
        verts = jnp.asarray([
            [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 1.0, 0.0],
        ])
        tris = jnp.asarray([[0, 1, 2], [1, 3, 2]], jnp.int32)
        rs = np.random.RandomState(1)
        # rays aimed exactly at points on the shared diagonal
        s = rs.rand(500).astype(np.float32)
        targets = np.stack([s, 1 - s, np.zeros_like(s)], -1)
        o = np.asarray([0.3, 0.3, 5.0], np.float32)
        d = targets - o
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        hit = intersect.closest_triangle_hit(
            jnp.broadcast_to(o, (500, 3)), jnp.asarray(d),
            jnp.full(500, 1e30, jnp.float32), verts, tris,
        )
        assert bool(jnp.all(hit.hit)), "leak through shared edge"

    def test_tmax_respected(self):
        verts = jnp.asarray([[-1, -1, 0], [1, -1, 0], [0, 1, 0.0]])
        tris = jnp.asarray([[0, 1, 2]], jnp.int32)
        o = jnp.asarray([[0.0, 0.0, 5.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        far = intersect.closest_triangle_hit(o, d, jnp.asarray([10.0]), verts, tris)
        near = intersect.closest_triangle_hit(o, d, jnp.asarray([4.0]), verts, tris)
        assert bool(far.hit[0]) and not bool(near.hit[0])
        np.testing.assert_allclose(float(far.t[0]), 5.0, rtol=1e-5)


class TestSphere:
    def test_direct_hit(self):
        c = jnp.asarray([[0.0, 0.0, 0.0]])
        r = jnp.asarray([1.0])
        o = jnp.asarray([[0.0, 0.0, 5.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        h = intersect.closest_sphere_hit(o, d, jnp.asarray([1e30]), c, r)
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), 4.0, rtol=1e-5)

    def test_inside_sphere(self):
        c = jnp.asarray([[0.0, 0.0, 0.0]])
        r = jnp.asarray([2.0])
        o = jnp.asarray([[0.0, 0.0, 0.0]])
        d = jnp.asarray([[1.0, 0.0, 0.0]])
        h = intersect.closest_sphere_hit(o, d, jnp.asarray([1e30]), c, r)
        assert bool(h.hit[0])
        np.testing.assert_allclose(float(h.t[0]), 2.0, rtol=1e-5)

    def test_miss(self):
        c = jnp.asarray([[0.0, 5.0, 0.0]])
        r = jnp.asarray([1.0])
        o = jnp.asarray([[0.0, 0.0, 5.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        h = intersect.closest_sphere_hit(o, d, jnp.asarray([1e30]), c, r)
        assert not bool(h.hit[0])
