"""Batched ray-primitive intersection.

The watertight ray-triangle test follows the same algorithm as the
reference (/root/reference/shape/Triangle.cpp:71-300 — translate to ray
origin, permute axes so |d| is largest in z, shear, signed edge functions,
conservative deltaT error bound), vectorized two ways: a (rays x
triangles) broadcast for mid-size T, and a lanes-flat fori_loop over
triangles for small scenes (flat per-lane arrays).  The
reference's float64 re-evaluation of exactly-zero edge functions
(shape/Triangle.cpp:153-160) is replaced by an FMA-safe zero snap
(_edge_fn) — f64 is slow or absent on accelerators, and FMA contraction otherwise
breaks the exact cancellation watertightness relies on.

Sphere intersection implements the *full* quadratic hit (the reference
Sphere is a stub that never fills the hit record, shape/Sphere.h:28-56 —
SURVEY.md §7 directs building the real thing).
"""

from typing import NamedTuple

import jax.numpy as jnp

from ..constants import INFINITY, gamma

GAMMA3 = gamma(3)
GAMMA5 = gamma(5)
GAMMA7 = gamma(7)

# f32 machine epsilon scale for the edge-function zero snap (see _edge_fn)
_EDGE_EPS = 4.0 * 1.1920929e-07


def _edge_fn(ax, ay, bx, by):
    """2D edge function a.x*b.y - a.y*b.x with a zero-snap.

    Under XLA the subtraction fuses into an FMA, so the exact cancellation
    the watertight algorithm relies on (shared-edge e == 0) leaves a tiny
    residue and rays leak through shared edges.  The reference fixes exact
    zeros with a float64 re-evaluation (shape/Triangle.cpp:153-160); here
    f32 stays f32, so values within the FMA residue bound of zero are
    snapped to exactly zero — equivalent acceptance behavior on edges.
    """
    p = ax * by
    q = ay * bx
    e = p - q
    tiny = jnp.abs(e) <= _EDGE_EPS * (jnp.abs(p) + jnp.abs(q))
    return jnp.where(tiny, 0.0, e)


class TriHit(NamedTuple):
    """Per-ray closest triangle hit (SoA)."""
    hit: jnp.ndarray  # (N,) bool
    t: jnp.ndarray  # (N,)
    tri: jnp.ndarray  # (N,) int32, valid where hit
    b: jnp.ndarray  # (N,3) barycentrics (b0, b1, b2)


def _permute_shear(o, d):
    """Precompute the axis permutation + shear for each ray.

    Gather-free: kz = argmax |d| is one of three cases, so permuted
    components come from where-chains (vector selects), never a
    per-lane gather.  Returns (kz_masks (m0,m1,m2), shear (N,3)).
    """
    ad = jnp.abs(d)
    kz = jnp.argmax(ad, axis=-1).astype(jnp.int32)
    m0 = kz == 0  # perm (kx,ky,kz) = (1,2,0)
    m1 = kz == 1  # (2,0,1)
    # else kz == 2: identity (0,1,2)
    dz = jnp.where(m0, d[..., 0], jnp.where(m1, d[..., 1], d[..., 2]))
    dx = jnp.where(m0, d[..., 1], jnp.where(m1, d[..., 2], d[..., 0]))
    dy = jnp.where(m0, d[..., 2], jnp.where(m1, d[..., 0], d[..., 1]))
    sx = -dx / dz
    sy = -dy / dz
    sz = 1.0 / dz
    shear = jnp.stack([sx, sy, sz], axis=-1)
    return (m0, m1), shear


def _permute3(m0, m1, v):
    """Apply the kz permutation to (..., 3) components via selects."""
    x = jnp.where(m0, v[..., 1], jnp.where(m1, v[..., 2], v[..., 0]))
    y = jnp.where(m0, v[..., 2], jnp.where(m1, v[..., 0], v[..., 1]))
    z = jnp.where(m0, v[..., 0], jnp.where(m1, v[..., 1], v[..., 2]))
    return x, y, z


def ray_triangles_watertight(o, d, t_max, p0, p1, p2):
    """Watertight intersection of N rays against T triangles, broadcast.

    o, d: (N, 3); t_max: (N,); p0/p1/p2: (T, 3).
    Returns (valid (N, T), t (N, T), b0, b1, b2 (N, T)).
    """
    (m0, m1), shear = _permute_shear(o, d)
    m0b = m0[:, None]
    m1b = m1[:, None]

    def permuted(p):
        pt = p[None] - o[:, None]  # translate: (N,T,3)
        return _permute3(m0b, m1b, pt)

    p0x, p0y, p0z = permuted(p0)
    p1x, p1y, p1z = permuted(p1)
    p2x, p2y, p2z = permuted(p2)

    sx = shear[:, None, 0]
    sy = shear[:, None, 1]
    sz = shear[:, None, 2]

    x0 = p0x + sx * p0z
    y0 = p0y + sy * p0z
    x1 = p1x + sx * p1z
    y1 = p1y + sy * p1z
    x2 = p2x + sx * p2z
    y2 = p2y + sy * p2z

    e0 = _edge_fn(x1, y1, x2, y2)
    e1 = _edge_fn(x2, y2, x0, y0)
    e2 = _edge_fn(x0, y0, x1, y1)

    # Same-sign test (zero-snapped edge functions; see _edge_fn)
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    det = e0 + e1 + e2
    valid = ~(neg & pos) & (det != 0)

    z0 = sz * p0z
    z1 = sz * p1z
    z2 = sz * p2z
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2

    det_neg = det < 0
    # reference: reject t<=0 or t>tMax via sign-aware comparisons
    bad_neg = det_neg & ((t_scaled >= 0) | (t_scaled < t_max[:, None] * det))
    bad_pos = (~det_neg) & ((t_scaled <= 0) | (t_scaled > t_max[:, None] * det))
    valid &= ~(bad_neg | bad_pos)

    inv_det = jnp.where(det != 0, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det
    t = t_scaled * inv_det

    # Conservative deltaT bound (Triangle.cpp:153-168): require t > deltaT
    max_zt = jnp.maximum(jnp.maximum(jnp.abs(z0), jnp.abs(z1)), jnp.abs(z2))
    delta_z = GAMMA3 * max_zt
    max_xt = jnp.maximum(jnp.maximum(jnp.abs(x0), jnp.abs(x1)), jnp.abs(x2))
    max_yt = jnp.maximum(jnp.maximum(jnp.abs(y0), jnp.abs(y1)), jnp.abs(y2))
    delta_x = GAMMA5 * (max_xt + max_zt)
    delta_y = GAMMA5 * (max_yt + max_zt)
    delta_e = 2.0 * (gamma(2) * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    max_e = jnp.maximum(jnp.maximum(jnp.abs(e0), jnp.abs(e1)), jnp.abs(e2))
    delta_t = 3.0 * (
        GAMMA3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e
    ) * jnp.abs(inv_det)
    valid &= t > delta_t

    return valid, t, b0, b1, b2


# Below this triangle count, brute force iterates triangles in a static
# loop over flat (N,) lane arrays
# instead of broadcasting to (N, T) whose tiny minor axis wastes the
# vector unit.  Above it, use the (N, T) broadcast (or the BVH).
SMALL_SCENE_T = 64


def _watertight_one(ox, oy, oz, m0, m1, sx, sy, sz, t_max, q0, q1, q2):
    """Watertight test of all rays against ONE triangle (flat (N,) math).

    q0/q1/q2: (3,) triangle vertices (traced scalars broadcast to lanes).
    Returns (valid, t, b0, b1, b2) each (N,).
    """
    def permuted(q):
        px = q[0] - ox
        py = q[1] - oy
        pz = q[2] - oz
        x = jnp.where(m0, py, jnp.where(m1, pz, px))
        y = jnp.where(m0, pz, jnp.where(m1, px, py))
        z = jnp.where(m0, px, jnp.where(m1, py, pz))
        return x + sx * z, y + sy * z, z

    x0, y0, z0 = permuted(q0)
    x1, y1, z1 = permuted(q1)
    x2, y2, z2 = permuted(q2)
    e0 = _edge_fn(x1, y1, x2, y2)
    e1 = _edge_fn(x2, y2, x0, y0)
    e2 = _edge_fn(x0, y0, x1, y1)
    neg = (e0 < 0) | (e1 < 0) | (e2 < 0)
    pos = (e0 > 0) | (e1 > 0) | (e2 > 0)
    det = e0 + e1 + e2
    valid = ~(neg & pos) & (det != 0)
    z0 = sz * z0
    z1 = sz * z1
    z2 = sz * z2
    t_scaled = e0 * z0 + e1 * z1 + e2 * z2
    det_neg = det < 0
    bad_neg = det_neg & ((t_scaled >= 0) | (t_scaled < t_max * det))
    bad_pos = (~det_neg) & ((t_scaled <= 0) | (t_scaled > t_max * det))
    valid &= ~(bad_neg | bad_pos)
    inv_det = jnp.where(det != 0, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    t = t_scaled * inv_det
    # conservative deltaT bound
    max_zt = jnp.maximum(jnp.maximum(jnp.abs(z0), jnp.abs(z1)), jnp.abs(z2))
    max_xt = jnp.maximum(jnp.maximum(jnp.abs(x0), jnp.abs(x1)), jnp.abs(x2))
    max_yt = jnp.maximum(jnp.maximum(jnp.abs(y0), jnp.abs(y1)), jnp.abs(y2))
    delta_x = GAMMA5 * (max_xt + max_zt)
    delta_y = GAMMA5 * (max_yt + max_zt)
    delta_e = 2.0 * (gamma(2) * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    max_e = jnp.maximum(jnp.maximum(jnp.abs(e0), jnp.abs(e1)), jnp.abs(e2))
    delta_t = 3.0 * (GAMMA3 * max_e * max_zt + delta_e * max_zt
                     + GAMMA3 * max_zt * max_e) * jnp.abs(inv_det)
    valid &= t > delta_t
    return valid, t, e0 * inv_det, e1 * inv_det, e2 * inv_det


def closest_triangle_hit_small(o, d, t_max, vertices, triangles, unroll=None):
    """Rolled-loop brute force for small T: flat (N,) lane math inside a
    lax.fori_loop over triangles — full lane utilization AND compact HLO.

    unroll: fori_loop unroll factor (default rolled; True unrolls up to
    32 triangles).  Not measured on the GPU."""
    import jax

    if unroll is None:
        unroll = 1
    elif unroll is True:
        unroll = min(int(triangles.shape[0]), 32)

    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    (m0, m1), shear = _permute_shear(o, d)
    sx, sy, sz = shear[:, 0], shear[:, 1], shear[:, 2]
    n = o.shape[0]
    init = (
        jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32),
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.zeros((n,), bool),
    )

    def body(ti, carry):
        best_t, best_tri, best_b, hit = carry
        tri = triangles[ti]
        q0 = vertices[tri[0]]
        q1 = vertices[tri[1]]
        q2 = vertices[tri[2]]
        valid, t, b0, b1, b2 = _watertight_one(
            ox, oy, oz, m0, m1, sx, sy, sz, best_t, q0, q1, q2
        )
        better = valid & (t < best_t)
        best_t = jnp.where(better, t, best_t)
        best_tri = jnp.where(better, ti, best_tri)
        best_b = jnp.where(better[:, None], jnp.stack([b0, b1, b2], -1), best_b)
        return best_t, best_tri, best_b, hit | better

    best_t, best_tri, best_b, hit = jax.lax.fori_loop(
        0, triangles.shape[0], body, init, unroll=unroll
    )
    return TriHit(hit=hit, t=jnp.where(hit, best_t, INFINITY), tri=best_tri,
                  b=best_b)


TRI_BLOCK = 128  # triangles per block of the blocked brute force


def closest_triangle_hit_blocked(o, d, t_max, vertices, triangles):
    """Blocked brute force for mid-size meshes: fori_loop over 128-triangle
    blocks, each an (N, 128) watertight broadcast: dense arithmetic in
    place of divergent traversal (the classic FLOPs-for-control-flow
    trade; the crossover against the BVH kernel is ROADMAP A6)."""
    import jax

    n = o.shape[0]
    t = triangles.shape[0]
    n_blocks = (t + TRI_BLOCK - 1) // TRI_BLOCK
    pad = n_blocks * TRI_BLOCK - t
    # pad with degenerate triangles (index 0 repeated -> det == 0 -> miss)
    tri_pad = jnp.concatenate(
        [triangles, jnp.zeros((pad, 3), triangles.dtype)], axis=0)
    p0 = vertices[tri_pad[:, 0]].reshape(n_blocks, TRI_BLOCK, 3)
    p1 = vertices[tri_pad[:, 1]].reshape(n_blocks, TRI_BLOCK, 3)
    p2 = vertices[tri_pad[:, 2]].reshape(n_blocks, TRI_BLOCK, 3)
    real = (jnp.arange(n_blocks * TRI_BLOCK) < t).reshape(n_blocks, TRI_BLOCK)

    def body(bi, carry):
        best_t, best_tri, best_b, hit = carry
        valid, tt, b0, b1, b2 = ray_triangles_watertight(
            o, d, best_t, p0[bi], p1[bi], p2[bi])
        valid &= real[bi][None, :]
        t_m = jnp.where(valid, tt, INFINITY)
        k = jnp.argmin(t_m, axis=-1)
        rows = jnp.arange(n)
        t_new = t_m[rows, k]
        better = t_new < best_t
        best_t = jnp.where(better, t_new, best_t)
        best_tri = jnp.where(better, bi * TRI_BLOCK + k, best_tri)
        bary = jnp.stack([b0[rows, k], b1[rows, k], b2[rows, k]], -1)
        best_b = jnp.where(better[:, None], bary, best_b)
        return best_t, best_tri, best_b, hit | better

    init = (
        jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32),
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n, 3), jnp.float32),
        jnp.zeros((n,), bool),
    )
    best_t, best_tri, best_b, hit = jax.lax.fori_loop(0, n_blocks, body, init)
    return TriHit(hit=hit, t=jnp.where(hit, best_t, INFINITY),
                  tri=best_tri.astype(jnp.int32), b=best_b)


def closest_triangle_hit(o, d, t_max, vertices, triangles):
    """Brute-force closest hit over an indexed mesh.

    o, d: (N,3); t_max: (N,); vertices: (V,3); triangles: (T,3) int32.
    Strategy by T: flat lane loop (small), 128-wide blocked broadcast
    (mid); very large meshes go through the BVH instead.
    """
    if triangles.shape[0] <= SMALL_SCENE_T:
        return closest_triangle_hit_small(o, d, t_max, vertices, triangles)
    if triangles.shape[0] > 4 * TRI_BLOCK:
        return closest_triangle_hit_blocked(o, d, t_max, vertices, triangles)
    p0 = vertices[triangles[:, 0]]
    p1 = vertices[triangles[:, 1]]
    p2 = vertices[triangles[:, 2]]
    valid, t, b0, b1, b2 = ray_triangles_watertight(o, d, t_max, p0, p1, p2)
    t_masked = jnp.where(valid, t, INFINITY)
    best = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)  # (N,)
    n = o.shape[0]
    rows = jnp.arange(n)
    hit = valid[rows, best]
    return TriHit(
        hit=hit,
        t=jnp.where(hit, t_masked[rows, best], INFINITY),
        tri=best,
        b=jnp.stack([b0[rows, best], b1[rows, best], b2[rows, best]], axis=-1),
    )


def any_triangle_hit(o, d, t_max, vertices, triangles, unroll=None):
    """Brute-force any-hit (shadow ray, IntersectP semantics)."""
    if triangles.shape[0] <= SMALL_SCENE_T:
        import jax

        if unroll is None:
            unroll = 1
        elif unroll is True:
            unroll = min(int(triangles.shape[0]), 32)
        ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
        (m0, m1), shear = _permute_shear(o, d)
        sx, sy, sz = shear[:, 0], shear[:, 1], shear[:, 2]
        n = o.shape[0]
        t_max = jnp.asarray(t_max, jnp.float32) * jnp.ones((n,), jnp.float32)

        def body(ti, occ):
            tri = triangles[ti]
            valid, _, _, _, _ = _watertight_one(
                ox, oy, oz, m0, m1, sx, sy, sz, t_max,
                vertices[tri[0]], vertices[tri[1]], vertices[tri[2]],
            )
            return occ | valid

        return jax.lax.fori_loop(0, triangles.shape[0], body,
                                 jnp.zeros((n,), bool), unroll=unroll)
    p0 = vertices[triangles[:, 0]]
    p1 = vertices[triangles[:, 1]]
    p2 = vertices[triangles[:, 2]]
    valid, _, _, _, _ = ray_triangles_watertight(o, d, t_max, p0, p1, p2)
    return jnp.any(valid, axis=-1)


# ---------------------------------------------------------------------------
# Spheres
# ---------------------------------------------------------------------------

class SphHit(NamedTuple):
    hit: jnp.ndarray  # (N,) bool
    t: jnp.ndarray  # (N,)
    sph: jnp.ndarray  # (N,) int32


def ray_spheres(o, d, t_max, center, radius):
    """N rays vs S spheres; returns (valid (N,S), t (N,S)) nearest positive root."""
    oc = o[:, None] - center[None]  # (N,S,3)
    a = jnp.sum(d * d, axis=-1)[:, None]
    b = 2.0 * jnp.sum(oc * d[:, None], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None]
    disc = b * b - 4 * a * c
    ok = disc > 0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
    t0 = q / a
    t1 = c / jnp.where(q == 0, 1.0, q)
    t_near = jnp.minimum(t0, t1)
    t_far = jnp.maximum(t0, t1)
    eps = 1e-4
    t = jnp.where(t_near > eps, t_near, t_far)
    ok &= (t > eps) & (t < t_max[:, None])
    return ok, t


def closest_sphere_hit(o, d, t_max, center, radius):
    valid, t = ray_spheres(o, d, t_max, center, radius)
    t_masked = jnp.where(valid, t, INFINITY)
    best = jnp.argmin(t_masked, axis=-1).astype(jnp.int32)
    rows = jnp.arange(o.shape[0])
    hit = valid[rows, best]
    return SphHit(hit=hit, t=jnp.where(hit, t_masked[rows, best], INFINITY), sph=best)
