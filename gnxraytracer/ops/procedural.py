"""Procedural texturing: Perlin noise, FBm, Turbulence, and the 2D/3D
texture-coordinate mappings.

Batched jnp equivalents of the reference texture support layer
(/root/reference/core/Texture.{h,cpp}):

  * `noise(p)` — classic improved Perlin gradient noise over (N, 3) points
    (core/Texture.cpp Noise/Grad/NoiseWeight). The permutation table is
    Ken Perlin's reference table (the same public data the reference
    embeds); gradient selection is done branchlessly from the hashed index
    so all N lanes evaluate in lockstep.
  * `fbm` / `turbulence` — antialiased octave sums with the reference's
    1.99 lacunarity, SmoothStep partial-octave fade, and (for turbulence)
    the 0.2 clamped-octave average (core/Texture.cpp:108-150).
  * mappings — UV / Spherical / Cylindrical / Planar / Transform3D
    (core/Texture.h:25-103) as pure functions point->st; the reference's
    per-mapping screen-space derivative outputs become optional forward
    differences (used only by EWA filtering).

Everything is differentiable w.r.t. the query points (noise is piecewise
smooth: quintic fade gives C2 continuity).
"""

import jax.numpy as jnp
import numpy as np

from ..constants import PI
from ..utils.math import HIGHEST, normalize, spherical_phi, spherical_theta

# Ken Perlin's reference permutation (public domain; identical data to the
# table embedded at core/Texture.cpp:22-54), doubled for overflow-free
# nested indexing.
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], np.int32)
_NOISE_PERM = jnp.asarray(np.concatenate([_PERM, _PERM]))


def _grad(ix, iy, iz, dx, dy, dz):
    """Grad (core/Texture.cpp:95-102) vectorized: hash -> one of 16
    gradient directions, evaluated branchlessly."""
    h = _NOISE_PERM[_NOISE_PERM[_NOISE_PERM[ix] + iy] + iz] & 15
    u = jnp.where((h < 8) | (h == 12) | (h == 13), dx, dy)
    v = jnp.where((h < 4) | (h == 12) | (h == 13), dy, dz)
    return jnp.where(h & 1, -u, u) + jnp.where(h & 2, -v, v)


def _noise_weight(t):
    """Quintic fade 6t^5 - 15t^4 + 10t^3 (core/Texture.cpp:104)."""
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def noise(p):
    """Perlin Noise(p) over (..., 3) points (core/Texture.cpp:57-92)."""
    p = jnp.asarray(p, jnp.float32)
    pf = jnp.floor(p)
    d = p - pf
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    pi = pf.astype(jnp.int32) & 255
    ix, iy, iz = pi[..., 0], pi[..., 1], pi[..., 2]

    w000 = _grad(ix, iy, iz, dx, dy, dz)
    w100 = _grad(ix + 1, iy, iz, dx - 1, dy, dz)
    w010 = _grad(ix, iy + 1, iz, dx, dy - 1, dz)
    w110 = _grad(ix + 1, iy + 1, iz, dx - 1, dy - 1, dz)
    w001 = _grad(ix, iy, iz + 1, dx, dy, dz - 1)
    w101 = _grad(ix + 1, iy, iz + 1, dx - 1, dy, dz - 1)
    w011 = _grad(ix, iy + 1, iz + 1, dx, dy - 1, dz - 1)
    w111 = _grad(ix + 1, iy + 1, iz + 1, dx - 1, dy - 1, dz - 1)

    wx, wy, wz = _noise_weight(dx), _noise_weight(dy), _noise_weight(dz)
    x00 = w000 + wx * (w100 - w000)
    x10 = w010 + wx * (w110 - w010)
    x01 = w001 + wx * (w101 - w001)
    x11 = w011 + wx * (w111 - w011)
    y0 = x00 + wy * (x10 - x00)
    y1 = x01 + wy * (x11 - x01)
    return y0 + wz * (y1 - y0)


def _smooth_step(lo, hi, v):
    t = jnp.clip((v - lo) / (hi - lo), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _octave_count(dpdx, dpdy, max_octaves):
    """Antialiased octave count n = clamp(-1 - 0.5 log2(len2), 0, max)
    (core/Texture.cpp:110-112)."""
    len2 = jnp.maximum(
        jnp.sum(dpdx * dpdx, -1), jnp.sum(dpdy * dpdy, -1)
    )
    len2 = jnp.maximum(len2, 1e-20)
    return jnp.clip(-1.0 - 0.5 * jnp.log2(len2), 0.0, float(max_octaves))


def fbm(p, dpdx=None, dpdy=None, omega=0.5, max_octaves=8):
    """FBm (core/Texture.cpp:108-126). dpdx/dpdy default to point-sampled
    (full octave count)."""
    p = jnp.asarray(p, jnp.float32)
    if dpdx is None:
        n = jnp.full(p.shape[:-1], float(max_octaves))
    else:
        n = _octave_count(dpdx, dpdy, max_octaves)
    sum_ = jnp.zeros(p.shape[:-1], jnp.float32)
    lam = 1.0
    o = jnp.ones_like(sum_)
    for i in range(max_octaves):
        active = i < jnp.floor(n)
        sum_ = sum_ + jnp.where(active, o * noise(lam * p), 0.0)
        # partial-octave fade at i == floor(n)
        partial = (i == jnp.floor(n).astype(jnp.int32))
        sum_ = sum_ + jnp.where(
            partial, o * _smooth_step(0.3, 0.7, n - jnp.floor(n)) * noise(lam * p), 0.0
        )
        lam *= 1.99
        o = jnp.where(active, o * omega, o)
    return sum_


def turbulence(p, dpdx=None, dpdy=None, omega=0.5, max_octaves=8):
    """Turbulence (core/Texture.cpp:128-150): |noise| octaves + the 0.2
    average for clamped octaves."""
    p = jnp.asarray(p, jnp.float32)
    if dpdx is None:
        n = jnp.full(p.shape[:-1], float(max_octaves))
    else:
        n = _octave_count(dpdx, dpdy, max_octaves)
    n_int = jnp.floor(n)
    sum_ = jnp.zeros(p.shape[:-1], jnp.float32)
    lam = 1.0
    o = jnp.ones_like(sum_)
    for i in range(max_octaves):
        active = i < n_int
        sum_ = sum_ + jnp.where(active, o * jnp.abs(noise(lam * p)), 0.0)
        partial = (i == n_int.astype(jnp.int32))
        t = _smooth_step(0.3, 0.7, n - n_int)
        sum_ = sum_ + jnp.where(
            partial, o * ((1.0 - t) * 0.2 + t * jnp.abs(noise(lam * p))), 0.0
        )
        # clamped octaves contribute their 0.2 mean (Texture.cpp:144-147)
        clamped = i >= n_int
        sum_ = sum_ + jnp.where(clamped & ~partial, o * 0.2, 0.0)
        lam *= 1.99
        o = o * omega
    return sum_


# ---------------------------------------------------------------------------
# Texture-coordinate mappings (core/Texture.h:25-103)
# ---------------------------------------------------------------------------

def uv_mapping(uv, su=1.0, sv=1.0, du=0.0, dv=0.0):
    """UVMapping2D::Map: st = (su*u + du, sv*v + dv)."""
    return jnp.stack([su * uv[..., 0] + du, sv * uv[..., 1] + dv], axis=-1)


def spherical_mapping(p, world_to_texture=None):
    """SphericalMapping2D::Map (pointToSphere): direction from the texture
    frame origin -> (theta/pi, phi/2pi)."""
    if world_to_texture is not None:
        p = _apply44(world_to_texture, p)
    vec = normalize(p, eps=1e-20)
    return jnp.stack(
        [spherical_theta(vec) / PI, spherical_phi(vec) / (2.0 * PI)], axis=-1
    )


def cylindrical_mapping(p, world_to_texture=None):
    """CylindricalMapping2D::Map: (phi/2pi, z) of the normalized point."""
    if world_to_texture is not None:
        p = _apply44(world_to_texture, p)
    vec = normalize(p, eps=1e-20)
    return jnp.stack([spherical_phi(vec) / (2.0 * PI), vec[..., 2]], axis=-1)


def planar_mapping(p, vs=(1.0, 0.0, 0.0), vt=(0.0, 1.0, 0.0), ds=0.0, dt=0.0):
    """PlanarMapping2D::Map: st = (ds + p.vs, dt + p.vt)."""
    vs = jnp.asarray(vs, jnp.float32)
    vt = jnp.asarray(vt, jnp.float32)
    return jnp.stack(
        [ds + jnp.sum(p * vs, -1), dt + jnp.sum(p * vt, -1)], axis=-1
    )


def transform_mapping_3d(p, world_to_texture=None):
    """TransformMapping3D::Map: texture-space point for solid textures."""
    if world_to_texture is None:
        return p
    return _apply44(world_to_texture, p)


def _apply44(m, p):
    ph = jnp.matmul(p, m[:3, :3].T, precision=HIGHEST) + m[:3, 3]
    w = jnp.matmul(p, m[3, :3].T, precision=HIGHEST) + m[3, 3]
    return ph / w[..., None]


# ---------------------------------------------------------------------------
# Procedural texture evaluators (textures/ in the reference use these)
# ---------------------------------------------------------------------------

def fbm_texture(p, omega=0.5, octaves=8, world_to_texture=None):
    return fbm(transform_mapping_3d(p, world_to_texture), omega=omega,
               max_octaves=octaves)


def windy_texture(p, world_to_texture=None):
    """pbrt WindyTexture semantics: FBm(0.1p) strength * |FBm(p)| waves."""
    pt = transform_mapping_3d(p, world_to_texture)
    wind_strength = fbm(0.1 * pt, max_octaves=3)
    wave_height = fbm(pt, max_octaves=6)
    return jnp.abs(wind_strength) * wave_height


def marble_texture(p, scale=1.0, variation=0.2, omega=0.5, octaves=8):
    """pbrt MarbleTexture semantics: sin-warped FBm -> spline palette."""
    pt = scale * p
    marble = pt[..., 1] * scale + variation * fbm(pt, omega=omega,
                                                  max_octaves=octaves)
    t = 0.5 + 0.5 * jnp.sin(marble)
    # marble color spline (pbrt's 9-knot palette), evaluated as a lerp chain
    c = jnp.asarray([
        [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6],
        [0.5, 0.5, 0.5], [0.6, 0.59, 0.58], [0.58, 0.58, 0.6],
        [0.58, 0.58, 0.6], [0.2, 0.2, 0.33], [0.58, 0.58, 0.6],
    ], jnp.float32)
    nseg = c.shape[0] - 3
    first = jnp.clip((t * nseg).astype(jnp.int32), 0, nseg - 1)
    tt = t * nseg - first.astype(jnp.float32)
    c0 = c[first]
    c1 = c[first + 1]
    c2 = c[first + 2]
    c3 = c[first + 3]
    s0 = (1 - tt)[..., None] * c0 + tt[..., None] * c1
    s1 = (1 - tt)[..., None] * c1 + tt[..., None] * c2
    s2 = (1 - tt)[..., None] * c2 + tt[..., None] * c3
    s0 = (1 - tt)[..., None] * s0 + tt[..., None] * s1
    s1 = (1 - tt)[..., None] * s1 + tt[..., None] * s2
    return 1.5 * ((1 - tt)[..., None] * s0 + tt[..., None] * s1)
