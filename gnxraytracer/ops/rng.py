"""Stateless, counter-based random numbers for wavefront rendering.

The reference uses a mutable PCG32 stream per pixel (/root/reference/core/RNG.h:30).
A wavefront needs a *stateless* generator: every (pixel, sample, dim)
triple maps to an independent uniform via integer hashing, so any lane can
draw any dimension without carried state.  We use a PCG-output-style integer
hash (per "Hash Functions for GPU Rendering", Jarzynski & Olano 2020 — public
algorithm) combined over the counter triple.
"""

import jax.numpy as jnp

from ..constants import ONE_MINUS_EPSILON


def _pcg_hash(x):
    """One round of a PCG-style 32-bit hash. x: uint32 array."""
    state = x * jnp.uint32(747796405) + jnp.uint32(2891336453)
    word = ((state >> ((state >> jnp.uint32(28)) + jnp.uint32(4))) ^ state) * jnp.uint32(277803737)
    return (word >> jnp.uint32(22)) ^ word


def hash_combine(*xs):
    """Hash an arbitrary tuple of uint32/int32 arrays into one uint32."""
    h = jnp.uint32(0x9E3779B9)
    for x in xs:
        h = _pcg_hash(h ^ jnp.asarray(x).astype(jnp.uint32))
    return h


def uniform_u32(pixel, sample, dim, seed=0):
    """uint32 uniform for a (pixel, sample, dim) counter triple."""
    return hash_combine(pixel, sample, dim, seed)


def uniform_float(pixel, sample, dim, seed=0):
    """float32 uniform in [0, 1) for a counter triple (broadcasting)."""
    u = uniform_u32(pixel, sample, dim, seed)
    # 24 high bits -> [0,1) exactly representable in float32
    f = (u >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
    return jnp.minimum(f, ONE_MINUS_EPSILON)


def uniform_float2(pixel, sample, dim, seed=0):
    """Two consecutive dims as an (..., 2) array."""
    return jnp.stack(
        [uniform_float(pixel, sample, dim, seed), uniform_float(pixel, sample, dim + 1, seed)],
        axis=-1,
    )
