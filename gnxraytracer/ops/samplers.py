"""Stateless wavefront samplers.

The reference's Sampler is a mutable per-pixel object with Get1D/Get2D
state (/root/reference/core/Sampler.h:14-94).  In a wavefront renderer the
sampler is a *pure function*  sample(pixel, sample_index, dim) -> u,  so any
lane of any bounce kernel can evaluate any dimension with no carried state.
Dimension assignment is static per bounce (see integrators), replacing the
reference's sequential dimension counter.

Kinds:
  * "random":  counter-based hash RNG (replaces ClockRandSampler,
               core/Sampler.h:107-123 — which is rand()-backed and
               non-reproducible; ours is deterministic by construction).
  * "halton":  scrambled Halton global sampler, pbrt semantics
               (samplers/HaltonSampler.cpp): dims 0-1 encode the pixel via
               CRT index offsets, dims >= 2 use digit-permuted radical
               inverse in the dim-th prime base.
"""

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import lds, rng


class Sampler(NamedTuple):
    """Pytree of device tables + static metadata for a sampler.

    For "halton": pixel_offset is the (H*W,) uint32 table of per-pixel
    first-sample Halton indices; stride/exponents per lds.halton_pixel_offsets.
    """
    kind: str  # static
    spp: int  # static
    seed: int  # static
    # halton tables (None for random)
    pixel_offset: Optional[jnp.ndarray] = None  # (H*W,) uint32
    primes: Optional[jnp.ndarray] = None  # (1000,) int32
    prime_sums: Optional[jnp.ndarray] = None  # (1000,) int32
    perms: Optional[jnp.ndarray] = None  # flat int32
    stride: int = 1
    exp2: int = 0
    scale3: int = 1


def _tree_flatten(s: Sampler):
    children = (s.pixel_offset, s.primes, s.prime_sums, s.perms)
    aux = (s.kind, s.spp, s.seed, s.stride, s.exp2, s.scale3)
    return children, aux


def _tree_unflatten(aux, children):
    kind, spp, seed, stride, exp2, scale3 = aux
    po, pr, ps, pe = children
    return Sampler(kind, spp, seed, po, pr, ps, pe, stride, exp2, scale3)


jax.tree_util.register_pytree_node(Sampler, _tree_flatten, _tree_unflatten)


def make_random_sampler(spp, seed=0):
    return Sampler(kind="random", spp=spp, seed=seed)


def make_sobol_sampler(spp, seed=0):
    """Owen-scrambled padded Sobol' sampler (ops/sobol.py): global index =
    sample number; each (pixel, dim) pair gets an independent Owen
    scramble, so pixels decorrelate without the reference's CRT index
    machinery.  Replaces the reference's unused Sobol table machinery
    (samplers/LowDiscrepancy.h:194-252) with a generated-matrix design."""
    from . import sobol as _sobol

    _sobol.sobol_matrices()  # build/cache host-side
    return Sampler(kind="sobol", spp=spp, seed=seed)


def make_halton_sampler(spp, width, height, seed=0):
    offsets, meta = lds.halton_pixel_offsets(width, height)
    return Sampler(
        kind="halton",
        spp=spp,
        seed=seed,
        pixel_offset=jnp.asarray(offsets.reshape(-1)),
        primes=jnp.asarray(lds.primes()),
        prime_sums=jnp.asarray(lds.prime_sums().astype(np.int32)),
        perms=jnp.asarray(lds.radical_inverse_permutations()),
        stride=meta["stride"],
        exp2=meta["exponents"][0],
        scale3=meta["scales"][1],
    )


def global_index(s: Sampler, pixel, sample):
    """Global sample index for (pixel, sample) lanes (uint32)."""
    if s.kind == "halton":
        return s.pixel_offset[pixel] + sample.astype(jnp.uint32) * jnp.uint32(s.stride)
    return sample.astype(jnp.uint32)


def sample_dim(s: Sampler, pixel, sample, dim):
    """Evaluate dimension `dim` (traced or static int) for each lane.

    pixel: (N,) int32 flat pixel ids; sample: (N,) int32 sample index.
    Returns (N,) float32 in [0, 1).
    """
    if s.kind == "random":
        return rng.uniform_float(pixel, sample, dim, s.seed)
    if s.kind == "sobol":
        from . import sobol as _sobol

        if not isinstance(dim, (int, np.integer)):
            raise ValueError("sobol sampler requires static dims; use "
                             "sample_all_dims in traced loops")
        v = _sobol.sobol_u32_static(int(dim), sample.astype(jnp.uint32))
        v = _sobol.owen_scramble(v, rng.hash_combine(pixel, int(dim), s.seed))
        return _sobol.to_unit_float(v)
    # halton
    idx = global_index(s, pixel, sample)

    def dim0():
        return lds.radical_inverse_base2(idx >> jnp.uint32(s.exp2))

    def dim1():
        return lds.radical_inverse(3, idx // jnp.uint32(s.scale3))

    def dim_hi():
        d = jnp.clip(jnp.asarray(dim, jnp.int32), 2, 999)
        base = s.primes[d]
        off = s.prime_sums[d]
        return lds.scrambled_radical_inverse(base, idx, s.perms, off)

    if isinstance(dim, (int, np.integer)):
        # static dim: pick the branch at trace time
        return (dim0, dim1)[dim]() if dim < 2 else dim_hi()
    # dim traced inside the bounce loop: switch on min(dim, 2)
    branch = jnp.minimum(jnp.asarray(dim, jnp.int32), 2)
    return jax.lax.switch(branch, [dim0, dim1, dim_hi])


def sample_2d(s: Sampler, pixel, sample, dim):
    return jnp.stack(
        [sample_dim(s, pixel, sample, dim), sample_dim(s, pixel, sample, dim + 1)],
        axis=-1,
    )


def sample_all_dims(s: Sampler, pixel, sample, n_dims: int):
    """Precompute ALL dimensions for a wavefront as one (N, n_dims) array.

    This is the fast path: every column has a *static* dim, so Halton
    uses static-base digit loops (4-18 iterations) and tiny static
    permutation slices instead of traced-base loops gathering from the
    3.7M-entry flat table inside the bounce loop.  Integrators slice
    per-bounce dims out with lax.dynamic_slice.
    """
    if s.kind == "random":
        dims = jnp.arange(n_dims, dtype=jnp.int32)[None, :]
        return rng.uniform_float(pixel[:, None], sample[:, None], dims, s.seed)
    if s.kind == "sobol":
        from . import sobol as _sobol

        # all dims at once: 32 XOR-select steps over an (N, D) block
        mats = jnp.asarray(_sobol.sobol_matrices()[:n_dims])  # (D, 32)
        idx = sample.astype(jnp.uint32)
        v = jnp.zeros((pixel.shape[0], n_dims), jnp.uint32)
        for k in range(_sobol.N_BITS):
            bit = (idx >> jnp.uint32(k)) & jnp.uint32(1)
            v = jnp.where((bit == 1)[:, None], v ^ mats[None, :, k], v)
        dims = jnp.arange(n_dims, dtype=jnp.int32)
        seeds = rng.hash_combine(pixel[:, None], dims[None, :], s.seed)
        return _sobol.to_unit_float(_sobol.owen_scramble(v, seeds))
    # halton
    idx = global_index(s, pixel, sample)
    host_primes = lds.primes()
    host_sums = lds.prime_sums()
    host_perms = lds.radical_inverse_permutations()
    cols = [
        lds.radical_inverse_base2(idx >> jnp.uint32(s.exp2)),
        lds.radical_inverse_static(3, idx // jnp.uint32(s.scale3)),
    ]
    for d in range(2, n_dims):
        base = int(host_primes[d])
        off = int(host_sums[d])
        perm = host_perms[off: off + base]
        cols.append(lds.scrambled_radical_inverse_static(base, idx, perm))
    return jnp.stack(cols[:n_dims], axis=-1)


def supports_inloop_dims(s: Sampler) -> bool:
    """True when per-bounce dims can be computed inside the traced bounce
    loop with a *traced* starting dim (sobol/random: the dim only selects a
    row of a tiny table / feeds a hash).  Halton needs static prime bases
    per dim, so it precomputes the full (N, D) matrix instead."""
    return s.kind in ("sobol", "random")


def sample_bounce_dims(s: Sampler, pixel, sample, base, k: int, max_dims: int):
    """Compute k consecutive dims starting at traced scalar dim `base` for
    every lane: the in-loop alternative to slicing a precomputed (N, D)
    sample matrix, which costs an (N, D) f32 device-memory round-trip per
    wavefront
    (~300 MB at the 1M-lane bench).  Same bit-exact values as
    sample_all_dims(...)[:, base:base+k]."""
    dims = base + jnp.arange(k, dtype=jnp.int32)
    if s.kind == "random":
        return rng.uniform_float(pixel[:, None], sample[:, None],
                                 dims[None, :], s.seed)
    if s.kind == "sobol":
        from . import sobol as _sobol

        mats_all = jnp.asarray(_sobol.sobol_matrices()[:max_dims])  # (D, 32)
        mats = jax.lax.dynamic_slice(
            mats_all, (jnp.asarray(base, jnp.int32), jnp.int32(0)),
            (k, _sobol.N_BITS))  # (k, 32)
        idx = sample.astype(jnp.uint32)
        v = jnp.zeros((pixel.shape[0], k), jnp.uint32)
        for kb in range(_sobol.N_BITS):
            bit = (idx >> jnp.uint32(kb)) & jnp.uint32(1)
            v = jnp.where((bit == 1)[:, None], v ^ mats[None, :, kb], v)
        seeds = rng.hash_combine(pixel[:, None], dims[None, :], s.seed)
        return _sobol.to_unit_float(_sobol.owen_scramble(v, seeds))
    raise ValueError(f"in-loop dims unsupported for sampler kind {s.kind!r}")


def static_dim_fn(s: Sampler, pixel, sample):
    """Return col(d) evaluating STATIC dimension d for every lane via the
    cheapest path for the sampler kind.  For halton this is the host-table
    static-base digit loop (same values as sample_all_dims' columns);
    sample_dim's generic halton path for dims >= 2 runs a traced-base
    32-iteration loop gathering from the 3.7M-entry device permutation
    table per digit, a much slower pattern."""
    if s.kind != "halton":
        return lambda d: sample_dim(s, pixel, sample, d)
    host_primes = lds.primes()
    host_sums = lds.prime_sums()
    host_perms = lds.radical_inverse_permutations()
    idx = global_index(s, pixel, sample)

    def col(d):
        if d == 0:
            return lds.radical_inverse_base2(idx >> jnp.uint32(s.exp2))
        if d == 1:
            return lds.radical_inverse_static(3, idx // jnp.uint32(s.scale3))
        base = int(host_primes[d])
        off = int(host_sums[d])
        return lds.scrambled_radical_inverse_static(
            base, idx, host_perms[off: off + base])
    return col


def camera_sample(s: Sampler, pixel, sample, width, pixel_filter="box",
                  filter_radius=2.0, filter_alpha=2.0):
    """CameraSample per reference GetCameraSample (core/Sampler.cpp:14-20):
    dims 0-1 film jitter, dim 2 time, dims 3-4 lens.

    pixel_filter "box" (reference behavior — uniform jitter in the pixel)
    or "gaussian": filter-importance-sampled truncated Gaussian around the
    pixel center, realizing the reference's (never-instantiated)
    GaussianFilter e^{-alpha d^2} (filters/GaussianFilter.cpp:8) with
    constant weight 1 — no splatting needed in a wavefront film.

    Returns (p_film (N,2) raster coords, time (N,), p_lens (N,2)).
    """
    px = (pixel % width).astype(jnp.float32)
    py = (pixel // width).astype(jnp.float32)
    col = static_dim_fn(s, pixel, sample)
    jitter = jnp.stack([col(0), col(1)], axis=-1)
    if pixel_filter == "gaussian":
        from jax.scipy.special import erfinv

        sigma = 1.0 / jnp.sqrt(2.0 * filter_alpha)
        r = filter_radius
        # inverse-CDF sampling of the truncated normal on [-r, r]
        lo = jax.scipy.stats.norm.cdf(-r / sigma)
        hi = jax.scipy.stats.norm.cdf(r / sigma)
        u = lo + jitter * (hi - lo)
        offset = sigma * jnp.sqrt(2.0) * erfinv(2.0 * u - 1.0)
        jitter = 0.5 + offset
    p_film = jnp.stack([px, py], axis=-1) + jitter
    time = col(2)
    p_lens = jnp.stack([col(3), col(4)], axis=-1)
    return p_film, time, p_lens
