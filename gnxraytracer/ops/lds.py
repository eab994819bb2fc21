"""Low-discrepancy sequences: vectorized Halton with scrambled radical inverse.

Wavefront re-design of the reference Halton machinery
(/root/reference/samplers/HaltonSampler.cpp:33-94,
 /root/reference/samplers/LowDiscrepancy.cpp:376-406,2459-2473):

  * Digit permutations are generated host-side, once, with an exact PCG32
    replica of the reference's default RNG stream (core/RNG.h:26-57), so the
    permutation tables are bit-identical to the reference's.
  * The per-sample radical inverse becomes a fixed-trip-count digit loop,
    vectorized over an entire ray wavefront (the digit loop is
    data-independent and unrolls fine).
  * The pixel -> first-sample-index offset (CRT with multiplicative
    inverses, HaltonSampler.cpp:63-83) is precomputed for the whole film as
    an (H, W) uint32 array at scene build time.

Everything on device is uint32; sample indices must stay below 2**27 so the
scrambled digit accumulator cannot overflow (spp <= 4096 at the 128x243
maximum stride satisfies this).
"""

import functools

import jax.numpy as jnp
import numpy as np

from ..constants import ONE_MINUS_EPSILON

K_MAX_RESOLUTION = 128  # HaltonSampler.cpp kMaxResolution
MAX_DIGITS = 32


# ---------------------------------------------------------------------------
# Host-side tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def primes(n=1000):
    """First n primes (reference Primes table, LowDiscrepancy.cpp)."""
    out = []
    candidate = 2
    while len(out) < n:
        if all(candidate % p for p in out if p * p <= candidate):
            out.append(candidate)
        candidate += 1
    return np.array(out, dtype=np.int32)


@functools.lru_cache(maxsize=1)
def prime_sums(n=1000):
    """Exclusive prefix sums of the primes (PrimeSums table)."""
    p = primes(n)
    return np.concatenate([[0], np.cumsum(p)[:-1]]).astype(np.int64)


class PCG32:
    """Exact replica of the reference PCG32 (core/RNG.h) for host-side
    permutation generation.  Must match bit-for-bit so our scrambled Halton
    stream equals the reference's."""

    MULT = 0x5851F42D4C957F2D
    DEFAULT_STATE = 0x853C49E6748FEA9B
    DEFAULT_STREAM = 0xDA3E39CB94B95BDB
    MASK64 = (1 << 64) - 1

    def __init__(self):
        self.state = self.DEFAULT_STATE
        self.inc = self.DEFAULT_STREAM

    def uniform_u32(self):
        oldstate = self.state
        self.state = (oldstate * self.MULT + self.inc) & self.MASK64
        xorshifted = (((oldstate >> 18) ^ oldstate) >> 27) & 0xFFFFFFFF
        rot = oldstate >> 59
        return ((xorshifted >> rot) | (xorshifted << ((~rot + 1) & 31))) & 0xFFFFFFFF

    def uniform_u32_bounded(self, b):
        threshold = (0x100000000 - b) % b
        while True:
            r = self.uniform_u32()
            if r >= threshold:
                return r % b


@functools.lru_cache(maxsize=1)
def radical_inverse_permutations():
    """Flat per-prime digit permutation table, bit-identical to
    ComputeRadicalInversePermutations (LowDiscrepancy.cpp:2459) with the
    default-seeded PCG32 + Shuffle (core/Sampling.h:130).

    The table is deterministic, so it is cached on disk after first build.
    """
    import os

    cache = os.path.join(os.path.dirname(__file__), "..", "..", ".cache")
    path = os.path.join(cache, "halton_perms_v1.npy")
    if os.path.exists(path):
        return np.load(path)
    from ..native import halton_permutations as native_perms

    perms = native_perms(primes())
    if perms is not None:
        os.makedirs(cache, exist_ok=True)
        # write beside the target and rename: concurrent workers may race
        tmp = f"{path}.{os.getpid()}.npy"
        np.save(tmp, perms)
        os.replace(tmp, path)
        return perms
    p = primes()
    sums = prime_sums()
    total = int(p.astype(np.int64).sum())
    perms = np.zeros(total, dtype=np.int32)
    rng = PCG32()
    for i in range(len(p)):
        n = int(p[i])
        arr = np.arange(n, dtype=np.int32)
        # Reference Shuffle: for i in range(count): swap(i, i + rng(count - i))
        for j in range(n):
            other = j + rng.uniform_u32_bounded(n - j)
            arr[j], arr[other] = arr[other], arr[j]
        perms[sums[i]: sums[i] + n] = arr
    os.makedirs(cache, exist_ok=True)
    np.save(path, perms)
    return perms


def _mult_inverse(a, n):
    """Multiplicative inverse of a mod n (HaltonSampler.cpp:13-29)."""
    def ext_gcd(a, b):
        if b == 0:
            return 1, 0
        xp, yp = ext_gcd(b, a % b)
        d = a // b
        return yp, xp - d * yp
    x, _ = ext_gcd(a, n)
    return x % n


def halton_pixel_offsets(width, height, spp_log2_unused=None):
    """(H, W) uint32 array of first-sample Halton indices per pixel.

    Mirrors HaltonSampler::GetIndexForSample's per-pixel offset computation
    (HaltonSampler.cpp:63-83): CRT over base-2/base-3 scales covering
    min(res, 128).
    """
    scales, exps = [], []
    for i, base in enumerate((2, 3)):
        res = (width, height)[i]
        scale, e = 1, 0
        while scale < min(res, K_MAX_RESOLUTION):
            scale *= base
            e += 1
        scales.append(scale)
        exps.append(e)
    stride = scales[0] * scales[1]
    mult_inv = [_mult_inverse(scales[1], scales[0]), _mult_inverse(scales[0], scales[1])]

    def inverse_radical_inverse(base, inverse, n_digits):
        index = np.zeros_like(inverse)
        for _ in range(n_digits):
            digit = inverse % base
            inverse = inverse // base
            index = index * base + digit
        return index

    xs = np.arange(width, dtype=np.int64) % K_MAX_RESOLUTION
    ys = np.arange(height, dtype=np.int64) % K_MAX_RESOLUTION
    dim_off_x = inverse_radical_inverse(2, xs, exps[0])  # (W,)
    dim_off_y = inverse_radical_inverse(3, ys, exps[1])  # (H,)
    off = (
        dim_off_x[None, :] * (stride // scales[0]) * mult_inv[0]
        + dim_off_y[:, None] * (stride // scales[1]) * mult_inv[1]
    ) % stride
    meta = dict(stride=stride, scales=tuple(scales), exponents=tuple(exps))
    return off.astype(np.uint32), meta


# ---------------------------------------------------------------------------
# Device-side sample evaluation
# ---------------------------------------------------------------------------

def reverse_bits_32(n):
    n = (n << jnp.uint32(16)) | (n >> jnp.uint32(16))
    n = ((n & jnp.uint32(0x00FF00FF)) << jnp.uint32(8)) | ((n & jnp.uint32(0xFF00FF00)) >> jnp.uint32(8))
    n = ((n & jnp.uint32(0x0F0F0F0F)) << jnp.uint32(4)) | ((n & jnp.uint32(0xF0F0F0F0)) >> jnp.uint32(4))
    n = ((n & jnp.uint32(0x33333333)) << jnp.uint32(2)) | ((n & jnp.uint32(0xCCCCCCCC)) >> jnp.uint32(2))
    n = ((n & jnp.uint32(0x55555555)) << jnp.uint32(1)) | ((n & jnp.uint32(0xAAAAAAAA)) >> jnp.uint32(1))
    return n


def radical_inverse_base2(a):
    """Base-2 radical inverse of uint32 a (the reference uses uint64; our
    indices fit 32 bits so bit-reversal at 32 bits, scaled by 2^-32)."""
    a = jnp.asarray(a).astype(jnp.uint32)
    rev = reverse_bits_32(a)
    return jnp.minimum(rev.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10),
                       ONE_MINUS_EPSILON)


def radical_inverse(base, a):
    """General-base radical inverse; `base` may be a traced int array.

    Fixed 32-iteration digit loop with masked updates — data-independent
    control flow that vectorizes across the wavefront.
    """
    import jax

    a = jnp.asarray(a).astype(jnp.uint32)
    base = jnp.asarray(base).astype(jnp.uint32)
    inv_base = 1.0 / base.astype(jnp.float32)
    shape = jnp.broadcast_shapes(a.shape, base.shape)

    def step(_, carry):
        a, rev, ibn = carry
        active = a > 0
        nxt = a // base
        digit = a - nxt * base
        rev = jnp.where(active, rev * base + digit, rev)
        ibn = jnp.where(active, ibn * inv_base, ibn)
        return nxt, rev, ibn

    _, reversed_digits, inv_base_n = jax.lax.fori_loop(
        0, MAX_DIGITS, step,
        (a, jnp.zeros_like(a), jnp.ones(shape, jnp.float32)),
    )
    return jnp.minimum(reversed_digits.astype(jnp.float32) * inv_base_n, ONE_MINUS_EPSILON)


def radical_inverse_static(base: int, a):
    """Radical inverse with a *static* (python int) base: the digit loop
    unrolls to exactly ceil(32 / log2(base)) iterations — e.g. 4 for base
    389 vs the generic 32 — and involves no tables.  This is the fast
    path; generic traced-base versions remain for dynamic dims."""
    a = jnp.asarray(a).astype(jnp.uint32)
    n_digits = int(np.ceil(32.0 / np.log2(base)))
    inv_base = np.float32(1.0 / base)
    rev = jnp.zeros_like(a)
    ibn = jnp.ones(a.shape, jnp.float32)
    for _ in range(n_digits):
        active = a > 0
        nxt = a // base
        digit = a - nxt * base
        rev = jnp.where(active, rev * base + digit, rev)
        ibn = jnp.where(active, ibn * inv_base, ibn)
        a = nxt
    return jnp.minimum(rev.astype(jnp.float32) * ibn, ONE_MINUS_EPSILON)


def scrambled_radical_inverse_static(base: int, a, perm):
    """Scrambled radical inverse with static base and its (base,) perm
    slice.  The digit permutation becomes a gather into a tiny table
    (or a one-hot select), not into the 3.7M flat table."""
    a = jnp.asarray(a).astype(jnp.uint32)
    perm = jnp.asarray(perm).astype(jnp.uint32)
    n_digits = int(np.ceil(32.0 / np.log2(base)))
    inv_base = np.float32(1.0 / base)
    rev = jnp.zeros_like(a)
    ibn = jnp.ones(a.shape, jnp.float32)
    for _ in range(n_digits):
        active = a > 0
        nxt = a // base
        digit = a - nxt * base
        pdigit = perm[digit]
        rev = jnp.where(active, rev * base + pdigit, rev)
        ibn = jnp.where(active, ibn * inv_base, ibn)
        a = nxt
    perm0 = perm[0].astype(jnp.float32)
    tail = inv_base * perm0 / (1.0 - inv_base)
    return jnp.minimum(ibn * (rev.astype(jnp.float32) + tail), ONE_MINUS_EPSILON)


def scrambled_radical_inverse(base, a, perm_table, perm_offset):
    """ScrambledRadicalInverse (LowDiscrepancy.cpp:376-393), vectorized.

    perm_table:  flat int32 device array of all digit permutations
    perm_offset: offset of this base's permutation (PrimeSums[dim])
    """
    import jax

    a = jnp.asarray(a).astype(jnp.uint32)
    base = jnp.asarray(base).astype(jnp.uint32)
    perm_table = jnp.asarray(perm_table)
    perm_offset = jnp.asarray(perm_offset).astype(jnp.int32)
    inv_base = 1.0 / base.astype(jnp.float32)
    shape = jnp.broadcast_shapes(a.shape, base.shape)

    def step(_, carry):
        a, rev, ibn = carry
        active = a > 0
        nxt = a // base
        digit = a - nxt * base
        pdigit = perm_table[perm_offset + digit.astype(jnp.int32)].astype(jnp.uint32)
        rev = jnp.where(active, rev * base + pdigit, rev)
        ibn = jnp.where(active, ibn * inv_base, ibn)
        return nxt, rev, ibn

    _, reversed_digits, inv_base_n = jax.lax.fori_loop(
        0, MAX_DIGITS, step,
        (a, jnp.zeros_like(a), jnp.ones(shape, jnp.float32)),
    )
    perm0 = perm_table[perm_offset].astype(jnp.float32)
    tail = inv_base * perm0 / (1.0 - inv_base)
    return jnp.minimum(inv_base_n * (reversed_digits.astype(jnp.float32) + tail),
                       ONE_MINUS_EPSILON)
