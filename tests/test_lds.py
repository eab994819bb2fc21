"""Halton / radical-inverse tests against float64 oracles.

The radical inverse is an exact integer algorithm (reference
samplers/LowDiscrepancy.cpp:376-406); we verify our vectorized device code
against direct host evaluation, and the CRT pixel offsets against the
defining property: the first sample of pixel (x, y) lands in pixel (x, y).
"""

import numpy as np

from gnxraytracer.ops import lds, samplers


def radical_inverse_oracle(base, a):
    inv_base = 1.0 / base
    rev, inv_n = 0, 1.0
    while a:
        a, digit = divmod(a, base)
        rev = rev * base + digit
        inv_n *= inv_base
    return min(rev * inv_n, 1.0 - 1e-9)


def scrambled_oracle(base, a, perm):
    inv_base = 1.0 / base
    rev, inv_n = 0, 1.0
    while a:
        a, digit = divmod(a, base)
        rev = rev * base + int(perm[digit])
        inv_n *= inv_base
    return inv_n * (rev + inv_base * perm[0] / (1 - inv_base))


class TestRadicalInverse:
    def test_base2_bit_reversal(self):
        idx = np.array([0, 1, 2, 3, 4, 1023, 77777], np.uint32)
        got = np.asarray(lds.radical_inverse_base2(idx))
        want = [radical_inverse_oracle(2, int(a)) for a in idx]
        np.testing.assert_allclose(got, want, atol=1e-7)

    def test_general_base(self):
        for base in (3, 5, 7, 11):
            idx = np.array([0, 1, 5, 100, 12345, 999999], np.uint32)
            got = np.asarray(lds.radical_inverse(base, idx))
            want = [radical_inverse_oracle(base, int(a)) for a in idx]
            np.testing.assert_allclose(got, want, atol=1e-6)

    def test_scrambled(self):
        perms = lds.radical_inverse_permutations()
        sums = lds.prime_sums()
        primes = lds.primes()
        for dim in (2, 3, 10, 50):
            base = int(primes[dim])
            off = int(sums[dim])
            perm = perms[off: off + base]
            idx = np.array([0, 1, 7, 1234, 888888], np.uint32)
            got = np.asarray(
                lds.scrambled_radical_inverse(base, idx, perms, off)
            )
            want = [scrambled_oracle(base, int(a), perm) for a in idx]
            np.testing.assert_allclose(got, want, atol=1e-5)

    def test_static_matches_traced(self):
        perms = lds.radical_inverse_permutations()
        sums = lds.prime_sums()
        primes = lds.primes()
        idx = np.array([0, 1, 7, 1234, 888888, 2 ** 26], np.uint32)
        for dim in (2, 9, 77):
            base = int(primes[dim])
            off = int(sums[dim])
            a = np.asarray(lds.scrambled_radical_inverse(base, idx, perms, off))
            b = np.asarray(
                lds.scrambled_radical_inverse_static(base, idx, perms[off: off + base])
            )
            np.testing.assert_array_equal(a, b)
        for base in (3, 7, 31):
            a = np.asarray(lds.radical_inverse(base, idx))
            b = np.asarray(lds.radical_inverse_static(base, idx))
            np.testing.assert_array_equal(a, b)

    def test_permutations_are_permutations(self):
        perms = lds.radical_inverse_permutations()
        sums = lds.prime_sums()
        primes = lds.primes()
        for dim in (0, 1, 5, 999):
            base = int(primes[dim])
            off = int(sums[dim])
            perm = perms[off: off + base]
            assert sorted(perm.tolist()) == list(range(base))


class TestPCG32:
    def test_known_stream_properties(self):
        # Deterministic stream; check reproducibility and bounded output
        r1, r2 = lds.PCG32(), lds.PCG32()
        seq1 = [r1.uniform_u32() for _ in range(20)]
        seq2 = [r2.uniform_u32() for _ in range(20)]
        assert seq1 == seq2
        assert all(0 <= v < 2 ** 32 for v in seq1)
        b = lds.PCG32()
        vals = [b.uniform_u32_bounded(7) for _ in range(100)]
        assert all(0 <= v < 7 for v in vals)


class TestHaltonSampler:
    def test_first_sample_in_own_pixel(self):
        w, h = 16, 12
        s = samplers.make_halton_sampler(4, w, h)
        import jax.numpy as jnp

        pix = jnp.arange(w * h, dtype=jnp.int32)
        smp = jnp.zeros_like(pix)
        p_film, _, _ = samplers.camera_sample(s, pix, smp, w)
        p = np.asarray(p_film)
        px, py = np.asarray(pix) % w, np.asarray(pix) // w
        # Halton dims 0/1 jitter stays within [0,1): film point in own pixel
        assert np.all(p[:, 0] >= px) and np.all(p[:, 0] < px + 1)
        assert np.all(p[:, 1] >= py) and np.all(p[:, 1] < py + 1)

    def test_sample_dims_in_unit_interval(self):
        s = samplers.make_halton_sampler(8, 8, 8)
        import jax.numpy as jnp

        pix = jnp.arange(64, dtype=jnp.int32)
        for dim in (2, 5, 13):
            u = np.asarray(samplers.sample_dim(s, pix, jnp.ones_like(pix), dim))
            assert np.all((u >= 0) & (u < 1))

    def test_traced_dim_matches_static(self):
        import jax
        import jax.numpy as jnp

        s = samplers.make_halton_sampler(8, 8, 8)
        pix = jnp.arange(64, dtype=jnp.int32)
        smp = jnp.ones_like(pix)
        static = samplers.sample_dim(s, pix, smp, 7)
        traced = jax.jit(lambda d: samplers.sample_dim(s, pix, smp, d))(jnp.int32(7))
        np.testing.assert_allclose(np.asarray(static), np.asarray(traced), atol=0)

    def test_random_sampler_uniform(self):
        s = samplers.make_random_sampler(4)
        import jax.numpy as jnp

        pix = jnp.arange(100000, dtype=jnp.int32)
        u = np.asarray(samplers.sample_dim(s, pix, jnp.zeros_like(pix), 5))
        assert np.all((u >= 0) & (u < 1))
        assert abs(u.mean() - 0.5) < 5e-3
        assert abs(np.var(u) - 1 / 12) < 1e-3
