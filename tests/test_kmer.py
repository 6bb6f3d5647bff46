"""Codec tests mirroring the reference's deterministic cases
(reference: test/kmer.cc:8-34) plus randomized closed-form checks."""

import numpy as np
import pytest

from kmerset_tpu.core import kmer as kc


def test_string_round_trip():
    s = "AGCTG"
    assert kc.kmer_to_string(kc.string_to_kmer(s), 5) == s


def test_complement():
    # Reference example: complement of "AACCG" is "CGGTT" (kmer.h:102).
    x = kc.string_to_kmer("AACCG")
    assert kc.kmer_to_string(int(kc.reverse_complement(np.int64(x), 5)), 5) == "CGGTT"


def test_canonical():
    x = kc.string_to_kmer("AGCTG")
    rc = int(kc.reverse_complement(np.int64(x), 5))
    assert int(kc.canonical(np.int64(x), 5)) == min(x, rc)


def test_next_prev():
    x = kc.string_to_kmer("AGCTG")
    nxt = int(kc.next_kmer(np.int64(x), 5, kc.string_to_codes("T")[0]))
    assert kc.kmer_to_string(nxt, 5) == "GCTGT"
    prv = int(kc.prev_kmer(np.int64(x), 5, kc.string_to_codes("T")[0]))
    assert kc.kmer_to_string(prv, 5) == "TAGCT"


@pytest.mark.parametrize("k", [3, 9, 15, 19, 23, 31])
def test_revcomp_random(k):
    rng = np.random.default_rng(0)
    kmers = rng.integers(0, 1 << (2 * k), size=1000, dtype=np.int64)
    rc = kc.reverse_complement(kmers, k)
    # Involution.
    np.testing.assert_array_equal(kc.reverse_complement(rc, k), kmers)
    # Matches per-base definition on a few samples.
    for x in kmers[:20]:
        s = kc.kmer_to_string(int(x), k)
        expected = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        assert kc.kmer_to_string(int(kc.reverse_complement(np.int64(x), k)), k) == expected


@pytest.mark.parametrize("k", [3, 9, 23])
def test_next_prev_random(k):
    rng = np.random.default_rng(1)
    kmers = rng.integers(0, 1 << (2 * k), size=200, dtype=np.int64)
    for c in range(4):
        nxt = kc.next_kmer(kmers, k, c)
        prv = kc.prev_kmer(kmers, k, c)
        for x, n, p in zip(kmers[:10], nxt[:10], prv[:10]):
            s = kc.kmer_to_string(int(x), k)
            assert kc.kmer_to_string(int(n), k) == s[1:] + "ACGT"[c]
            assert kc.kmer_to_string(int(p), k) == "ACGT"[c] + s[:-1]


def test_windows():
    codes = kc.string_to_codes("ACGTAC")
    kmers = kc.kmers_from_codes(codes, 3)
    assert [kc.kmer_to_string(int(x), 3) for x in kmers] == [
        "ACG", "CGT", "GTA", "TAC",
    ]


def test_bucket_key_inverse():
    # Reference: test/kmer_set.cc:10-23.
    rng = np.random.default_rng(2)
    k, n = 15, 14
    key_bits = 2 * k - n
    kmers = rng.integers(0, 1 << (2 * k), size=1000, dtype=np.int64)
    bucket, key = kc.bucket_and_key(kmers, key_bits)
    assert int(bucket.max()) < (1 << n)
    assert int(key.max()) < (1 << key_bits)
    np.testing.assert_array_equal(
        kc.kmer_from_bucket_and_key(bucket, key, key_bits), kmers
    )


def test_sorted_unique_helpers():
    from kmerset_tpu.core.arrays import sorted_unique, sorted_unique_counts

    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 5000):
        x = rng.integers(0, 300, n).astype(np.int64)
        np.testing.assert_array_equal(sorted_unique(x), np.unique(x))
        u, c = sorted_unique_counts(x)
        eu, ec = np.unique(x, return_counts=True)
        np.testing.assert_array_equal(u, eu)
        np.testing.assert_array_equal(c, ec)


@pytest.mark.parametrize("k", [7, 9, 15, 19, 23])
def test_plain_pack_matches_host_canonical(k):
    """The device window pack (ops/count.py: _single_windows for k <= 15,
    the (hi, lo) _pair_windows above) equals the host codec's canonical
    k-mer of every window, on an input longer than 2^17 bases so the
    log-doubling rolls wrap across a large array."""
    import jax

    from kmerset_tpu.ops import count as count_mod

    rng = np.random.default_rng(40 + k)
    codes = rng.integers(0, 4, size=(1 << 17) + 333).astype(np.int32)
    n = codes.shape[0] - k + 1
    exp = kc.canonical(kc.kmers_from_codes(codes.astype(np.int64), k), k)
    if k <= count_mod.SINGLE_MAX_K:
        got = np.asarray(
            jax.jit(count_mod._single_windows, static_argnums=(1, 2))(codes, k, True)
        ).astype(np.int64)
    else:
        hi, lo = jax.jit(count_mod._pair_windows, static_argnums=(1, 2))(codes, k, True)
        klo = k - (k + 1) // 2
        got = (np.asarray(hi).astype(np.int64) << (2 * klo)) | np.asarray(lo)
    np.testing.assert_array_equal(got[:n], exp[:n])


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [9, 15, 19, 23])
def test_packed_window_keys_match_unpacked(k, canonical):
    """The count programs' window keys of 2-bit packed codes (_unpack2,
    then _window_keys, as count_kmers_frag runs them) equal the keys of
    the unpacked codes, with a length that is not a multiple of four."""
    import jax
    import jax.numpy as jnp

    from kmerset_tpu.ops import count as count_mod

    rng = np.random.default_rng(70 + k)
    codes = rng.integers(0, 4, size=2077 + k - 1).astype(np.uint8)
    packed = np.zeros((codes.size + 3) // 4, np.uint8)
    for s in range(4):
        part = codes[s::4]
        packed[: part.size] |= part << (2 * s)
    got = jax.jit(
        lambda p: count_mod._window_keys(count_mod._unpack2(p, codes.size), k, canonical)
    )(jnp.asarray(packed))
    exp = count_mod._window_keys(jnp.asarray(codes.astype(np.int32)), k, canonical)
    if k <= count_mod.SINGLE_MAX_K:
        got, exp = (got,), (exp,)
    n = codes.size - (k - 1)
    for g, e in zip(got, exp):
        np.testing.assert_array_equal(np.asarray(g)[:n], np.asarray(e)[:n])
