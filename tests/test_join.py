"""Sort-join lookup and device side-table tests (vs host reference)."""

import numpy as np
import pytest

pytest.importorskip("jax")

from kmerset_tpu.core import spss  # noqa: E402
from kmerset_tpu.ops.join import intersection_count, lookup_join  # noqa: E402
from kmerset_tpu.ops.neighbors import device_side_tables  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_lookup_join_matches_searchsorted(seed, dtype):
    rng = np.random.default_rng(seed)
    A = np.unique(rng.integers(0, 1 << 20, 500)).astype(dtype)
    Q = rng.integers(0, 1 << 20, 1024).astype(dtype)
    found, idx = lookup_join(A, Q, n_groups=2)
    found = np.asarray(found).reshape(-1)
    idx = np.asarray(idx).reshape(-1)
    pos = np.searchsorted(A, Q)
    posc = np.minimum(pos, A.shape[0] - 1)
    exp_found = A[posc] == Q
    np.testing.assert_array_equal(found, exp_found)
    np.testing.assert_array_equal(idx[exp_found], posc[exp_found])


def test_lookup_join_with_sentinel_padding():
    A = np.array([3, 7, 9, 1 << 62, 1 << 62], dtype=np.int64)
    Q = np.array([7, 8, 3, 9], dtype=np.int64)
    found, idx = lookup_join(A, Q)
    np.testing.assert_array_equal(np.asarray(found)[0], [True, False, True, True])
    np.testing.assert_array_equal(np.asarray(idx)[0][[0, 2, 3]], [1, 0, 2])


@pytest.mark.parametrize("seed", [0, 5])
def test_intersection_count(seed):
    rng = np.random.default_rng(seed)
    A = np.unique(rng.integers(0, 3000, 800)).astype(np.int64)
    B = np.unique(rng.integers(0, 3000, 800)).astype(np.int64)
    assert int(intersection_count(A, B)) == np.intersect1d(A, B).size


@pytest.mark.parametrize("k", [9, 15, 19, 23])
@pytest.mark.parametrize("canonical", [True, False])
def test_device_side_tables_match_host(k, canonical):
    from kmerset_tpu.core import kmer as kc

    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 4000).astype(np.int64)
    w = kc.kmers_from_codes(codes, k)
    if canonical:
        w = kc.canonical(w, k)
    A = np.unique(w)
    dev = device_side_tables(A, k, canonical)
    assert dev is not None
    (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = dev
    if canonical:
        hr = spss._side_table_canonical(A, k, right=True)
        hl = spss._side_table_canonical(A, k, right=False)
    else:
        hr = spss._side_table_plain(A, k, right=True) + (np.zeros(A.size, bool),)
        hl = spss._side_table_plain(A, k, right=False) + (np.zeros(A.size, bool),)
    np.testing.assert_array_equal(rdeg, hr[0])
    np.testing.assert_array_equal(ldeg, hl[0])
    # nbr/same only meaningful where an edge exists and deg-order agrees on
    # the unique first neighbor when deg == 1.
    m = hr[0] == 1
    np.testing.assert_array_equal(rnbr[m], hr[1][m])
    ml = hl[0] == 1
    np.testing.assert_array_equal(lnbr[ml], hl[1][ml])
    if canonical:
        np.testing.assert_array_equal(rsame[m], hr[2][m])
        np.testing.assert_array_equal(lsame[ml], hl[2][ml])


@pytest.mark.parametrize("k", [9, 15, 19, 23])
def test_device_unitig_succ_matches_host(k, monkeypatch):
    """The fused device successor front-end must reproduce the host
    terminal/successor construction, and the full unitig build must be
    set-identical either way."""
    from kmerset_tpu.core.kmer_set import KmerSet
    from kmerset_tpu.ops.unitigs import device_unitig_succ

    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 6000).astype(np.int64)
    from kmerset_tpu.core import kmer as kc

    A = np.unique(kc.canonical(kc.kmers_from_codes(codes, k), k))
    dev = device_unitig_succ(A, k)
    assert dev is not None
    succ_d, term_l_d, term_r_d, both_d = dev

    (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = spss._side_tables(A, k, True)
    mate_r = np.where(rsame, rdeg[rnbr], ldeg[rnbr])
    term_r = (rdeg != 1) | (mate_r != 1)
    mate_l = np.where(lsame, ldeg[lnbr], rdeg[lnbr])
    term_l = (ldeg != 1) | (mate_l != 1)
    succ = np.empty(2 * A.size, dtype=np.int64)
    succ[0::2] = np.where(term_r, -1, 2 * rnbr + rsame)
    succ[1::2] = np.where(term_l, -1, 2 * lnbr + (~lsame).astype(np.int64))

    np.testing.assert_array_equal(term_r_d, term_r)
    np.testing.assert_array_equal(term_l_d, term_l)
    np.testing.assert_array_equal(both_d, term_l & term_r)
    np.testing.assert_array_equal(succ_d, succ)

    # End-to-end: unitig sets identical whichever front-end ran.
    ks = KmerSet(k, A, _sorted=True)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "device")
    u_dev = spss.get_unitigs_canonical(ks)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    u_host = spss.get_unitigs_canonical(ks)
    rt_d = spss.get_kmer_set_from_spss(u_dev, k, True)
    rt_h = spss.get_kmer_set_from_spss(u_host, k, True)
    np.testing.assert_array_equal(rt_d.kmers, rt_h.kmers)
    np.testing.assert_array_equal(rt_d.kmers, A)


@pytest.mark.parametrize("layout", ["single", "pair"])
@pytest.mark.parametrize("frac", [0.0, 0.05, 0.5, 1.0])
def test_compact_runs_matches_numpy_selection(frac, layout):
    """The count path's compaction (ops/count.py _compact_runs: the
    selection flag fused into the leading sort key) equals boolean-mask
    selection of the sorted keys, in the single int32 and the (hi, lo)
    pair layouts, carrying an extra lane along; the tail is SENTINEL/0."""
    import jax.numpy as jnp

    from kmerset_tpu.ops.count import _HI_SENT, _S_SENT, SENTINEL, _compact_runs

    rng = np.random.default_rng(int(frac * 100) + (3 if layout == "single" else 7))
    n = 5000
    if layout == "single":
        keys64 = np.unique(rng.integers(0, 1 << 30, n - 100))
        m = keys64.size
        lanes = [np.full(n, _S_SENT, np.int32)]
        lanes[0][:m] = keys64

        def to64(ks):
            return ks[0].astype(jnp.int64)
    else:
        klo = 11  # k = 23: 24-bit hi, 22-bit lo
        keys64 = np.unique(rng.integers(0, 1 << 46, n - 100))
        m = keys64.size
        lanes = [np.full(n, _HI_SENT, np.int32), np.zeros(n, np.int32)]
        lanes[0][:m] = keys64 >> (2 * klo)
        lanes[1][:m] = keys64 & ((1 << (2 * klo)) - 1)

        def to64(ks):
            return (ks[0].astype(jnp.int64) << (2 * klo)) | ks[1].astype(jnp.int64)

    live = np.arange(n) < m
    select = live & (rng.random(n) < frac)
    extra = rng.integers(0, 1000, n).astype(np.int32)
    uniq, (cx,), n_sel = _compact_runs(
        to64, tuple(jnp.asarray(x) for x in lanes), jnp.asarray(select),
        (jnp.asarray(extra),),
    )
    ns = int(n_sel)
    assert ns == int(select.sum())
    uniq, cx = np.asarray(uniq), np.asarray(cx)
    np.testing.assert_array_equal(uniq[:ns], keys64[select[:m]])
    assert (uniq[ns:] == SENTINEL).all()
    np.testing.assert_array_equal(cx[:ns], extra[select])
    assert (cx[ns:] == 0).all()


def test_lookup_join32_matches_int64():
    """The fused-tag int32 join (ops/join.py lookup_join32) agrees with
    the generic path, including keys adjacent to the PAD32 sentinel."""
    import jax.numpy as jnp

    from kmerset_tpu.ops.join import lookup_join, lookup_join32

    rng = np.random.default_rng(9)
    A = np.unique(rng.integers(0, (1 << 30) - 1, 4096)).astype(np.int32)
    A = np.unique(np.concatenate([A, np.int32([(1 << 30) - 2, 0])]))
    Q = np.concatenate(
        [
            rng.integers(0, (1 << 30) - 1, 8192).astype(np.int32),
            A[rng.integers(0, A.shape[0], 512)],  # guaranteed hits
        ]
    )
    f64, i64 = lookup_join(jnp.asarray(A.astype(np.int64)), jnp.asarray(Q.astype(np.int64)), n_groups=1)
    f32, i32 = lookup_join32(jnp.asarray(A), jnp.asarray(Q), n_groups=1)
    np.testing.assert_array_equal(np.asarray(f64), np.asarray(f32))
    np.testing.assert_array_equal(
        np.asarray(i64)[np.asarray(f64)], np.asarray(i32)[np.asarray(f32)]
    )
