"""Tests for API surface found uncovered by the sys.monitoring line
collector (tests/_covplugin.py + benchmarks/cov_report.py) — parity
helpers, fixture generators, and device-oracle update paths that the
main suites exercise only indirectly or in subprocesses."""

import os

import numpy as np
import pytest

from kmerset_tpu.core import kmer as kc
from kmerset_tpu.core import native
from kmerset_tpu.core.config import get_config
from kmerset_tpu.core.kmer_set import KmerSet
from kmerset_tpu.core.strings import PackedStrings, complement_codes
from kmerset_tpu.utils import io as uio
from kmerset_tpu.utils import random as urandom
from kmerset_tpu.utils.flags import check_k
from kmerset_tpu.utils.range import Range


def test_kmer_set_find_and_dunder():
    """find() with and without predicate (reference: kmer_set.h:114-161)."""
    rng = np.random.default_rng(0)
    s = urandom.get_random_kmer_set(9, 500, True, rng)
    allk = s.find()
    assert np.array_equal(allk, s.kmers)
    allk[0] = -1  # find returns a copy, not a view
    assert s.kmers[0] != -1
    evens = s.find(lambda a: a % 2 == 0)
    assert (evens % 2 == 0).all()
    assert set(evens) <= set(s.kmers.tolist())
    assert len(s) == s.size() == s.kmers.shape[0]
    assert "KmerSet" in repr(s)


def test_kmer_set_from_kmers_unsorted_duplicates():
    s = KmerSet.from_kmers(7, np.array([5, 3, 5, 1], dtype=np.int64))
    assert np.array_equal(s.kmers, [1, 3, 5])


def test_first_last_code():
    kmer = kc.string_to_kmer("ACGTT")
    assert kc.last_code(np.array([kmer]))[0] == kc.string_to_codes("T")[0]
    assert kc.first_code(np.array([kmer]), 5)[0] == kc.string_to_codes("A")[0]


def test_io_helpers_roundtrip(tmp_path):
    """get_kmer_set_from_file + RAII temporaries (reference: lib/io.h)."""
    from kmerset_tpu.core.kmer_set_compact import KmerSetCompact

    rng = np.random.default_rng(1)
    s = urandom.get_random_kmer_set(9, 300, True, rng)
    path = str(tmp_path / "x.txt")
    KmerSetCompact.from_kmer_set(s, True).dump(path)
    back = uio.get_kmer_set_from_file(9, path, "", True)
    assert back.equals(s)

    with uio.TemporaryFile() as tf:
        name = tf.name()
        with open(name, "w") as f:
            f.write("hello")
        assert os.path.exists(name)
    assert not os.path.exists(name)

    with uio.TemporaryDirectory() as td:
        dname = td.name()
        assert os.path.isdir(dname)
        open(os.path.join(dname, "f"), "w").close()
    assert not os.path.exists(dname)


@pytest.mark.parametrize("k", [9, 15, 23])
def test_native_count_hash_matches_numpy(k):
    """The reference-style hash-counting baseline must agree with the
    sorted-unique canonical count."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
    got = native.count_hash(codes, k)
    if got is None:
        pytest.skip("native library unavailable")
    want = np.unique(kc.canonical(kc.kmers_from_codes(codes, k), k)).shape[0]
    assert got == want


def test_native_count_hash_k_above_23_is_none():
    assert native.count_hash(np.zeros(100, np.uint8), 25) is None


def test_device_sketch_table_updates():
    """DeviceSketchTable.set_row/append_row (incl. capacity growth) must
    track the host oracle's pair weights exactly."""
    pytest.importorskip("jax")
    from kmerset_tpu.ops.sketch import DeviceSketchTable

    rng = np.random.default_rng(3)

    def sk(n):
        return np.unique(rng.integers(0, 1 << 18, size=n, dtype=np.int64))

    sketches = [sk(40) for _ in range(3)]
    table = DeviceSketchTable(sketches)
    # grow well past the initial rows capacity
    for _ in range(9):
        sketches.append(sk(30))
        table.append_row(sketches[-1])
    sketches[1] = sk(25)
    table.set_row(1, sketches[1])
    pairs = [(i, j) for i in range(len(sketches)) for j in range(i + 1, len(sketches))]
    got = table.pair_weights(pairs)
    want = [
        np.intersect1d(sketches[i], sketches[j], assume_unique=True).shape[0]
        for i, j in pairs
    ]
    assert got.tolist() == want


def test_slow_link_env_override(monkeypatch):
    from kmerset_tpu.ops import backend

    monkeypatch.setattr(backend, "_link_slow", None)
    monkeypatch.setenv("KMERSET_TPU_LINK", "slow")
    assert backend._slow_link() is True
    monkeypatch.setattr(backend, "_link_slow", None)
    monkeypatch.setenv("KMERSET_TPU_LINK", "fast")
    assert backend._slow_link() is False


def test_slow_link_cache_file(monkeypatch):
    """The link verdict is kept in the process and probed once; with no
    device backend it is 'slow' (nothing to offload)."""
    import jax

    from kmerset_tpu.ops import backend

    monkeypatch.setattr(backend, "_link_slow", None)
    monkeypatch.delenv("KMERSET_TPU_LINK", raising=False)
    calls = []
    real_jit = jax.jit

    def counting_jit(*a, **kw):
        calls.append(1)
        return real_jit(*a, **kw)

    monkeypatch.setattr(jax, "jit", counting_jit)
    assert backend._slow_link() is False
    assert backend._slow_link() is False
    assert len(calls) == 1
    monkeypatch.setattr(backend, "_link_slow", None)
    monkeypatch.setattr(backend, "_backend_alive", lambda: False)
    assert backend._slow_link() is True


def test_random_fixture_generators():
    """Reference lib/random.h surface: counter and set-set fixtures."""
    rng = np.random.default_rng(4)
    assert 0 <= urandom.get_random_kmer(7, rng) < (1 << 14)
    ks = urandom.get_random_kmers(7, 50, rng)
    assert ks.shape == (50,) and np.unique(ks).shape == (50,)

    counter = urandom.get_random_kmer_counter(7, 400, True, rng)
    s, _cut = counter.to_kmer_set(1)
    assert 0 < s.size() <= 400

    kss = urandom.get_random_kmer_set_set(3, 200, 9, True, rng)
    assert kss.size() >= 3  # children may have been added


def test_misc_small_surface():
    assert get_config(15).kmer_bits == 30
    assert list(Range(2, 5)) == [2, 3, 4]
    codes = np.array([0, 1, 2, 3], dtype=np.uint8)  # ACGT
    assert np.array_equal(complement_codes(codes), [0, 1, 2, 3])  # rc(ACGT)=ACGT
    ps = PackedStrings.from_strings(["ACGT", "GG"])
    assert ps.n == 2 and len(ps) == 2
    from kmerset_tpu.ops.count import pad_to

    assert pad_to(np.array([1, 2], np.int32), 4, fill=9).tolist() == [1, 2, 9, 9]
    assert pad_to(np.array([1, 2, 3], np.int32), 2).tolist() == [1, 2]
    with pytest.raises(SystemExit):
        check_k(14)


def test_enable_debug_logs():
    import logging

    from kmerset_tpu.utils.log import enable_debug_logs, init_default_logger

    logger = init_default_logger()
    enable_debug_logs()
    assert logging.getLogger("kmerset").level == logging.DEBUG
    assert logger is not None
